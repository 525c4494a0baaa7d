"""Careful clipping: SDE-GAN Lipschitz control without a gradient penalty
(port of :mod:`repro.core.clipping`, paper §5).

The discriminator CDE's vector fields must have Lipschitz constant ≤ 1 —
the recurrent structure amplifies any λ > 1 to O(λ^T).  The paper's recipe:
each linear map's entries are clipped into ``[-1/fan_in, 1/fan_in]`` after
every optimiser update (column ℓ1 sums ≤ 1, so ``‖Ax‖∞ ≤ ‖x‖∞``), and the
activations are LipSwish.  Clipping is a projection of the parameters
after the update, not gradient clipping and not a loss penalty: it costs
one elementwise pass and no second backward.

Every function is functional, as the reference's: it returns a new tree
(``torch.clamp``) and edits nothing in place.  :func:`clip_pytree` clips
every ``{"layers": [...]}`` subtree of any tree (bare Linears, such as the
discriminator's readout ``m``, pass through); :func:`clip_lipschitz`
clips the named MLPs of a discriminator tree;
:func:`repro_torch.optim.lipschitz_projection` puts either at the end of
an optimiser chain.
"""

from __future__ import annotations

import torch


def clip_linear(params: dict) -> dict:
    """Clip one Linear's weight entries to ``[-1/fan_in, 1/fan_in]``; the
    bias passes through (adding a bias has Lipschitz constant one)."""
    w = params["w"]
    bound = 1.0 / w.shape[0]
    return {**params, "w": torch.clamp(w, -bound, bound)}


def clip_mlp(params: dict) -> dict:
    return {"layers": [clip_linear(p) for p in params["layers"]]}


def _is_mlp(node) -> bool:
    return isinstance(node, dict) and set(node) == {"layers"}


def clip_pytree(tree):
    """Project every MLP (``{"layers": [...]}`` subtree) of an arbitrary
    tree; everything else is returned unchanged."""
    if _is_mlp(tree):
        return clip_mlp(tree)
    if isinstance(tree, dict):
        return {k: clip_pytree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clip_pytree(v) for v in tree)
    return tree


def clip_lipschitz(tree, mlp_names=("f", "g", "xi")):
    """Clip the named discriminator MLPs of a tree: the fields ``f``/``g``
    and the initial network ``xi``; the readout ``m`` is applied once, not
    recurrently, and stays unconstrained."""
    out = dict(tree)
    for name in mlp_names:
        if name in out:
            out[name] = clip_mlp(out[name])
    return out


# -----------------------------------------------------------------------------
# diagnostics
# -----------------------------------------------------------------------------


def lipschitz_bound_mlp(params: dict) -> torch.Tensor:
    """Upper bound on the MLP's ∞-norm Lipschitz constant (∏ max col-ℓ1)."""
    bound = 1.0
    for p in params["layers"]:
        bound = bound * torch.max(torch.sum(torch.abs(p["w"]), 0))
    return bound


def per_layer_violation(params: dict) -> torch.Tensor:
    """Max over layers of ``fan_in · max|w|``: ≤ 1 iff every entry lies in
    its clipping box."""
    w0 = params["layers"][0]["w"]
    v = w0.new_zeros(())
    for p in params["layers"]:
        v = torch.maximum(v, p["w"].shape[0] * torch.max(torch.abs(p["w"])))
    return v


def max_lipschitz_bound(tree, mlp_names=("f", "g", "xi")) -> torch.Tensor:
    """Worst ∞-norm Lipschitz bound across the named MLPs of a tree."""
    b = torch.zeros(())
    for name in mlp_names:
        if name in tree:
            bound = lipschitz_bound_mlp(tree[name])
            b = torch.maximum(b.to(bound), bound)
    return b
