"""Lipschitz-constrained Neural-CDE discriminator (port of
:mod:`repro.nn.cde`, paper §5 / eq. (2)).

The SDE-GAN discriminator is the Neural CDE

    H_0 = ξ_φ(t_0, Y_0),   dH_t = f_φ(t, H_t) dt + g_φ(t, H_t) d(t, Y_t),
    F_φ(Y) = m_φ · H_T

driven by the generator's (time-augmented) sample path.  Its recurrent
structure amplifies any vector-field Lipschitz constant λ > 1 to O(λ^T), so
the stack lives inside the Lipschitz-1 set: LipSwish activations, and every
Linear drawn uniform in ``[-1/fan_in, 1/fan_in]`` — the box careful
clipping (:mod:`repro_torch.core.clipping`) projects onto after each
update, so training starts inside it.  The readout ``m`` is applied once
and stays unconstrained.  On the card ``xi``, ``f`` and ``g`` (depth-1
LipSwish MLPs with biases) each run as one ``fused_mlp`` launch
(:func:`repro_torch.nn.core.mlp`).  Solving the CDE against a control path
is composed one layer up (:mod:`repro_torch.core.sde`).
"""

from __future__ import annotations

import dataclasses

import torch

from .core import linear, linear_init, lipswish, mlp, tcat


@dataclasses.dataclass(frozen=True)
class CDEDiscriminatorSpec:
    """Shapes of the discriminator stack (decoupled from the generator's)."""

    data_dim: int = 1      # y — dimension of the observed/generated path
    hidden_dim: int = 16   # h — CDE state
    width: int = 32
    depth: int = 1
    dtype: torch.dtype = torch.float32


def _box_mlp_init(generator: torch.Generator, sizes, dtype, device=None) -> dict:
    """An MLP drawn inside the careful-clipping box: each layer's entries
    uniform in ``[-1/fan_in, 1/fan_in]``, biases zero."""
    return {"layers": [linear_init(generator, a, b, scale=1.0 / a, dtype=dtype, device=device)
                       for a, b in zip(sizes[:-1], sizes[1:])]}


def cde_discriminator_init(generator: torch.Generator, spec: CDEDiscriminatorSpec,
                           device=None) -> dict:
    """Fresh parameters in the reference's tree: ``xi`` (initial
    condition), ``f`` (drift field), ``g`` (control field, ``h × (1+y)``
    outputs), ``m`` (readout), drawn from ``generator`` in that order."""
    hid = [spec.width] * spec.depth
    h, y, d = spec.hidden_dim, spec.data_dim, spec.dtype
    return {
        "xi": _box_mlp_init(generator, [1 + y] + hid + [h], d, device),
        "f": _box_mlp_init(generator, [1 + h] + hid + [h], d, device),
        "g": _box_mlp_init(generator, [1 + h] + hid + [h * (1 + y)], d, device),
        "m": linear_init(generator, h, 1, dtype=d, device=device),
    }


def cde_initial(params: dict, t0, y0: torch.Tensor) -> torch.Tensor:
    """H_0 = ξ_φ(t_0, Y_0)."""
    return mlp(params["xi"], tcat(t0, y0), lipswish)


def cde_drift(spec: CDEDiscriminatorSpec):
    """f_φ: (t, h) -> dh/dt drift component."""

    def f(params, t, h):
        return mlp(params["f"], tcat(t, h), lipswish, torch.tanh)

    return f


def cde_control_field(spec: CDEDiscriminatorSpec):
    """g_φ: (t, h) -> ``(h, 1+y)`` matrix field against the time-augmented
    control (t, Y_t), so the field sees dt through the control too."""

    def g(params, t, h):
        out = mlp(params["g"], tcat(t, h), lipswish, torch.tanh)
        return out.reshape(h.shape[:-1] + (spec.hidden_dim, 1 + spec.data_dim))

    return g


def cde_readout(params: dict, h_final: torch.Tensor) -> torch.Tensor:
    """F_φ = m · H_T, one scalar score per batch element."""
    return linear(params["m"], h_final)[..., 0]
