"""The continuous adjoint (optimise-then-discretise) baseline, eq. (6) —
port of :mod:`repro.core.gradients.continuous`: ``continuous_adjoint_solve``
and its backend glue.

The backsolve of Li et al. (2020): the backward pass re-integrates the
state backwards in time beside the adjoint SDE.  The recomputed ``z``
differs from the forward's by the solver's truncation error, so the
gradients carry an O(√h) error — the failure the paper's exact adjoint
removes, kept as the measured baseline.

The reference wraps the solve in a ``jax.custom_vjp``; here it is a
``torch.autograd.Function``.  The forward runs the solver under
``torch.no_grad()`` and keeps the terminal value and the parameter leaves.
The backward integrates the augmented state ``(z, a, θ_adj)`` from ``t1``
down to ``t0`` with the forward's solver, ``-dt`` and the same ΔW negated,
re-drawn by ``bm.increment`` (the ``brownian_increment`` kernel on the
card).  Each augmented evaluation is one field forward and one
``torch.autograd.grad`` pull at ``create_graph=False`` — on the card one
``fused_mlp`` launch and one ``fused_mlp_bwd`` launch per depth-1 field —
and its graph is freed before the next, so memory does not grow with the
number of steps.  The field times are the reference's: grid times rounded
once (:func:`repro_torch.core.solvers.grid_time`), ``t_{n+1}`` (a product
``(n+1)·dt`` there, :func:`~repro_torch.core.solvers.product_time`),
``t_{n+½}`` and ``t_n``, and the adds keep the reference's order, so
``θ_adj`` sums in the same order (held to a stated float tolerance, not
bitwise: tests/test_torch_gradients.py).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Callable

import torch
from torch.autograd.function import once_differentiable

from ... import tree
from ..solvers import NP_DTYPES, apply_diffusion, grid_time, product_time, sde_solve
from .base import GradientBackend, register_backend
from .reversible import _backward_leaves, _flat_tensor_leaves, _vjp

#: The solvers the backward integrator has a time-reversed stepper for; a
#: registered solver outside this set is refused, never run as Euler.
_CONTINUOUS_ADJOINT_BACKWARDS = ("euler_maruyama", "midpoint", "heun")


@dataclasses.dataclass(frozen=True)
class _BacksolveSpec:
    """The non-tensor arguments of one solve (the reference's nondiff args)."""

    drift: Callable
    diffusion: Callable
    treespec: Any
    bm: Any
    t0: float
    t1: float
    num_steps: int
    solver: str
    noise: str


def _add(u, v, scale=None):
    """``u + scale·v`` over an augmented state ``(z, a, [θ])``; ``None``
    entries of ``v`` (a field that does not read a leaf) add nothing."""
    def one(x, y):
        if y is None:
            return x
        return x + (y if scale is None else scale * y)

    z, a, th = u
    dz, da, dth = v
    return (one(z, dz), one(a, da),
            None if th is None else [one(x, y) for x, y in zip(th, dth)])


def _backsolve(spec: _BacksolveSpec, zT, leaves, needs, g_zT):
    """The eq. (6) sweep -> ``(g_z0, [g_leaf or None])``."""
    N = spec.num_steps
    dtype = zT.dtype
    dt_f = (spec.t1 - spec.t0) / N        # the reference's Python-float step
    dt = NP_DTYPES[dtype](dt_f)           # ... and its rounding, for the times
    ndt = -dt_f
    p_leaves, wrt, params, g_params = _backward_leaves(spec.treespec, leaves, needs)

    def pull(out_fn, t, aug):
        """``(out, −aᵀ∂out/∂z, [−aᵀ∂out/∂θ])`` of one field at ``(t, z)``."""
        z, a, _ = aug
        with torch.enable_grad():
            x = z.detach().requires_grad_()
            out = out_fn(t, x)
            grads = _vjp((out,), [*wrt, x], (a,))
        d_z = grads[-1]
        return (out.detach(), None if d_z is None else -d_z,
                [None if g is None else -g for g in grads[:-1]])

    def aug_drift(t, aug):
        return pull(lambda t_, x: spec.drift(params, t_, x), t, aug)

    def aug_diff_dw(t, aug, dw):
        return pull(lambda t_, x: apply_diffusion(spec.diffusion(params, t_, x), dw,
                                                  spec.noise), t, aug)

    def stage(aug):
        """An intermediate stage: its θ channel is never read."""
        return aug[0], aug[1], None

    aug = (zT, g_zT.contiguous(), g_params)
    for n in range(N - 1, -1, -1):
        t_hi = product_time(spec.t0, n + 1, dt)
        ndw = -spec.bm.increment(n, N).to(dtype)
        if spec.solver == "midpoint":
            k1 = stage(_add(_add(stage(aug), aug_drift(t_hi, aug), 0.5 * ndt),
                            aug_diff_dw(t_hi, aug, 0.5 * ndw)))
            tm = grid_time(spec.t0, Fraction(2 * n + 1, 2), dt)
            aug = _add(_add(aug, aug_drift(tm, k1), ndt), aug_diff_dw(tm, k1, ndw))
        elif spec.solver == "heun":
            f0 = aug_drift(t_hi, aug)
            s0 = aug_diff_dw(t_hi, aug, ndw)
            pred = stage(_add(_add(stage(aug), f0, ndt), s0))
            t_lo = grid_time(spec.t0, n, dt)
            f1 = aug_drift(t_lo, pred)
            s1 = aug_diff_dw(t_lo, pred, ndw)
            aug = _add(_add(_add(_add(aug, f0, 0.5 * ndt), f1, 0.5 * ndt), s0, 0.5), s1, 0.5)
        else:  # euler-maruyama, backwards
            aug = _add(_add(aug, aug_drift(t_hi, aug), ndt), aug_diff_dw(t_hi, aug, ndw))
    # aug[0] is the reconstructed z0: it differs from the true z0 by the
    # truncation error
    it = iter(aug[2])
    return aug[1], [next(it) if leaf.requires_grad else None for leaf in p_leaves]


class _ContinuousAdjoint(torch.autograd.Function):
    """``apply(spec, z0, *param_leaves)`` -> the terminal value."""

    @staticmethod
    def forward(ctx, spec, z0, *leaves):
        params = tree.unflatten(spec.treespec, leaves)
        zT = sde_solve(spec.drift, spec.diffusion, params, z0, spec.bm, spec.t0, spec.t1,
                       spec.num_steps, solver=spec.solver, noise=spec.noise,
                       save_trajectory=False)
        ctx.spec = spec
        ctx.save_for_backward(zT, *leaves)
        return zT.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g_zT):
        zT, *leaves = ctx.saved_tensors
        g_z0, g_leaves = _backsolve(ctx.spec, zT, leaves, ctx.needs_input_grad[2:], g_zT)
        return (None, g_z0 if ctx.needs_input_grad[1] else None, *g_leaves)


def continuous_adjoint_solve(drift, diffusion, params, z0, bm, t0: float, t1: float,
                             num_steps: int, solver: str = "midpoint",
                             noise: str = "diagonal"):
    """Terminal value ``z_T`` whose backward solves the adjoint SDE (6)
    backwards with the same solver and the same Brownian sample."""
    if solver not in _CONTINUOUS_ADJOINT_BACKWARDS:
        raise ValueError(f"continuous_adjoint_solve has a backward integrator for "
                         f"{_CONTINUOUS_ADJOINT_BACKWARDS}, not {solver!r}")
    leaves, treespec = _flat_tensor_leaves(params)
    spec = _BacksolveSpec(drift, diffusion, treespec, bm, t0, t1, num_steps, solver, noise)
    return _ContinuousAdjoint.apply(spec, z0, *leaves)


# =============================================================================
# Backend registration
# =============================================================================


def _validate(spec, *, noise, save_trajectory, use_pallas, adaptive):
    if spec.name not in _CONTINUOUS_ADJOINT_BACKWARDS:
        raise ValueError(
            f"solver {spec.name!r} declares continuous_adjoint but the "
            f"continuous-adjoint backward integrator only implements "
            f"{_CONTINUOUS_ADJOINT_BACKWARDS} (repro_torch.core.gradients."
            f"continuous); extend continuous_adjoint_solve before "
            f"registering this combination")
    if save_trajectory:
        raise ValueError(
            "continuous_adjoint backpropagates a terminal-value cotangent "
            "only — call solve(..., save_trajectory=False)")
    if adaptive:
        raise ValueError(
            "adaptive=True is incompatible with gradient_mode="
            "'continuous_adjoint': the eq.-(6) backward integrator "
            "re-integrates on the forward's fixed uniform grid; use "
            "'reversible_adjoint' (exact adjoint replaying the accepted "
            "grid), 'checkpoint' (recursive rematerialisation of the "
            "accepted grid), or 'discretise' (forward simulation only)")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    return continuous_adjoint_solve(drift, diffusion, params, z0, bm, t0, t1, num_steps,
                                    solver=spec.name, noise=noise)


register_backend(GradientBackend(
    name="continuous_adjoint",
    summary="optimise-then-discretise backsolve (eq. 6), O(√h) gradient error",
    solve=_solve,
    validate=_validate,
))
