"""Discretise-then-optimise: autograd straight through the unrolled solver
loop (port of :mod:`repro.core.gradients.discretise`).

The reference gradient path (paper §2.3): activation memory grows with the
number of steps, and the backward is whatever autograd derives.  Every
registered stepper serves it: the spec's stepper runs in
:func:`repro_torch.core.solvers.sde_solve`'s loop (reversible Heun keeps
its carried-state loop, the reversible adjoint's unfused forward).  It is
the oracle the exact adjoint and checkpointing are held against (≤1e-12
relative in float64, tests/test_torch_adjoint.py and
tests/test_torch_gradients.py).

Adaptive solves run forward only under this mode, as in the reference
(whose ``lax.while_loop`` has no reverse-mode rule): differentiating one
raises a named error.  :func:`solve_accepted_grid` is the adaptive exact
adjoint's oracle instead: autograd through the accepted steps with the
grid held fixed.
"""

from __future__ import annotations

import torch

from ..solvers import RevHeunState, carry_z, reversible_heun_step, sde_solve
from .base import GradientBackend, register_backend


class _ForwardOnly(torch.autograd.Function):
    """Identity on ``z`` whose backward refuses, by name."""

    @staticmethod
    def forward(ctx, z, *inputs):
        return z.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise ValueError(
            "gradient_mode='discretise' is forward-only for adaptive solves (the "
            "reference's lax.while_loop has no reverse-mode rule): use "
            "gradient_mode='reversible_adjoint', which replays the accepted grid "
            "exactly")


def _validate(spec, *, noise, save_trajectory, use_pallas, adaptive):
    if use_pallas:
        raise ValueError(
            "use_pallas_kernels is incompatible with gradient_mode='discretise': "
            "the fused kernels' derivative is the hand-derived backward kernel "
            "pair registered through the reversible-adjoint autograd Function, "
            "not something plain autograd could trace.  Use gradient_mode="
            "'reversible_adjoint' instead — its forward pass is the identical "
            "fused loop, and differentiating it runs the fused exact adjoint")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    return sde_solve(drift, diffusion, params, z0, bm, t0, t1, num_steps, solver=spec.name,
                     noise=noise, save_trajectory=save_trajectory,
                     step_fn=None if spec.stepper is reversible_heun_step else spec.stepper)


def _solve_adaptive(spec, drift, diffusion, params, z0, bm, rtol, atol, t0, t1,
                    max_steps, dt0, *, noise, use_pallas, bridge_depth):
    from ... import tree
    from ..solve import _adaptive_loop

    with torch.no_grad():
        carry, stats = _adaptive_loop(spec, drift, diffusion, params, z0, bm, t0, t1,
                                      rtol, atol, max_steps, dt0, noise,
                                      bridge_depth=bridge_depth)
    inputs = [x for x in (z0, *tree.leaves(params))
              if isinstance(x, torch.Tensor) and x.requires_grad]
    z = carry_z(carry)
    if inputs and torch.is_grad_enabled():
        z = _ForwardOnly.apply(z, *inputs)
    return z, stats.converged


def solve_accepted_grid(drift, diffusion, params, z0, bm, t0: float, ts, dts,
                        noise: str = "diagonal", bridge_depth=None):
    """Terminal value of the reversible-Heun steps ``(ts[i], dts[i])``, with
    autograd recording through every one: discretise-then-optimise over an
    adaptive solve's accepted grid held fixed (``AdaptiveStats.ts[:n]`` and
    ``.dts[:n]``, 1-D tensors; a single-key ``bm``).  ΔW, the field times
    and the steps are formed as the adaptive loop forms them, so on the
    loop's own grid the value is bitwise its ``z_T``; the oracle of the
    adaptive exact adjoint."""
    dkw = {} if bridge_depth is None else {"depth": bridge_depth}
    state = RevHeunState(z0, z0, drift(params, t0, z0), diffusion(params, t0, z0))
    for t_left, dt in zip(ts, dts):
        t_right = t_left + dt
        dw = bm.value(t_right, **dkw).to(z0.dtype) - bm.value(t_left, **dkw).to(z0.dtype)
        state = reversible_heun_step(state, t_left, dt, dw, drift, diffusion, params,
                                     noise, t1=t_right)
    return state.z


register_backend(GradientBackend(
    name="discretise",
    summary="autograd through the unrolled loop, O(n) activation memory",
    solve=_solve,
    solve_adaptive=_solve_adaptive,
    validate=_validate,
))
