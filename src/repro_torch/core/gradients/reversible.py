"""Reversible Heun solve, forward pass (port of
:mod:`repro.core.gradients.reversible`: ``_gen_spec``, ``_forward``,
``_solve``).

The reference wraps the forward in a ``jax.custom_vjp`` whose backward
reverses the solver algebraically.  That ``torch.autograd.Function`` is the
next slice; here the forward runs under ``torch.no_grad()`` and a solve
whose inputs require grad raises :class:`GradientNotPortedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..brownian import BrownianPath
from ..solvers import RevHeunState, reversible_heun_step
from .base import GradientBackend, GradientNotPortedError, register_backend

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _gen_spec(bm, z0, noise, use_pallas):
    """``(keys, dt_grid_fn)`` for in-kernel ΔW generation, or ``None``.

    Legal only where the in-kernel draw is bitwise ``bm.increment(n,
    num_steps)``: a counter-keyed :class:`BrownianPath` in the state dtype,
    shaped like the state (diagonal noise)."""
    if not (use_pallas and noise == "diagonal" and type(bm) is BrownianPath):
        return None
    if bm.dtype != z0.dtype:
        return None
    if bm.batch_shape + tuple(bm.shape) != tuple(z0.shape):
        return None
    return bm.key, lambda num_steps: (bm.t1 - bm.t0) / num_steps


def _check_no_grad(params, z0) -> None:
    leaves = [z0]
    stack = [params]
    while stack:
        p = stack.pop()
        if isinstance(p, dict):
            stack.extend(p.values())
        elif isinstance(p, (list, tuple)):
            stack.extend(p)
        elif isinstance(p, torch.Tensor):
            leaves.append(p)
    if any(t.requires_grad for t in leaves):
        raise GradientNotPortedError(
            "an input of this solve requires grad, but the port's reversible "
            "solve is forward-only: the exact adjoint (torch.autograd.Function "
            "over Algorithm 2) is the training slice — ROADMAP.md Queue 1")


def _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
             use_pallas=False):
    """Algorithm 1 over the uniform grid -> ``(trajectory, final state)``."""
    dtype = z0.dtype
    np_dtype = _NP_DTYPES[dtype]
    dt = np_dtype((t1 - t0) / num_steps)
    state = RevHeunState(z0, z0, drift(params, t0, z0), diffusion(params, t0, z0))
    gen = _gen_spec(bm, z0, noise, use_pallas)
    zs = [z0]
    for n in range(num_steps):
        t = np_dtype(t0) + np_dtype(n) * dt
        if gen is not None:
            keys, dt_grid_fn = gen
            state = reversible_heun_step(state, t, dt, None, drift, diffusion, params,
                                         noise, use_pallas=use_pallas,
                                         gen=(keys, n, dt_grid_fn(num_steps)))
        else:
            dw = bm.increment(n, num_steps).to(dtype)
            state = reversible_heun_step(state, t, dt, dw, drift, diffusion, params,
                                         noise, use_pallas=use_pallas)
        zs.append(state.z)
    return torch.stack(zs), state


def reversible_heun_solve(drift, diffusion, params, z0, bm, t0, t1, num_steps,
                          noise="diagonal", use_pallas=False):
    """Trajectory ``(num_steps+1, *z0.shape)``; index 0 is ``z0``."""
    _check_no_grad(params, z0)
    with torch.no_grad():
        traj, _ = _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps,
                           noise, use_pallas)
    return traj


def reversible_heun_solve_final(drift, diffusion, params, z0, bm, t0, t1,
                                num_steps, noise="diagonal", use_pallas=False):
    """Terminal value only."""
    _check_no_grad(params, z0)
    with torch.no_grad():
        _, final = _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps,
                            noise, use_pallas)
    return final.z


def _validate(spec, *, noise, save_trajectory, use_pallas):
    if spec.name != "reversible_heun":
        raise ValueError(
            f"solver {spec.name!r} declares reversible_adjoint but the exact "
            f"adjoint is implemented for the reversible-Heun stepper only")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    fn = reversible_heun_solve if save_trajectory else reversible_heun_solve_final
    return fn(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise, use_pallas)


register_backend(GradientBackend(
    name="reversible_adjoint",
    summary="paper's exact adjoint: algebraic reversal, O(1) memory "
            "(forward only in this port so far)",
    solve=_solve,
    validate=_validate,
))
