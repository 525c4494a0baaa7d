"""Discretise-then-optimise: autograd straight through the unrolled solver
loop (port of :mod:`repro.core.gradients.discretise`, fixed grid, the
reversible-Heun stepper).

The reference gradient path (paper §2.3): activation memory grows with the
number of steps, and the backward is whatever autograd derives.  It is the
oracle the exact adjoint is held against (≤1e-12 relative in float64,
tests/test_torch_adjoint.py).  The forward is the reversible adjoint's
unfused forward loop, run with autograd recording.
"""

from __future__ import annotations

from .base import GradientBackend, register_backend
from .reversible import _forward


def _validate(spec, *, noise, save_trajectory, use_pallas):
    if use_pallas:
        raise ValueError(
            "use_pallas_kernels is incompatible with gradient_mode='discretise': "
            "the fused kernels' derivative is the hand-derived backward kernel "
            "pair registered through the reversible-adjoint autograd Function, "
            "not something plain autograd could trace.  Use gradient_mode="
            "'reversible_adjoint' instead — its forward pass is the identical "
            "fused loop, and differentiating it runs the fused exact adjoint")
    if spec.name != "reversible_heun":
        from ..solve import NotPortedError

        raise NotPortedError(
            f"gradient_mode='discretise' is ported for the reversible-Heun "
            f"stepper only, not {spec.name!r} (ROADMAP.md Queue 1)")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    traj, final = _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
                           save_trajectory=save_trajectory)
    return traj if save_trajectory else final.z


register_backend(GradientBackend(
    name="discretise",
    summary="autograd through the unrolled loop, O(n) activation memory",
    solve=_solve,
    validate=_validate,
))
