"""Reversible Heun, one step (port of :mod:`repro.core.solvers`, the
``reversible_heun`` forward stepper).

Calling convention as in the reference::

    drift(params, t, z)      -> dz/dt   (shape of z)
    diffusion(params, t, z)  -> sigma   (diagonal: shape of z)

Times ``t`` are numpy scalars of the state dtype (or Python floats), so the
grid arithmetic rounds as the reference's traced float arithmetic does and
never needs a device round trip.

With ``use_pallas=True`` (the reference's name for the fused path) and
diagonal noise, the two state updates go through :mod:`repro_torch.
kernels.ops`: the CUDA kernels for CUDA tensors, the plain versions on the
CPU.  ``gen=(keys, n, dt_grid)`` draws ΔW inside the phase-1 kernel.  The
unfused path is plain tensor arithmetic whose bits the fused path matches
exactly: ``(½Δt)·m`` and ``(½m)·Δt`` agree under power-of-two scaling.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..kernels import ops

Drift = Callable
Diffusion = Callable

#: drift+diffusion evaluations per step, per solver (paper's NFE accounting).
NFE_PER_STEP = {
    "euler_maruyama": 1,
    "midpoint": 2,
    "heun": 2,
    "reversible_heun": 1,
    "srk": 5,
}


def apply_diffusion(sigma: torch.Tensor, dw: torch.Tensor, noise: str) -> torch.Tensor:
    """``sigma · dW`` for diagonal or general (matrix) noise."""
    if noise == "diagonal":
        return sigma * dw
    if noise == "general":
        return torch.einsum("...ij,...j->...i", sigma, dw)
    raise ValueError(f"unknown noise type: {noise}")


def dw_shape(z_shape, w_dim: Optional[int], noise: str):
    if noise == "diagonal":
        return tuple(z_shape)
    return tuple(z_shape[:-1]) + (w_dim,)


class RevHeunState(NamedTuple):
    """Carried state of the reversible Heun method (Algorithm 1)."""

    z: torch.Tensor
    zh: torch.Tensor  # ẑ — the auxiliary track
    mu: torch.Tensor
    sigma: torch.Tensor


def reversible_heun_step(state: RevHeunState, t, dt, dw, drift, diffusion, params,
                         noise, use_pallas: bool = False,
                         use_kernel: Optional[bool] = None, gen=None):
    """One step of Algorithm 1: exactly one drift+diffusion evaluation.

    ``gen=(keys, n, dt_grid)`` draws this step's ΔW inside the phase-1
    kernel (bitwise ``BrownianPath.increment(n)``) instead of consuming
    ``dw``, which is then ignored.  ``use_kernel`` follows the dispatch
    policy of :mod:`repro_torch.kernels.ops`.
    """
    z, zh, mu, sigma = state
    if use_pallas and noise == "diagonal":
        if gen is not None:
            keys, n, dt_grid = gen
            zh1, dw = ops.rev_heun_phase1_gen(z, zh, mu, sigma, keys, n, dt_grid, dt,
                                              use_kernel=use_kernel)
        else:
            zh1 = ops.rev_heun_phase1(z, zh, mu, sigma, dw, dt, use_kernel=use_kernel)
        mu1 = drift(params, t + dt, zh1)
        sigma1 = diffusion(params, t + dt, zh1)
        z1 = ops.rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt,
                                 use_kernel=use_kernel)
        return RevHeunState(z1, zh1, mu1, sigma1)
    zh1 = 2.0 * z - zh + mu * dt + apply_diffusion(sigma, dw, noise)
    mu1 = drift(params, t + dt, zh1)
    sigma1 = diffusion(params, t + dt, zh1)
    z1 = z + 0.5 * (mu + mu1) * dt + apply_diffusion(0.5 * (sigma + sigma1), dw, noise)
    return RevHeunState(z1, zh1, mu1, sigma1)
