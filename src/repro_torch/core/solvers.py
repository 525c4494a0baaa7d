"""Reversible Heun, one step forward and one back, and its embedded error
estimate (port of :mod:`repro.core.solvers`: ``reversible_heun_step``,
``reversible_heun_reverse_step`` and ``reversible_heun_embedded_step``).

Calling convention as in the reference::

    drift(params, t, z)      -> dz/dt   (shape of z)
    diffusion(params, t, z)  -> sigma   (diagonal: shape of z)

Times ``t`` are numpy scalars of the state dtype (or Python floats) and
never need a device round trip; the adaptive loop passes tensors of its
rows' own times and step sizes instead.  On a uniform grid every field time is
:func:`grid_time`: ``t0 + k·Δt`` rounded once.  That is what the compiled
reference evaluates — XLA contracts ``t0 + n·Δt`` and the ``± Δt`` after it
into fused multiply-adds — and the plain two-rounding arithmetic differs
from it by an ulp at some steps, enough to move the Latent SDE's context
index (tests/test_torch_adjoint.py records the reference's times).

With ``use_pallas=True`` (the reference's name for the fused path) and
diagonal noise, the two state updates go through :mod:`repro_torch.
kernels.ops`: the CUDA kernels for CUDA tensors, the plain versions on the
CPU.  ``gen=(keys, n, dt_grid)`` draws ΔW inside the phase-1 kernel.  The
unfused path is plain tensor arithmetic whose bits the fused path matches
exactly: ``(½Δt)·m`` and ``(½m)·Δt`` agree under power-of-two scaling.
:func:`reversible_heun_reverse_step` is the algebraic inverse (Algorithm
2): the same two kernels with ``sign=-1``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops

Drift = Callable
Diffusion = Callable

#: numpy scalar type of each state dtype (the times' arithmetic).
NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

#: drift+diffusion evaluations per step, per solver (paper's NFE accounting).
NFE_PER_STEP = {
    "euler_maruyama": 1,
    "midpoint": 2,
    "heun": 2,
    "reversible_heun": 1,
    "srk": 5,
}


def apply_diffusion(sigma: torch.Tensor, dw: torch.Tensor, noise: str) -> torch.Tensor:
    """``sigma · dW`` for diagonal or general (matrix) noise.

    General noise sums ``σ[..., :, j]·ΔW[..., j]`` over ``j`` in index
    order, written out: an einsum becomes a batched GEMM whose kernel (and
    so its summation order) depends on the batch count, and serving needs
    every row's bits independent of the rows around it."""
    if noise == "diagonal":
        return sigma * dw
    if noise == "general":
        out = sigma[..., 0] * dw[..., 0:1]
        for j in range(1, dw.shape[-1]):
            out = out + sigma[..., j] * dw[..., j:j + 1]
        return out
    raise ValueError(f"unknown noise type: {noise}")


def dw_shape(z_shape, w_dim: Optional[int], noise: str):
    if noise == "diagonal":
        return tuple(z_shape)
    return tuple(z_shape[:-1]) + (w_dim,)


def grid_time(t0: float, k: int, dt):
    """``t0 + k·dt`` rounded once to ``dt``'s numpy dtype (exact arithmetic
    in between; with ``t0 = 0``, as every solve here, float32 needs no
    second rounding through the double)."""
    return type(dt)(float(Fraction(t0) + k * Fraction(float(dt))))


class RevHeunState(NamedTuple):
    """Carried state of the reversible Heun method (Algorithm 1)."""

    z: torch.Tensor
    zh: torch.Tensor  # ẑ — the auxiliary track
    mu: torch.Tensor
    sigma: torch.Tensor


def reversible_heun_step(state: RevHeunState, t, dt, dw, drift, diffusion, params,
                         noise, use_pallas: bool = False,
                         use_kernel: Optional[bool] = None, gen=None, t1=None):
    """One step of Algorithm 1: exactly one drift+diffusion evaluation, at
    ``t1`` (default ``t + dt``; the grid solves pass :func:`grid_time`).

    ``gen=(keys, n, dt_grid)`` draws this step's ΔW inside the phase-1
    kernel (bitwise ``BrownianPath.increment(n)``) instead of consuming
    ``dw``, which is then ignored.  ``use_kernel`` follows the dispatch
    policy of :mod:`repro_torch.kernels.ops`.
    """
    z, zh, mu, sigma = state
    t1 = t + dt if t1 is None else t1
    if use_pallas and noise == "diagonal":
        if gen is not None:
            keys, n, dt_grid = gen
            zh1, dw = ops.rev_heun_phase1_gen(z, zh, mu, sigma, keys, n, dt_grid, dt,
                                              use_kernel=use_kernel)
        else:
            zh1 = ops.rev_heun_phase1(z, zh, mu, sigma, dw, dt, use_kernel=use_kernel)
        mu1 = drift(params, t1, zh1)
        sigma1 = diffusion(params, t1, zh1)
        z1 = ops.rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt,
                                 use_kernel=use_kernel)
        return RevHeunState(z1, zh1, mu1, sigma1)
    zh1 = 2.0 * z - zh + mu * dt + apply_diffusion(sigma, dw, noise)
    mu1 = drift(params, t1, zh1)
    sigma1 = diffusion(params, t1, zh1)
    z1 = z + 0.5 * (mu + mu1) * dt + apply_diffusion(0.5 * (sigma + sigma1), dw, noise)
    return RevHeunState(z1, zh1, mu1, sigma1)


def reversible_heun_embedded_step(state: RevHeunState, t, dt, dw, drift, diffusion,
                                  params, noise, use_pallas: bool = False,
                                  use_kernel: Optional[bool] = None, t1=None):
    """One step and its free error estimate: ``(new_state, err)``.

    The error is the increment of the gap between the two tracks,
    ``(z₁ − ẑ₁) + (z₀ − ẑ₀)`` — the raw gap accumulates over steps, its
    increment is this step's local quantity (→ 0 as Δt → 0)."""
    new = reversible_heun_step(state, t, dt, dw, drift, diffusion, params, noise,
                               use_pallas=use_pallas, use_kernel=use_kernel, t1=t1)
    return new, (new.z - new.zh) + (state.z - state.zh)


def reversible_heun_reverse_step(state: RevHeunState, t1, dt, dw, drift, diffusion,
                                 params, noise, use_pallas: bool = False,
                                 use_kernel: Optional[bool] = None, t0=None):
    """Algebraic inverse of :func:`reversible_heun_step` (Algorithm 2).

    Reconstructs ``(z_n, ẑ_n, μ_n, σ_n)`` from the step-``n+1`` state in
    closed form with one drift+diffusion evaluation at ``t0`` (default
    ``t1 - dt``; the grid solves pass :func:`grid_time`).  The
    fused path runs the phase kernels with ``sign=-1``; it is bitwise the
    unfused arithmetic (``a − b`` is ``a + (−b)`` exactly).
    """
    z1, zh1, mu1, sigma1 = state
    t = t1 - dt if t0 is None else t0
    if use_pallas and noise == "diagonal":
        zh = ops.rev_heun_phase1(z1, zh1, mu1, sigma1, dw, dt, sign=-1.0,
                                 use_kernel=use_kernel)
        mu = drift(params, t, zh)
        sigma = diffusion(params, t, zh)
        z = ops.rev_heun_phase2(z1, mu, mu1, sigma, sigma1, dw, dt, sign=-1.0,
                                use_kernel=use_kernel)
        return RevHeunState(z, zh, mu, sigma)
    zh = 2.0 * z1 - zh1 - mu1 * dt - apply_diffusion(sigma1, dw, noise)
    mu = drift(params, t, zh)
    sigma = diffusion(params, t, zh)
    z = z1 - 0.5 * (mu + mu1) * dt - apply_diffusion(0.5 * (sigma + sigma1), dw, noise)
    return RevHeunState(z, zh, mu, sigma)
