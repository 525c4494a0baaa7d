"""Launchers of the in-kernel Brownian CUDA kernels (port of
:mod:`repro.kernels.brownian`).

* :func:`brownian_increment` replaces the Pallas kernel at
  src/repro/kernels/brownian.py:71: the step-``n`` increment
  ``normal(fold_in(key, n))·sqrt(dt)``.
* :func:`rev_heun_phase1_gen` replaces src/repro/kernels/brownian.py:132:
  reversible-Heun phase 1 with that increment drawn inside the kernel;
  returns ``(ẑ₁, ΔW)``.
* :func:`brownian_value` replaces src/repro/kernels/brownian.py:101: the
  point value ``W(t) − W(t0)`` by Lévy-bridge descent, one time per row —
  the adaptive loop's Brownian query.

The JAX kernels take one key and get a batch from ``jax.vmap``; these take
the batch explicitly.  ``keys`` has shape ``(*K, 2)`` (int64 words) and the
state ``(*K, *S)``: row ``k`` draws ``normal(fold_in(keys[k], n), S)``,
bitwise what ``BrownianPath.increment`` gives for that row's key.  The
kernels are in ``csrc/rev_heun.cu`` with the Threefry device functions of
``csrc/threefry.cuh``; the plain versions are in :mod:`repro_torch.kernels.
ref`.
"""

from __future__ import annotations

import math

import torch

from . import build
from .reversible_heun_step import DTYPE_CODES, check_operands, scalar

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"brownian_increment": 0, "rev_heun_phase1_gen": 0, "brownian_value": 0}


def _check_keys(name: str, keys: torch.Tensor, device) -> int:
    """Validate a ``(*K, 2)`` int64 key tensor; return ``prod(K)``."""
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"{name}: keys must be an int64 (..., 2) tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device != device or not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be contiguous on {device}, got "
                         f"{keys.device}")
    return math.prod(keys.shape[:-1])


def brownian_increment(keys, n: int, shape, dtype, dt):
    """``(*K, *shape)`` step-``n`` increments, one row per key — one launch."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"brownian_increment: float32 or float64, got {dtype}")
    if not keys.is_cuda:
        raise ValueError(f"brownian_increment: keys must be a CUDA tensor, got {keys.device}")
    rows = _check_keys("brownian_increment", keys, keys.device)
    shape = tuple(shape)
    out = torch.empty(keys.shape[:-1] + shape, dtype=dtype, device=keys.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with build.device_guard(keys.device):
        err = lib.rt_brownian_increment(
            DTYPE_CODES[dtype], keys.data_ptr(), int(n), scalar(dt), out.data_ptr(),
            rows, math.prod(shape), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check("brownian_increment", err)
    LAUNCHES["brownian_increment"] += 1
    return out


def rev_heun_phase1_gen(z, zh, mu, sigma, keys, n: int, dt_grid, dt,
                        sign: float = 1.0):
    """Phase 1 with ΔW drawn in-kernel: ``(ẑ₁, ΔW)`` from one launch.

    ``dt_grid`` is the Brownian grid spacing (the ``sqrt`` scaling) and
    ``dt`` the integration step; they coincide on the uniform fixed grid."""
    check_operands("rev_heun_phase1_gen", z, (zh, mu, sigma))
    rows = _check_keys("rev_heun_phase1_gen", keys, z.device)
    batch = keys.shape[:-1]
    if z.shape[:len(batch)] != batch:
        raise ValueError(f"rev_heun_phase1_gen: state {tuple(z.shape)} does not "
                         f"start with the key batch shape {tuple(batch)}")
    zh1 = torch.empty_like(z)
    dw = torch.empty_like(z)
    if z.numel() == 0:
        return zh1, dw
    lib = build.load()
    with build.device_guard(z.device):
        err = lib.rt_rev_heun_phase1_gen(
            DTYPE_CODES[z.dtype], z.data_ptr(), zh.data_ptr(), mu.data_ptr(),
            sigma.data_ptr(), keys.data_ptr(), int(n), scalar(dt_grid), scalar(dt),
            scalar(sign), zh1.data_ptr(), dw.data_ptr(), rows, z.numel() // rows,
            torch.cuda.current_stream(z.device).cuda_stream)
    build.check("rev_heun_phase1_gen", err)
    LAUNCHES["rev_heun_phase1_gen"] += 1
    return zh1, dw


def brownian_value(keys, t, t0: float, t1: float, shape, dtype, depth: int = 24):
    """``(R, *shape)`` values ``W(t[r]) − W(t0)`` of the rows' paths — one
    launch.  ``keys``: ``(R, 2)``; ``t``: the ``(R,)`` query times in
    ``dtype`` on the card, read there by the kernel (no host copy)."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"brownian_value: float32 or float64, got {dtype}")
    if not keys.is_cuda:
        raise ValueError(f"brownian_value: keys must be a CUDA tensor, got {keys.device}")
    rows = _check_keys("brownian_value", keys, keys.device)
    if (t.dtype != dtype or t.device != keys.device or t.shape != keys.shape[:-1]
            or not t.is_contiguous()):
        raise ValueError(f"brownian_value: t must be a contiguous {dtype} tensor of "
                         f"shape {tuple(keys.shape[:-1])} on {keys.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if depth < 0:
        raise ValueError(f"brownian_value: depth must be >= 0, got {depth}")
    shape = tuple(shape)
    out = torch.empty(keys.shape[:-1] + shape, dtype=dtype, device=keys.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with build.device_guard(keys.device):
        err = lib.rt_brownian_value(
            DTYPE_CODES[dtype], keys.data_ptr(), t.data_ptr(), float(t0), float(t1),
            int(depth), out.data_ptr(), rows, math.prod(shape),
            torch.cuda.current_stream(keys.device).cuda_stream)
    build.check("brownian_value", err)
    LAUNCHES["brownian_value"] += 1
    return out


def brownian_value_blocks(dtype, rows: int, d: int) -> int:
    """The number of blocks :func:`brownian_value`'s launch takes for
    ``rows`` rows of ``d`` elements (the launcher's grid choice, in
    ``csrc/rev_heun.cu``); needs the built library, not a card."""
    return int(build.load().rt_brownian_value_blocks(DTYPE_CODES[dtype], int(rows), int(d)))
