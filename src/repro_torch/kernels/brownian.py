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

Two kernels are the port's own (the reference draws these with
``jax.random`` ops and has no Pallas kernel for them): the srk solver's
space-time Lévy-area draws.

* :func:`space_time_increment`: the ``(W, H)`` pair of grid step ``n``,
  ``space_time_levy_area(fold_in(key, n), dt)``
  (src/repro/core/brownian.py:175-177, 548-562).
* :func:`space_time_value`: ``(W(t) − W(t0), I(t))`` by the joint
  ``(W, ∫W)`` bridge descent of ``BrownianPath._wh``
  (src/repro/core/brownian.py:238-314), one time per row.

The JAX kernels take one key and get a batch from ``jax.vmap``; these take
the batch explicitly.  ``keys`` has shape ``(*K, 2)`` (int64 words) and the
state ``(*K, *S)``: row ``k`` draws ``normal(fold_in(keys[k], n), S)``,
bitwise what ``BrownianPath.increment`` gives for that row's key.  The
kernels are in ``csrc/rev_heun.cu`` with the Threefry device functions of
``csrc/threefry.cuh``; the plain versions are in :mod:`repro_torch.kernels.
ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .prng import _NP_DTYPES
from .ref import space_time_scales
from .reversible_heun_step import DTYPE_CODES, _stream, check_operands, scalar

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"brownian_increment": 0, "rev_heun_phase1_gen": 0, "brownian_value": 0,
            "space_time_increment": 0, "space_time_value": 0}

#: Of those, the launches of a row window (a data-parallel rank's rows of a
#: one-key draw; counted in :data:`LAUNCHES` too).
WINDOW_LAUNCHES = {"brownian_increment": 0, "rev_heun_phase1_gen": 0,
                   "space_time_increment": 0}

#: The deepest descent :func:`space_time_value`'s kernel takes (its levels
#: sit in shared memory; float64 intervals stop halving after ~52 levels).
SPACE_TIME_MAX_DEPTH = 512


def _check_keys(name: str, keys: torch.Tensor, device) -> int:
    """Validate a ``(*K, 2)`` int64 key tensor; return ``prod(K)``."""
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"{name}: keys must be an int64 (..., 2) tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device != device or not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be contiguous on {device}, got "
                         f"{keys.device}")
    return math.prod(keys.shape[:-1])


def _window(name: str, keys: torch.Tensor, window, count: int):
    """``(e0, size)`` of a proper row window, or None where the launch is
    the unwindowed one (no window, or the whole draw, whose bits are the
    unwindowed launch's).  A window takes one ``(2,)`` key."""
    if window is None:
        return None
    e0, size = (int(v) for v in window)
    if keys.shape != (2,):
        raise ValueError(f"{name}: a row window takes one (2,) key, got "
                         f"{tuple(keys.shape)}")
    if e0 < 0 or e0 + count > size or size >= 2 ** 32:
        raise ValueError(f"{name}: window of {count} at {e0} is not inside a draw "
                         f"of {size}")
    return None if (e0, size) == (0, count) else (e0, size)


def _count(name: str, window) -> None:
    LAUNCHES[name] += 1
    if window is not None:
        WINDOW_LAUNCHES[name] += 1


def brownian_increment(keys, n: int, shape, dtype, dt, window=None):
    """``(*K, *shape)`` step-``n`` increments, one row per key — one launch.
    ``window = (e0, size)``: one key, ``shape`` the rank's block of
    elements ``[e0, e0 + prod(shape))`` of the ``size``-element draw."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"brownian_increment: float32 or float64, got {dtype}")
    if not keys.is_cuda:
        raise ValueError(f"brownian_increment: keys must be a CUDA tensor, got {keys.device}")
    rows = _check_keys("brownian_increment", keys, keys.device)
    shape = tuple(shape)
    out = keys.new_empty(keys.shape[:-1] + shape, dtype=dtype)
    if out.numel() == 0:
        return out
    window = _window("brownian_increment", keys, window, out.numel())
    lib = build.load()
    with build.device_guard(keys.device):
        if window is None:
            err = lib.rt_brownian_increment(
                DTYPE_CODES[dtype], keys.data_ptr(), int(n), scalar(dt), out.data_ptr(),
                rows, math.prod(shape), _stream(keys))
        else:
            err = lib.rt_brownian_increment_window(
                DTYPE_CODES[dtype], keys.data_ptr(), int(n), scalar(dt), out.data_ptr(),
                window[0], out.numel(), window[1], _stream(keys))
    build.check("brownian_increment", err)
    _count("brownian_increment", window)
    return out


def rev_heun_phase1_gen(z, zh, mu, sigma, keys, n: int, dt_grid, dt,
                        sign: float = 1.0, window=None):
    """Phase 1 with ΔW drawn in-kernel: ``(ẑ₁, ΔW)`` from one launch.

    ``dt_grid`` is the Brownian grid spacing (the ``sqrt`` scaling) and
    ``dt`` the integration step; they coincide on the uniform fixed grid.
    ``window = (e0, size)``: one key, the state the rank's block of
    elements ``[e0, e0 + z.numel())`` of the ``size``-element draw."""
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
    window = _window("rev_heun_phase1_gen", keys, window, z.numel())
    lib = build.load()
    with build.device_guard(z.device):
        if window is None:
            err = lib.rt_rev_heun_phase1_gen(
                DTYPE_CODES[z.dtype], z.data_ptr(), zh.data_ptr(), mu.data_ptr(),
                sigma.data_ptr(), keys.data_ptr(), int(n), scalar(dt_grid), scalar(dt),
                scalar(sign), zh1.data_ptr(), dw.data_ptr(), rows, z.numel() // rows,
                _stream(z))
        else:
            err = lib.rt_rev_heun_phase1_gen_window(
                DTYPE_CODES[z.dtype], z.data_ptr(), zh.data_ptr(), mu.data_ptr(),
                sigma.data_ptr(), keys.data_ptr(), int(n), scalar(dt_grid), scalar(dt),
                scalar(sign), zh1.data_ptr(), dw.data_ptr(), window[0], z.numel(),
                window[1], _stream(z))
    build.check("rev_heun_phase1_gen", err)
    _count("rev_heun_phase1_gen", window)
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
    _check_times("brownian_value", keys, t, dtype)
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
            _stream(keys))
    build.check("brownian_value", err)
    LAUNCHES["brownian_value"] += 1
    return out


def _check_times(name, keys, t, dtype):
    if (t.dtype != dtype or t.device != keys.device or t.shape != keys.shape[:-1]
            or not t.is_contiguous()):
        raise ValueError(f"{name}: t must be a contiguous {dtype} tensor of "
                         f"shape {tuple(keys.shape[:-1])} on {keys.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


#: ``space_time_scales`` cached by ``(dt, dtype)``: a grid asks for its one
#: spacing at every step, so the launcher rounds it through numpy once.
_increment_scales = functools.lru_cache(maxsize=256)(space_time_scales)


def space_time_increment(keys, n: int, shape, dtype, dt, window=None):
    """``(W, H)``, each ``(*K, *shape)``, of grid step ``n`` with spacing
    ``dt``, one row per key — one launch.  The scales ``sqrt(dt)`` and
    ``sqrt(dt/12)`` are rounded on the host as the plain version rounds
    them (:func:`repro_torch.kernels.ref.space_time_scales`, cached by
    ``(dt, dtype)``).  ``window`` as :func:`brownian_increment`'s."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"space_time_increment: float32 or float64, got {dtype}")
    if not keys.is_cuda:
        raise ValueError(f"space_time_increment: keys must be a CUDA tensor, got "
                         f"{keys.device}")
    rows = _check_keys("space_time_increment", keys, keys.device)
    shape = tuple(shape)
    w = keys.new_empty(keys.shape[:-1] + shape, dtype=dtype)
    h = torch.empty_like(w)
    if w.numel() == 0:
        return w, h
    s_w, s_h = _increment_scales(float(dt), dtype)
    window = _window("space_time_increment", keys, window, w.numel())
    lib = build.load()
    with build.device_guard(keys.device):
        if window is None:
            err = lib.rt_space_time_increment(
                DTYPE_CODES[dtype], keys.data_ptr(), int(n), s_w, s_h, w.data_ptr(),
                h.data_ptr(), rows, math.prod(shape),
                _stream(keys))
        else:
            err = lib.rt_space_time_increment_window(
                DTYPE_CODES[dtype], keys.data_ptr(), int(n), s_w, s_h, w.data_ptr(),
                h.data_ptr(), window[0], w.numel(), window[1], _stream(keys))
    build.check("space_time_increment", err)
    _count("space_time_increment", window)
    return w, h


def space_time_value(keys, t, t0: float, t1: float, shape, dtype, depth: int = 24):
    """``(W(t[r]) − W(t0), I(t[r]))``, each ``(R, *shape)``, of the rows'
    space-time paths — one launch.  ``keys``: ``(R, 2)``; ``t``: the
    ``(R,)`` query times in ``dtype`` on the card; ``0 <= depth <=``
    :data:`SPACE_TIME_MAX_DEPTH`."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"space_time_value: float32 or float64, got {dtype}")
    if not keys.is_cuda:
        raise ValueError(f"space_time_value: keys must be a CUDA tensor, got {keys.device}")
    rows = _check_keys("space_time_value", keys, keys.device)
    _check_times("space_time_value", keys, t, dtype)
    if not 0 <= depth <= SPACE_TIME_MAX_DEPTH:
        raise ValueError(f"space_time_value: depth must be in [0, {SPACE_TIME_MAX_DEPTH}], "
                         f"got {depth}")
    shape = tuple(shape)
    w = torch.empty(keys.shape[:-1] + shape, dtype=dtype, device=keys.device)
    i = torch.empty_like(w)
    if w.numel() == 0:
        return w, i
    span = float(_NP_DTYPES[dtype](t1 - t0))
    s_w, s_h = space_time_scales(t1 - t0, dtype)
    lib = build.load()
    with build.device_guard(keys.device):
        err = lib.rt_space_time_value(
            DTYPE_CODES[dtype], keys.data_ptr(), t.data_ptr(), float(t0), float(t1), span,
            s_w, s_h, int(depth), w.data_ptr(), i.data_ptr(), rows, math.prod(shape),
            _stream(keys))
    build.check("space_time_value", err)
    LAUNCHES["space_time_value"] += 1
    return w, i


def increment_unit(dtype, rows: int, d: int, u: int) -> tuple:
    """``(wide, row, unit)``: whether :func:`brownian_increment`'s launch at
    ``(rows, d)`` takes its 64-bit index path (``rows·d >= 2**31``), and
    draw unit ``u``'s row and unit in the row by that path's index helper
    (``unit_coords`` in ``csrc/rev_heun.cu``; a unit is a counter pair in
    float32, an element in float64); needs the built library, not a card."""
    out = (ctypes.c_int64 * 2)()
    wide = build.load().rt_brownian_increment_unit(DTYPE_CODES[dtype], int(rows), int(d),
                                                   int(u), out)
    return bool(wide), out[0], out[1]


def graph_programmatic_edges(graph) -> int:
    """The programmatic-dependency edges of a ``torch.cuda.CUDAGraph``
    captured with ``keep_graph=True`` (the edges a dependent launch such as
    :func:`brownian_increment`'s leaves under stream capture), or -1 where
    the CUDA runtime cannot tell."""
    return int(build.load().rt_graph_programmatic_edges(graph.raw_cuda_graph()))


def brownian_value_blocks(dtype, rows: int, d: int) -> int:
    """The number of blocks :func:`brownian_value`'s launch takes for
    ``rows`` rows of ``d`` elements (the launcher's grid choice, in
    ``csrc/rev_heun.cu``); needs the built library, not a card."""
    return int(build.load().rt_brownian_value_blocks(DTYPE_CODES[dtype], int(rows), int(d)))
