"""Brownian motion sampling, in the solve's graph (port of
:mod:`repro.core.brownian`).

Three samplers, as in the reference:

* :class:`BrownianPath` is defined by its key: the increment of step ``n``
  of an ``num_steps`` grid is ``normal(fold_in(key, n), shape)·sqrt(dt)``,
  a pure function of ``(key, n)`` — no storage, bitwise the same on every
  query.  Off-grid queries (``value``, ``evaluate``; the adaptive loop's)
  descend a virtual dyadic tree by Lévy bridges, the paper's eq. (8), to
  ``depth`` levels.
* :class:`VirtualBrownianTree`, the Li et al. baseline: that descent at the
  fixed depth ``ceil(log2(span/tol))`` on every query.
* :class:`DenseBrownianPath` (with :func:`brownian_increments`): increments
  pregenerated on a fine grid and summed for coarser ones, the O(T)-memory
  baseline and the strong-convergence tool (coarse and fine solves see the
  same sample path).

``levy_area="space-time"`` turns every query into a ``(W, H)`` pair, ``H``
the space-time Lévy area of the interval (the srk solver's input):
``increment`` draws iid pairs per grid step (:func:`space_time_levy_area`),
and ``value`` runs the joint ``(W, ∫W)`` descent, whose interval pairs
:func:`stlevy_difference` recovers so that ``H`` adds up over adjacent
intervals (Chen's relation) and ``W`` keeps the bitwise
``evaluate(s, t) == value(t) − value(s)`` contract.

On CUDA keys the draws run in the hand kernels (``brownian_increment``,
``brownian_value``, ``space_time_increment``, ``space_time_value``); on
CPU keys in their plain versions.  :func:`brownian_increments`,
:meth:`DenseBrownianPath.sample` and :func:`davie_levy_area` are tensor
ops through the port's Threefry functions: each samples once, with a count
of device kernels that does not grow with the number of steps.

Batching.  The reference builds one path per key under ``jax.vmap``.  Here
``key`` is a ``(*K, 2)`` int64 tensor and every query of a
:class:`BrownianPath` or :class:`VirtualBrownianTree` returns ``(*K,
*shape)``: row ``k`` is what the reference's path for ``key[k]`` gives
(within the float tolerance of tests/test_torch_brownian.py and
tests/test_torch_levy_area.py; bits and counters are exact).  Point
queries take one time per row: ``value(t)`` with ``t`` of shape ``K``
gives row ``k`` the reference path's ``value(t[k])``.  A
:class:`DenseBrownianPath` is one path (``K = ()``), sampled from one
``(2,)`` key as the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops, prng
from ..kernels.ref import levy_pair, space_time_scales, true_divide
from .solvers import NP_DTYPES

#: Valid values of the paths' ``levy_area`` mode: ``None`` (bare ΔW) or
#: ``"space-time"`` (``(W, H)`` pairs).
LEVY_AREAS = (None, "space-time")

def _check_levy_mode(levy_area) -> None:
    if levy_area not in LEVY_AREAS:
        raise ValueError(f"unknown levy_area mode {levy_area!r}; supported: {LEVY_AREAS}")


def _keep(x, rows):
    """Rows ``[r0, r1)`` of a query's result (each of a ``(W, H)`` pair);
    the result itself for ``rows=None``."""
    if rows is None:
        return x
    if isinstance(x, tuple):
        return tuple(v[rows[0]:rows[1]] for v in x)
    return x[rows[0]:rows[1]]


def _as_rows(x, like: torch.Tensor) -> torch.Tensor:
    """A time (a float, or a tensor of the key batch shape) in ``like``'s
    dtype and device, shaped to broadcast against ``like`` (``(*K,
    *shape)``)."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def stlevy_difference(val_s, val_t, s, t, t0):
    """``(W, H)`` over ``[s, t]`` from two space-time path values (each
    ``(W, H)`` relative to ``t0``): ``W`` is ``val_t[0] − val_s[0]``
    literally (so ``evaluate(s, t)[0] == value(t)[0] − value(s)[0]``
    bitwise), ``H`` inverts Chen's relation through the running integral
    ``I(u) = (u − t0)·(H_u + W_u/2)``: ``A = I(t) − I(s) − (t − s)·W_s``,
    ``H = A/(t − s) − W/2``.  A zero-length query (the checkpoint replay's
    padding slots) gives exact zeros.  ``s``, ``t``: floats or tensors of
    the key batch shape (one time per row)."""
    w_s, h_s = val_s
    w_t, h_t = val_t
    s = _as_rows(s, w_t)
    t = _as_rows(t, w_t)
    t0 = torch.full((), float(t0), dtype=w_t.dtype, device=w_t.device)
    dw = w_t - w_s
    i_s = (s - t0) * (h_s + 0.5 * w_s)
    i_t = (t - t0) * (h_t + 0.5 * w_t)
    span = t - s
    area = i_t - i_s - span * w_s
    safe = torch.where(span == 0, torch.ones_like(span), span)
    dh = torch.where(span == 0, torch.zeros_like(dw), area / safe - 0.5 * dw)
    return dw, dh


def _h_from_wi(w, i, span):
    """``H = I/span − W/2``, the zero-length query guarded to 0."""
    safe = torch.where(span == 0, torch.ones_like(span), span)
    return torch.where(span == 0, torch.zeros_like(w), i / safe - 0.5 * w)


def brownian_increments(key: torch.Tensor, t0: float, t1: float, num_steps: int,
                        shape, dtype=torch.float32) -> torch.Tensor:
    """``(num_steps, *shape)`` iid increments ``W_{t_{n+1}} − W_{t_n}`` from
    one ``(2,)`` key: ``normal(split(key, num_steps)[n])·sqrt(dt)``."""
    dt = (t1 - t0) / num_steps
    keys = prng.split(key, num_steps)
    out = prng.normal_like(keys[..., 0], keys[..., 1], tuple(shape), dtype)
    return out * float(np.sqrt(NP_DTYPES[dtype](dt)))


def space_time_levy_area(key: torch.Tensor, dt, shape, dtype=torch.float32):
    """``(W, H)`` over an interval of length ``dt``: ``kw, kh = split(key)``,
    ``W ~ normal(kw)·sqrt(dt)``, ``H ~ normal(kh)·sqrt(dt/12)``, independent
    (Foster et al.; paper App. E).  ``key``: ``(*K, 2)``; each result
    ``(*K, *shape)``.  Tensor ops on the key's device; a grid path's
    draws (``fold_in(key, n)`` first) are the ``space_time_increment``
    kernel's (:meth:`BrownianPath.increment`)."""
    return levy_pair(key[..., 0], key[..., 1], shape, dtype, float(dt))


def davie_levy_area(key: torch.Tensor, w: torch.Tensor, h: torch.Tensor, dt) -> torch.Tensor:
    """The Davie/Foster approximation of the second iterated integral
    (App. E): ``W̃ = ½ W⊗W + H⊗W − W⊗H + λ``, ``λ`` antisymmetric with
    ``λ_ij ~ N(0, dt²/12)`` drawn from one ``(2,)`` key.  ``w, h``:
    ``(..., d)`` -> ``(..., d, d)``."""
    d = w.shape[-1]
    dtype = w.dtype
    lam_flat = prng.normal_like(key[..., 0], key[..., 1], tuple(w.shape[:-1]) + (d, d), dtype)
    low = torch.tril(lam_flat, -1)
    dt_d = NP_DTYPES[dtype](dt)
    lam = (low - low.transpose(-1, -2)) * float(np.sqrt(dt_d * dt_d / NP_DTYPES[dtype](12.0)))
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    return 0.5 * outer(w, w) + outer(h, w) - outer(w, h) + lam


@dataclasses.dataclass(frozen=True)
class BrownianPath:
    """Exact, stateless Brownian path on ``[t0, t1]``, one per key row.

    ``rows = (r0, r1)``: a data-parallel rank's row window of a one-key path
    (``key`` of shape ``(2,)``).  ``shape`` stays the whole batch's, so the
    draws are the whole path's, and every query returns rows ``[r0, r1)``
    of ``shape[0]``: the grid increments through the windowed draws (elements
    ``[r0·m, r1·m)`` of the one-key draw, ``m = prod(shape[1:])``), the
    point queries by drawing whole and keeping the rows (the reference's
    GSPMD program computes the whole draw on every device too)."""

    key: torch.Tensor
    t0: float
    t1: float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    levy_area: Optional[str] = None
    rows: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        _check_levy_mode(self.levy_area)
        if self.key.dtype != torch.int64 or self.key.shape[-1:] != (2,):
            raise ValueError(f"key must be an int64 (..., 2) tensor, got "
                             f"{self.key.dtype} {tuple(self.key.shape)}")
        if self.rows is not None:
            r0, r1 = self.rows
            if self.key.shape != (2,) or not 0 <= r0 < r1 <= self.shape[0]:
                raise ValueError(f"rows {self.rows} must be a window of shape[0] = "
                                 f"{self.shape[0]} of a one-key path")

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.key.shape[:-1])

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape a query returns per key: ``shape`` with the row window."""
        if self.rows is None:
            return tuple(self.shape)
        return (self.rows[1] - self.rows[0],) + tuple(self.shape[1:])

    @property
    def window(self):
        """``(e0, size)`` of the row window in the flat one-key draw, or None."""
        if self.rows is None:
            return None
        return self.rows[0] * math.prod(self.shape[1:]), math.prod(self.shape)

    def increment(self, n: int, num_steps: int, use_kernel: Optional[bool] = None):
        """Increment of step ``n`` on the ``num_steps`` uniform grid; in
        space-time mode the iid ``(W, H)`` pair of that cell,
        ``space_time_levy_area(fold_in(key, n), dt)``."""
        dt = (self.t1 - self.t0) / num_steps
        if self.levy_area == "space-time":
            return ops.space_time_increment(self.key, n, self.local_shape, self.dtype, dt,
                                            use_kernel=use_kernel, window=self.window)
        return ops.brownian_increment(self.key, n, self.local_shape, self.dtype, dt,
                                      use_kernel=use_kernel, window=self.window)

    def increments(self, num_steps: int):
        """All grid increments stacked: ``(num_steps, *K, *shape)`` (a pair of
        them in space-time mode)."""
        incs = [self.increment(n, num_steps) for n in range(num_steps)]
        if self.levy_area == "space-time":
            return tuple(torch.stack(x) for x in zip(*incs))
        return torch.stack(incs)

    def _times(self, t) -> torch.Tensor:
        K = self.batch_shape
        dev = self.key.device
        if isinstance(t, torch.Tensor):
            return t.to(device=dev, dtype=self.dtype).expand(K)
        return torch.full(K, float(t), dtype=self.dtype, device=dev)

    def value(self, t, depth: int = 24):
        """``W(t) − W(t0)`` by one Lévy-bridge descent -> ``(*K, *shape)``; in
        space-time mode the pair ``(W(t) − W(t0), H_{t0,t})`` by the joint
        descent.

        ``t``: a Python float, or a tensor of shape ``K`` (or broadcastable
        to it) holding each row's own time; a tensor on the path's device
        reaches the kernel without a copy to the host.  Contract (relied on
        by the adaptive loop, which carries the left endpoint's value):
        ``evaluate(s, t) == value(t) - value(s)`` bitwise (its ``W`` in
        space-time mode)."""
        K = self.batch_shape
        tt = self._times(t)
        out = K + tuple(self.shape)
        if self.levy_area == "space-time":
            w, i = ops.space_time_value(self.key.reshape(-1, 2), tt.reshape(-1).contiguous(),
                                        self.t0, self.t1, self.shape, self.dtype, depth)
            w, i = w.reshape(out), i.reshape(out)
            span = _as_rows(tt, w) - torch.full((), float(self.t0), dtype=self.dtype,
                                                 device=w.device)
            return _keep((w, _h_from_wi(w, i, span)), self.rows)
        w = ops.brownian_value(self.key.reshape(-1, 2), tt.reshape(-1).contiguous(),
                               self.t0, self.t1, self.shape, self.dtype, depth)
        return _keep(w.reshape(out), self.rows)

    def evaluate(self, s, t, depth: int = 24):
        """``W(t) − W(s)``, as ``value(t) − value(s)``; in space-time mode the
        ``(W, H)`` pair of ``[s, t]`` by :func:`stlevy_difference`."""
        if self.levy_area == "space-time":
            return stlevy_difference(self.value(s, depth), self.value(t, depth), s, t,
                                     self.t0)
        return self.value(t, depth) - self.value(s, depth)


@dataclasses.dataclass(frozen=True)
class DenseBrownianPath:
    """Pregenerated fine-grid increments with pathwise-consistent
    coarsening: ``increment(n, N)`` sums the fine increments inside coarse
    step ``n``.  The O(T)-memory baseline, and the tool for strong
    convergence, where coarse and fine solves must see the same path.

    ``w``: ``(fine_steps, *shape)`` increments; in space-time mode ``hh``
    holds each fine cell's space-time Lévy area, same shape."""

    w: torch.Tensor
    t0: float = 0.0
    t1: float = 1.0
    hh: Optional[torch.Tensor] = None
    levy_area: Optional[str] = None

    def __post_init__(self):
        _check_levy_mode(self.levy_area)
        if (self.levy_area == "space-time") != (self.hh is not None):
            raise ValueError(
                "DenseBrownianPath: levy_area='space-time' requires the per-cell areas "
                "hh (use sample(..., levy_area='space-time')); hh without the mode is a "
                "bug")

    @classmethod
    def sample(cls, key: torch.Tensor, t0: float, t1: float, fine_steps: int, shape,
               dtype=torch.float32, levy_area: Optional[str] = None):
        """Draw the path from one ``(2,)`` key.  ``w`` is the scalar mode's
        draw of the same key (:func:`brownian_increments`), so the
        space-time path shares it bitwise; the areas come from
        ``normal(fold_in(key, 0xB0BA))·sqrt(dt/12)``."""
        _check_levy_mode(levy_area)
        w = brownian_increments(key, t0, t1, fine_steps, shape, dtype)
        hh = None
        if levy_area == "space-time":
            _, s_h = space_time_scales((t1 - t0) / fine_steps, dtype)
            k = prng.fold_in_key(key, 0xB0BA)
            hh = prng.normal_like(k[..., 0], k[..., 1], (fine_steps,) + tuple(shape),
                                  dtype) * s_h
        return cls(w, t0=t0, t1=t1, hh=hh, levy_area=levy_area)

    @property
    def fine_steps(self) -> int:
        return self.w.shape[0]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def _dt_fine(self) -> float:
        return (self.t1 - self.t0) / self.fine_steps

    def increment(self, n: int, num_steps: int):
        r = self.fine_steps // num_steps
        if r * num_steps != self.fine_steps:
            raise ValueError(f"{num_steps} must divide fine_steps={self.fine_steps}")
        if self.levy_area == "space-time":
            return self._increment_wh(n, r)
        if r == 1:
            return self.w[n]
        return self.w[n * r:(n + 1) * r].sum(0)

    def _increment_wh(self, n: int, r: int):
        """Coarse ``(W, H)`` by chen-combining the ``r`` fine cells of coarse
        step ``n``: ``A = Σ_i (A_i + dt_f·W_prefix,i)``."""
        if r == 1:
            return self.w[n], self.hh[n]
        dt_f = float(NP_DTYPES[self.w.dtype](self._dt_fine))
        ws = self.w[n * r:(n + 1) * r]
        hs = self.hh[n * r:(n + 1) * r]
        w = ws.sum(0)
        cells = dt_f * (hs + 0.5 * ws)
        prefix = torch.cumsum(ws, 0) - ws
        area = (cells + dt_f * prefix).sum(0)
        rdt = float(NP_DTYPES[self.w.dtype](r) * NP_DTYPES[self.w.dtype](dt_f))
        return w, true_divide(area, rdt) - 0.5 * w

    def _cell(self, t):
        """``(pos, i)``: the fractional position of ``t`` on the fine grid and
        its cell, clipped into range (``i`` a 1-element index tensor)."""
        dtype = self.w.dtype
        t = torch.as_tensor(t, dtype=dtype, device=self.w.device)
        pos = true_divide(t - self.t0, self.t1 - self.t0) * self.fine_steps
        pos = torch.clamp(pos, 0.0, float(self.fine_steps))
        i = torch.clamp(torch.floor(pos).to(torch.int32), 0, self.fine_steps - 1)
        return pos, i.reshape(1).long()

    def _at(self, arr, i, shift: int = 0):
        return arr.index_select(0, torch.clamp(i - shift, min=0))[0]

    def _w_at(self, t) -> torch.Tensor:
        """W(t) from the fine increments: exact at the nodes (prefix sums),
        linear inside a cell (the bridge mean, so ``evaluate`` stays
        additive)."""
        pos, i = self._cell(t)
        frac = pos - i[0].to(pos.dtype)
        cum = torch.cumsum(self.w, 0)  # cum[k] = W(node k+1) − W(t0)
        w_lo = torch.where(i[0] > 0, self._at(cum, i, 1), torch.zeros_like(self.w[0]))
        return w_lo + frac * self._at(self.w, i)

    def _wi_at(self, t):
        """Space-time point query ``(W(t) − W(t0), I(t))``: exact at the
        nodes (prefix sums of the cells' increments and raw areas), inside
        a cell the conditional mean given the cell's ``(w, H)``."""
        dtype = self.w.dtype
        pos, i = self._cell(t)
        theta = pos - i[0].to(dtype)
        dt_f = float(NP_DTYPES[dtype](self._dt_fine))
        zero = torch.zeros_like(self.w[0])
        cum_w = torch.cumsum(self.w, 0)
        cells = dt_f * (self.hh + 0.5 * self.w)
        cum_i = torch.cumsum(cells + dt_f * (cum_w - self.w), 0)
        first = i[0] > 0
        w_lo = torch.where(first, self._at(cum_w, i, 1), zero)
        i_lo = torch.where(first, self._at(cum_i, i, 1), zero)
        w_c = self._at(self.w, i)
        a_c = self._at(cells, i)
        th2 = theta * theta
        th3 = theta * th2
        w_t = (w_lo + (3.0 * th2 - 2.0 * theta) * w_c) + true_divide(
            ((6.0 * theta) * (1.0 - theta)) * a_c, dt_f)
        i_t = (((i_lo + (theta * dt_f) * w_lo) + (dt_f * (th3 - th2)) * w_c)
               + (3.0 * th2 - 2.0 * th3) * a_c)
        return w_t, i_t

    def value(self, t):
        """``W(t) − W(t0)``; the ``(W, H_{t0,t})`` pair in space-time mode.
        ``t``: a float or a 0-d tensor."""
        if self.levy_area == "space-time":
            w, i = self._wi_at(t)
            span = torch.as_tensor(t, dtype=w.dtype, device=w.device) - torch.full(
                (), float(self.t0), dtype=w.dtype, device=w.device)
            return w, _h_from_wi(w, i, span)
        return self._w_at(t)

    def evaluate(self, s, t):
        """``W_t − W_s`` as ``value(t) − value(s)``: pathwise consistent with
        :meth:`increment` and exactly additive; the ``(W, H)`` pair in
        space-time mode."""
        if self.levy_area == "space-time":
            return stlevy_difference(self.value(s), self.value(t), s, t, self.t0)
        return self.value(t) - self.value(s)


@dataclasses.dataclass(frozen=True)
class VirtualBrownianTree:
    """The Li et al. baseline: the dyadic bridge descent from the root at
    the fixed depth ``ceil(log2(span/tol))`` on every query (17 at the
    default ``tol``) — the cost the Brownian Interval removes (paper
    Table 2).  One path per key row, as :class:`BrownianPath`."""

    key: torch.Tensor
    t0: float
    t1: float
    shape: Tuple[int, ...]
    tol: float = 1e-5
    dtype: torch.dtype = torch.float32
    levy_area: Optional[str] = None

    def __post_init__(self):
        _check_levy_mode(self.levy_area)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.key.shape[:-1])

    @property
    def _depth(self) -> int:
        span = self.t1 - self.t0
        return max(1, int(math.ceil(math.log2(max(span / self.tol, 2.0)))))

    def _path(self) -> BrownianPath:
        return BrownianPath(self.key, self.t0, self.t1, tuple(self.shape), self.dtype,
                            levy_area=self.levy_area)

    def value(self, t):
        return self._path().value(t, depth=self._depth)

    def evaluate(self, s, t):
        if self.levy_area == "space-time":
            return stlevy_difference(self.value(s), self.value(t), s, t, self.t0)
        return self.value(t) - self.value(s)

    def increment(self, n: int, num_steps: int):
        dt = (self.t1 - self.t0) / num_steps
        s = self.t0 + n * dt
        return self.evaluate(s, s + dt)
