"""The SDE solvers (port of :mod:`repro.core.solvers`): reversible Heun
(``reversible_heun_step``, ``reversible_heun_reverse_step``,
``reversible_heun_embedded_step``), the paper's baselines euler-maruyama,
midpoint and heun with the embedded pairs of the latter two
(``_euler_maruyama_step``, ``_midpoint_step`` / ``_midpoint_embedded_step``,
``_heun_step`` / ``_heun_embedded_step``), the strong-order-1.5 srk scheme
on ``(W, H)`` space-time Lévy-area pairs (``_srk_step`` /
``_srk_embedded_step``), and the uniform-grid drivers ``sde_solve`` and
``ode_solve``; ``sde_solve`` also runs a grid per row (:class:`RowGrid`),
the streamed and continuously batched chunk step's.

Calling convention as in the reference::

    drift(params, t, z)      -> dz/dt   (shape of z)
    diffusion(params, t, z)  -> sigma   (diagonal: shape of z)

Times ``t`` are numpy scalars of the state dtype (or Python floats) and
never need a device round trip; the adaptive loop passes tensors of its
rows' own times and step sizes instead.  On a uniform grid every field time is
:func:`grid_time`: ``t0 + k·Δt`` rounded once, ``k`` a whole or a half
step.  That is what the compiled reference evaluates — XLA contracts
``t0 + n·Δt`` and the ``± Δt`` or ``± ½Δt`` after it into fused
multiply-adds — and the plain two-rounding arithmetic differs from it by an
ulp at some steps, enough to move the Latent SDE's context index
(tests/test_torch_adjoint.py and tests/test_torch_solvers.py record the
reference's times).  The baseline steppers take those times as ``tm``
(the midpoint) and ``t1`` (the right end); without them they form
``t + ½dt`` and ``t + dt`` themselves, as the adaptive loop needs.

With ``use_pallas=True`` (the reference's name for the fused path) and
diagonal noise, the two state updates go through :mod:`repro_torch.
kernels.ops`: the CUDA kernels for CUDA tensors, the plain versions on the
CPU.  ``gen=(keys, n, dt_grid, window)`` draws ΔW inside the phase-1 kernel.  The
unfused path is plain tensor arithmetic whose bits the fused path matches
exactly: ``(½Δt)·m`` and ``(½m)·Δt`` agree under power-of-two scaling.
:func:`reversible_heun_reverse_step` is the algebraic inverse (Algorithm
2): the same two kernels with ``sign=-1``.  The baseline steppers have no
fused path (the reference's have none either).
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


def time_dtype(dtype: torch.dtype):
    """The numpy dtype of a grid's time arithmetic for a state of ``dtype``:
    the state's own for float32 and float64, float32 for bfloat16, which
    numpy lacks (the reversible layer stack's integer times are exact
    there, and a numpy scalar ``dt`` keeps a bfloat16 state bfloat16)."""
    return np.float32 if dtype == torch.bfloat16 else NP_DTYPES[dtype]

#: drift+diffusion evaluations per step, per solver (paper's NFE accounting).
NFE_PER_STEP = {
    "euler_maruyama": 1,
    "midpoint": 2,
    "heun": 2,
    "reversible_heun": 1,
    "srk": 5,
}


def _tree_cast(x, dtype):
    """``x.to(dtype)`` for a bare ΔW or each member of a ``(W, H)`` pair: a
    path returns the pair in ``levy_area="space-time"`` mode, and every ΔW
    consumer casts through this so both shapes flow."""
    if isinstance(x, tuple):
        return tuple(a.to(dtype) for a in x)
    return x.to(dtype)


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


def grid_time(t0: float, k, dt):
    """``t0 + k·dt`` rounded once to ``dt``'s numpy dtype (exact arithmetic
    in between; with ``t0 = 0``, as every solve here, float32 needs no
    second rounding through the double).  ``k`` is an int or a
    :class:`~fractions.Fraction` (a half step)."""
    return type(dt)(float(Fraction(t0) + Fraction(k) * Fraction(float(dt))))


class ProductTime32(np.float32):
    """A float32 grid time the compiled reference forms as the bare product
    ``k·dt`` (see :func:`product_time`); ``k`` and ``dt`` ride along."""


class ProductTime64(np.float64):
    """A float64 grid time the compiled reference forms as ``k·dt``."""


_PRODUCT_TIMES = {np.float32: ProductTime32, np.float64: ProductTime64}


def product_time(t0: float, k: int, dt):
    """:func:`grid_time` ``t0 + k·dt``, tagged with ``k`` and ``dt`` where the
    reference forms it as a bare product (``t0 = 0``, whose add XLA drops).

    The value is the grid time's.  The tag matters to a field that scales
    the time: XLA folds ``(k·dt)·c`` into ``k·(dt·c)``, so the Latent SDE's
    context index ``int(t / t1 · T)`` at such a time is ``int(k·(dt·T))``,
    which can differ by one from the index of the rounded time
    (:func:`repro_torch.core.sde._step_index`).  Arithmetic on it gives an
    untagged scalar, as a sum is no product in the reference either."""
    t = grid_time(t0, k, dt)
    if t0 != 0:
        return t
    out = _PRODUCT_TIMES[type(dt)](t)
    out.k, out.dt = k, dt
    return out


def step_times(t0: float, n: int, dt):
    """``(t_n, t_{n+½}, t_{n+1})`` of uniform-grid step ``n``, each
    :func:`grid_time`; ``t_n`` is the reference's product ``n·dt``
    (:func:`product_time`), the other two its fused multiply-adds."""
    return (product_time(t0, n, dt), grid_time(t0, Fraction(2 * n + 1, 2), dt),
            grid_time(t0, n + 1, dt))


class RowGrid:
    """A uniform grid per row: row ``i`` runs from ``t0[i]`` to ``t1[i]`` in
    ``num_steps`` steps, the times device tensors of shape ``(B,)`` (the
    continuous-batching chunk step, whose rows sit at different horizon
    positions).

    The arithmetic is the compiled reference's with a traced ``t0``
    (``core/solvers.py:sde_solve`` under ``vmap``), measured on the CPU by
    recording the times its fields see (tests/test_torch_stream.py)::

        dt  = (t1 − t0) · round(1/N)         XLA multiplies by the reciprocal
        t_n = fma(n, dt, t0)                 one rounding
        right end t_n + dt, midpoint t_n + ½dt

    float32 is carried in float64, where every intermediate is exact, and
    rounded once.  float64's ``fma`` is a double-double sum (Veltkamp split
    of ``dt``, ``n`` a small integer, two exact TwoSums, one final rounding);
    it rounds as a true ``fma`` except in ties at the last bit.  Every op is
    elementwise, so a row's times depend on that row alone, and nothing is
    read back to the host (the chunk step is captured as a CUDA graph)."""

    def __init__(self, t0: torch.Tensor, t1: torch.Tensor, num_steps: int):
        if t0.ndim != 1 or t1.shape != t0.shape:
            raise ValueError(f"a per-row grid takes (B,) start and end times, got "
                             f"{tuple(t0.shape)} and {tuple(t1.shape)}")
        self.dtype = t0.dtype
        self.num_steps = num_steps
        np_dtype = NP_DTYPES[t0.dtype]
        recip = float(np_dtype(1) / np_dtype(num_steps))
        if t0.dtype == torch.float32:
            self._t0 = t0.double()
            span = (t1.double() - self._t0).float().double()
            self._dt = (span * recip).float().double()
        else:
            self._t0 = t0
            self._dt = (t1 - t0) * recip
            c = self._dt * 134217729.0  # 2^27 + 1: the split's high half
            self._dt_hi = c - (c - self._dt)
            self._dt_lo = self._dt - self._dt_hi
        self.dt = self._dt.to(t0.dtype)

    def left(self, n: int) -> torch.Tensor:
        """``fma(n, dt, t0)`` per row."""
        if n == 0:
            return self._t0.to(self.dtype)
        if self.dtype == torch.float32:
            return (self._t0 + self._dt * n).float()
        a, b = self._dt_hi * n, self._dt_lo * n  # both exact
        p, pe = _two_sum(a, b)
        s, se = _two_sum(self._t0, p)
        return s + (se + pe)

    def right(self, n: int) -> torch.Tensor:
        return self.left(n) + self.dt

    def mid(self, n: int) -> torch.Tensor:
        return self.left(n) + 0.5 * self.dt


def _two_sum(a, b):
    """Knuth's TwoSum: ``a + b = s + e`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _row_solve(stepper, drift, diffusion, params, z0, bm, grid: RowGrid, noise,
               save_trajectory):
    """:func:`sde_solve` on a :class:`RowGrid` (``z0``: ``(B, d)``): each
    step's ``dt`` is the ``(B, 1)`` column of the rows' own step sizes."""
    dt = grid.dt.reshape(grid.dt.shape + (1,) * (z0.ndim - 1))
    carry = carry_init(stepper, drift, diffusion, params, z0, grid.left(0))
    zs = [z0] if save_trajectory else None
    for n in range(grid.num_steps):
        dw = _tree_cast(bm.increment(n, grid.num_steps), z0.dtype)
        t = grid.left(n)
        if is_reversible(stepper):
            carry = stepper(carry, t, dt, dw, drift, diffusion, params, noise,
                            t1=grid.right(n))
        else:
            carry = stepper(carry, t, dt, dw, drift, diffusion, params, noise,
                            tm=grid.mid(n), t1=grid.right(n))
        if zs is not None:
            zs.append(carry_z(carry))
    return torch.stack(zs) if save_trajectory else carry_z(carry)


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

    ``gen=(keys, n, dt_grid, window)`` draws this step's ΔW inside the
    phase-1 kernel (bitwise ``BrownianPath.increment(n)``; ``window`` the
    path's row window or None) instead of consuming ``dw``, which is then
    ignored.  ``use_kernel`` follows the dispatch
    policy of :mod:`repro_torch.kernels.ops`.
    """
    z, zh, mu, sigma = state
    t1 = t + dt if t1 is None else t1
    if use_pallas and noise == "diagonal":
        if gen is not None:
            keys, n, dt_grid, window = gen
            zh1, dw = ops.rev_heun_phase1_gen(z, zh, mu, sigma, keys, n, dt_grid, dt,
                                              use_kernel=use_kernel, window=window)
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
                                 use_kernel: Optional[bool] = None, t0=None, gen=None):
    """Algebraic inverse of :func:`reversible_heun_step` (Algorithm 2).

    Reconstructs ``(z_n, ẑ_n, μ_n, σ_n)`` from the step-``n+1`` state in
    closed form with one drift+diffusion evaluation at ``t0`` (default
    ``t1 - dt``; the grid solves pass :func:`grid_time`).  The
    fused path runs the phase kernels with ``sign=-1``; it is bitwise the
    unfused arithmetic (``a − b`` is ``a + (−b)`` exactly).

    ``gen=(keys, n, dt_grid, window)`` (fused path only) draws the step's
    ΔW inside the reconstruction's phase-1 kernel (bitwise
    ``BrownianPath.increment(n)``), ignores ``dw`` and returns ``(state,
    ΔW)``, so the caller's local VJP consumes the same draw.
    """
    z1, zh1, mu1, sigma1 = state
    t = t1 - dt if t0 is None else t0
    if use_pallas and noise == "diagonal":
        if gen is not None:
            keys, n, dt_grid, window = gen
            zh, dw = ops.rev_heun_phase1_gen(z1, zh1, mu1, sigma1, keys, n, dt_grid, dt,
                                             sign=-1.0, use_kernel=use_kernel, window=window)
        else:
            zh = ops.rev_heun_phase1(z1, zh1, mu1, sigma1, dw, dt, sign=-1.0,
                                     use_kernel=use_kernel)
        mu = drift(params, t, zh)
        sigma = diffusion(params, t, zh)
        z = ops.rev_heun_phase2(z1, mu, mu1, sigma, sigma1, dw, dt, sign=-1.0,
                                use_kernel=use_kernel)
        state = RevHeunState(z, zh, mu, sigma)
        return state if gen is None else (state, dw)
    zh = 2.0 * z1 - zh1 - mu1 * dt - apply_diffusion(sigma1, dw, noise)
    mu = drift(params, t, zh)
    sigma = diffusion(params, t, zh)
    z = z1 - 0.5 * (mu + mu1) * dt - apply_diffusion(0.5 * (sigma + sigma1), dw, noise)
    return RevHeunState(z, zh, mu, sigma)


# -----------------------------------------------------------------------------
# The baselines: euler-maruyama, midpoint, heun (state-carried steppers)
# -----------------------------------------------------------------------------
#
# ``(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None) -> z``
# (the embedded pairs return ``(z, err)``).  The embedded estimate is the
# Euler predictor ``z + μ₀dt + σ₀dW`` against the step, from the
# evaluations the step already makes; euler-maruyama has no second
# solution and no embedded pair.  ``tm`` and ``t1`` are the field times of
# the midpoint and of the right end (default ``t + ½dt``, ``t + dt``).


def _heun_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    t1 = t + dt if t1 is None else t1
    mu0 = drift(params, t, z)
    s0 = diffusion(params, t, z)
    zp = z + mu0 * dt + apply_diffusion(s0, dw, noise)  # Euler (embedded)
    mu1 = drift(params, t1, zp)
    s1 = diffusion(params, t1, zp)
    z1 = z + 0.5 * (mu0 + mu1) * dt + apply_diffusion(0.5 * (s0 + s1), dw, noise)
    return z1, z1 - zp


def _midpoint_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None,
                            t1=None):
    tm = t + 0.5 * dt if tm is None else tm
    mu0 = drift(params, t, z)
    s0 = diffusion(params, t, z)
    euler = mu0 * dt + apply_diffusion(s0, dw, noise)
    half = z + 0.5 * euler
    z1 = z + drift(params, tm, half) * dt + apply_diffusion(
        diffusion(params, tm, half), dw, noise)
    return z1, z1 - (z + euler)


def _srk_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    """Strong-order-1.5 explicit SRK step (Kloeden–Platen, Itô, diagonal
    noise) on the ``(ΔW, ΔH)`` pair of a ``levy_area="space-time"`` path,
    the reference's op for op.  Every supporting value is evaluated at
    ``t1`` (default ``t + dt``)::

        Υ± = z + a·dt ± b·√dt          Φ± = Υ₊ ± b(Υ₊)·√dt
        z₁ = z + ¼(a(Υ₊) + 2a + a(Υ₋))dt + b·ΔW
               + (b(Υ₊) − b(Υ₋))/(2√dt) · I₍₁,₁₎
               + (a(Υ₊) − a(Υ₋))/(2√dt) · I₍₁,₀₎
               + (b(Υ₊) − 2b + b(Υ₋))/(2dt) · I₍₀,₁₎
               + (b(Φ₊) − b(Φ₋) − b(Υ₊) + b(Υ₋))/(2dt) · I₍₁,₁,₁₎

    with I₍₁,₁₎ = (ΔW² − dt)/2, I₍₁,₀₎ = dt(H + ΔW/2), I₍₀,₁₎ = ΔW·dt −
    I₍₁,₀₎, I₍₁,₁,₁₎ = (ΔW³ − 3dt·ΔW)/6: 3 drift and 5 diffusion
    evaluations.  The embedded estimate is the Euler–Maruyama step from the
    first stage.  ``dt == 0`` (the checkpoint replay's padding slots) takes
    ``dt_safe = 1`` in the divisors, so the step is the identity and no
    ``inf·0`` enters its gradient.  ``dt``: a numpy scalar of the state
    dtype (the grid) or a tensor broadcastable to ``z`` (the adaptive
    rows')."""
    if not isinstance(dw, (tuple, list)):
        raise TypeError(
            "solver 'srk' needs (dW, dH) pairs — construct the Brownian path "
            "with levy_area='space-time'")
    if noise != "diagonal":
        raise ValueError(
            "solver 'srk' supports diagonal noise only (general noise needs "
            "full Lévy areas, which space-time H does not provide)")
    w, h = dw
    t1 = t + dt if t1 is None else t1
    if isinstance(dt, torch.Tensor):
        dt_safe = torch.where(dt == 0, torch.ones_like(dt), dt)
        sq = torch.sqrt(dt_safe)
    else:
        dt_safe = dt if dt != 0 else type(dt)(1)
        sq = np.sqrt(dt_safe)
    half_sq, half_dt = 0.5 / sq, 0.5 / dt_safe

    a0 = drift(params, t, z)
    b0 = diffusion(params, t, z)
    up = z + a0 * dt + b0 * sq
    um = z + a0 * dt - b0 * sq
    ap = drift(params, t1, up)
    am = drift(params, t1, um)
    bp = diffusion(params, t1, up)
    bm_ = diffusion(params, t1, um)
    pp = up + bp * sq
    pm = up - bp * sq
    bpp = diffusion(params, t1, pp)
    bpm = diffusion(params, t1, pm)

    i10 = (h + 0.5 * w) * dt           # I_(1,0) = ∫ (W_s − W_t) ds
    i01 = w * dt - i10                 # I_(0,1) = ∫ s dW
    i11 = 0.5 * (w * w - dt)           # I_(1,1)
    i111 = (w * w * w - w * (3.0 * dt)) / 6.0

    z1 = (z
          + 0.25 * (ap + 2.0 * a0 + am) * dt
          + b0 * w
          + (bp - bm_) * half_sq * i11
          + (ap - am) * half_sq * i10
          + (bp - 2.0 * b0 + bm_) * half_dt * i01
          + (bpp - bpm - bp + bm_) * half_dt * i111)
    return z1, z1 - (z + a0 * dt + b0 * w)


def _srk_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    return _srk_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm, t1)[0]


def _euler_maruyama_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    return z + drift(params, t, z) * dt + apply_diffusion(diffusion(params, t, z), dw, noise)


def _midpoint_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    return _midpoint_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm, t1)[0]


def _heun_step(z, t, dt, dw, drift, diffusion, params, noise, tm=None, t1=None):
    return _heun_embedded_step(z, t, dt, dw, drift, diffusion, params, noise, tm, t1)[0]


#: The builtin state-carried steppers of :func:`sde_solve`.
BASELINE_STEPPERS = {
    "euler_maruyama": _euler_maruyama_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
}


def is_reversible(stepper) -> bool:
    """Whether ``stepper`` carries a :class:`RevHeunState` (the reversible
    pair) rather than the bare state."""
    return stepper in (reversible_heun_step, reversible_heun_embedded_step)


def carry_init(stepper, drift, diffusion, params, z0, t0):
    """The solver carry at ``t0``: a :class:`RevHeunState` for the
    reversible pair (one evaluation at ``t0``), the bare state otherwise."""
    if is_reversible(stepper):
        return RevHeunState(z0, z0, drift(params, t0, z0), diffusion(params, t0, z0))
    return z0


def carry_z(carry):
    return carry.z if isinstance(carry, RevHeunState) else carry


def grid_step(stepper, carry, t0: float, n: int, dt, dw, drift, diffusion, params, noise):
    """Step ``n`` of a uniform grid from ``t0``, its field times
    :func:`step_times`."""
    t, tm, t1 = step_times(t0, n, dt)
    if is_reversible(stepper):
        return stepper(carry, t, dt, dw, drift, diffusion, params, noise, t1=t1)
    return stepper(carry, t, dt, dw, drift, diffusion, params, noise, tm=tm, t1=t1)


def sde_solve(drift, diffusion, params, z0, bm, t0: float, t1: float, num_steps: int,
              solver: str = "reversible_heun", noise: str = "diagonal",
              save_trajectory: bool = True, use_pallas_kernels: bool = False,
              step_fn: Optional[Callable] = None):
    """Solve ``dZ = μ dt + σ ∘ dW`` from ``t0`` to ``t1`` in ``num_steps``
    uniform steps -> the trajectory ``(num_steps+1, *z0.shape)`` or, with
    ``save_trajectory=False``, the terminal value.  Autograd through it is
    discretise-then-optimise (O(N) memory).

    ``step_fn`` runs any state-carried stepper (the registry passes its
    own); otherwise ``solver`` names a builtin.  Reversible Heun keeps its
    carried-state loop (:func:`repro_torch.core.gradients.reversible.
    _forward`), fused with ``use_pallas_kernels``.

    ``t0`` and ``t1`` may be ``(B,)`` tensors instead: row ``i`` of a
    ``(B, d)`` state then runs on its own grid (:class:`RowGrid`), unfused,
    while the path ``bm`` is shared by every row's ``[0, t1 − t0]`` cells."""
    if isinstance(t0, torch.Tensor):
        if use_pallas_kernels:
            raise ValueError("a per-row time grid runs unfused: the fused kernels "
                             "take one step size for every row")
        step = reversible_heun_step if solver == "reversible_heun" and step_fn is None \
            else step_fn or BASELINE_STEPPERS.get(solver)
        if step is None:
            raise ValueError(f"solver {solver!r} has no builtin stepper; pass step_fn=")
        return _row_solve(step, drift, diffusion, params, z0, bm,
                          RowGrid(t0, t1, num_steps), noise, save_trajectory)
    if solver == "reversible_heun" and step_fn is None:
        from .gradients.reversible import _forward

        traj, final = _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
                               use_pallas=use_pallas_kernels,
                               save_trajectory=save_trajectory)
        return traj if save_trajectory else final.z
    step = step_fn or BASELINE_STEPPERS.get(solver)
    if step is None:
        raise ValueError(
            f"solver {solver!r} has no builtin stepper; pass step_fn= "
            f"(repro_torch.core.solve does this from the registry)")
    dt = NP_DTYPES[z0.dtype]((t1 - t0) / num_steps)
    z = z0
    zs = [z0] if save_trajectory else None
    for n in range(num_steps):
        dw = _tree_cast(bm.increment(n, num_steps), z0.dtype)
        z = grid_step(step, z, t0, n, dt, dw, drift, diffusion, params, noise)
        if zs is not None:
            zs.append(z)
    return torch.stack(zs) if save_trajectory else z


def ode_solve(f, params, z0, t0: float, t1: float, num_steps: int,
              solver: str = "reversible_heun"):
    """The deterministic limit (σ = 0), the stability tests' (paper App.
    D.5): a zero diffusion on a path keyed ``PRNGKey(0)``."""
    from ..kernels import prng
    from .brownian import BrownianPath

    zero_diff = lambda p, t, z: torch.zeros_like(z)
    bm = BrownianPath(prng.PRNGKey(0, device=z0.device), t0, t1, tuple(z0.shape), z0.dtype)
    return sde_solve(f, zero_diff, params, z0, bm, t0, t1, num_steps, solver=solver,
                     noise="diagonal")
