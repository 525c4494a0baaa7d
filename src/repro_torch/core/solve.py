"""SDE-solve front-end (port of :mod:`repro.core.solve`).

One entry point, :func:`solve`, validated eagerly against a solver registry
and dispatched to a gradient backend — the reference's design.  The port
registers the reference's five solvers: euler-maruyama, midpoint, heun,
reversible Heun and srk (strong order 1.5 on ``(W, H)`` space-time
Lévy-area pairs, diagonal noise), with the gradient modes the reference
gives each (:func:`gradient_capabilities`): ``discretise`` (autograd
through the loop), ``reversible_adjoint`` (the exact O(1)-memory adjoint),
``continuous_adjoint`` (the eq. (6) backsolve) and ``checkpoint``
(recursive halving), on the fixed grid and, with ``adaptive=True``, under
the PI step-size controller (:func:`_adaptive_loop`, :func:`solve_adaptive`;
DESIGN.md §10).  The precision policy (``precision="bf16_compute"``) wraps
the fields before any backend sees them.  :func:`solve_batched` solves a
batch of trajectories, one Brownian path per key row (in space-time mode
for srk).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .brownian import stlevy_difference
from .gradients import GRADIENT_BACKENDS, get_backend, resolve_precision
from .solvers import (
    RevHeunState,
    _euler_maruyama_step,
    _heun_embedded_step,
    _heun_step,
    _midpoint_embedded_step,
    _midpoint_step,
    _srk_embedded_step,
    _srk_step,
    _tree_cast,
    carry_init,
    carry_z,
    is_reversible,
    reversible_heun_embedded_step,
    reversible_heun_step,
)

__all__ = [
    "AdaptiveStats",
    "SOLVERS",
    "SolverSpec",
    "available_solvers",
    "get_solver",
    "gradient_capabilities",
    "register_solver",
    "solve",
    "solve_adaptive",
    "solve_batched",
]

@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Registry entry describing one solver (fields as in the reference)."""

    name: str
    stepper: Callable
    nfe_per_step: int
    strong_order: float
    gradient_modes: Tuple[str, ...]
    supports_pallas: bool = False
    sde_type: str = "stratonovich"
    notes: str = ""
    noise_types: Tuple[str, ...] = ("diagonal", "general")
    embedded_stepper: Optional[Callable] = None
    #: the stepper consumes ``(ΔW, ΔH)`` space-time Lévy-area pairs; the
    #: path must be built with ``levy_area="space-time"`` (checked both ways)
    needs_levy_area: bool = False

    @property
    def reversible(self) -> bool:
        """Whether the solver has an algebraic inverse (reversible Heun)."""
        return is_reversible(self.stepper)


SOLVERS: dict = {}


def register_solver(spec: SolverSpec) -> SolverSpec:
    for m in spec.gradient_modes:
        if m not in GRADIENT_BACKENDS:
            raise ValueError(f"{spec.name}: gradient mode {m!r} has no registered "
                             f"backend ({tuple(GRADIENT_BACKENDS)})")
    SOLVERS[spec.name] = spec
    return spec


def get_solver(name: str) -> SolverSpec:
    if name in SOLVERS:
        return SOLVERS[name]
    raise ValueError(f"unknown solver {name!r}; registered: {sorted(SOLVERS)}")


def available_solvers() -> Tuple[str, ...]:
    return tuple(sorted(SOLVERS))


register_solver(SolverSpec(
    "euler_maruyama", _euler_maruyama_step,
    nfe_per_step=1, strong_order=0.5,
    gradient_modes=("discretise", "continuous_adjoint", "checkpoint"),
    sde_type="ito", notes="order-0.5 Itô baseline"))

register_solver(SolverSpec(
    "midpoint", _midpoint_step,
    nfe_per_step=2, strong_order=0.5,
    gradient_modes=("discretise", "continuous_adjoint", "checkpoint"),
    notes="paper's main baseline",
    embedded_stepper=_midpoint_embedded_step))

register_solver(SolverSpec(
    "heun", _heun_step,
    nfe_per_step=2, strong_order=0.5,
    gradient_modes=("discretise", "continuous_adjoint", "checkpoint"),
    notes="trapezoidal",
    embedded_stepper=_heun_embedded_step))

register_solver(SolverSpec(
    "reversible_heun", reversible_heun_step,
    nfe_per_step=1, strong_order=0.5,
    gradient_modes=("discretise", "reversible_adjoint", "checkpoint"),
    supports_pallas=True,
    notes="algebraically reversible; O(1)-memory exact adjoint (paper §3)",
    embedded_stepper=reversible_heun_embedded_step))

register_solver(SolverSpec(
    "srk", _srk_step,
    nfe_per_step=5, strong_order=1.5,
    gradient_modes=("discretise", "checkpoint"),
    sde_type="ito",
    notes="strong-order-1.5 SRK (Kloeden–Platen) on (W, H) space–time "
          "Lévy-area pairs; diagonal noise",
    embedded_stepper=_srk_embedded_step,
    needs_levy_area=True,
    noise_types=("diagonal",)))


def gradient_capabilities() -> dict:
    """``gradient_mode -> tuple of solver names``: the join of the two
    registries, in backend-inventory order."""
    return {mode: tuple(s.name for s in SOLVERS.values() if mode in s.gradient_modes)
            for mode in GRADIENT_BACKENDS}


def _validate(spec: SolverSpec, gradient_mode: str, noise: str,
              use_pallas_kernels: bool, save_trajectory: bool,
              adaptive: bool = False) -> None:
    backend = get_backend(gradient_mode)  # unknown mode: lists the registry
    if gradient_mode not in spec.gradient_modes:
        raise ValueError(
            f"solver {spec.name!r} does not support gradient_mode={gradient_mode!r} "
            f"(supported: {spec.gradient_modes}; solvers serving {gradient_mode!r}: "
            f"{gradient_capabilities()[gradient_mode]})")
    if noise not in ("diagonal", "general"):
        raise ValueError(f"unknown noise type {noise!r}")
    if noise not in spec.noise_types:
        raise ValueError(
            f"solver {spec.name!r} supports noise={spec.noise_types}, got {noise!r} (the "
            f"order-1.5 scheme needs full Lévy areas for general noise, which "
            f"space-time H does not provide)")
    if use_pallas_kernels:
        if not spec.supports_pallas:
            raise ValueError(
                f"solver {spec.name!r} has no fused kernel path (the reference's "
                f"Pallas path; only: "
                f"{[s.name for s in SOLVERS.values() if s.supports_pallas]})")
        if noise != "diagonal":
            raise ValueError(
                "use_pallas_kernels requires diagonal noise (the fused kernels "
                "are elementwise; general noise needs an einsum)")
    if adaptive:
        if spec.embedded_stepper is None:
            raise ValueError(
                f"solver {spec.name!r} has no embedded error estimate, so "
                f"adaptive=True has nothing to control the step size with")
        if save_trajectory:
            raise ValueError(
                "adaptive=True accepts steps on a solver-chosen non-uniform "
                "grid, which save_trajectory's fixed (num_steps+1)-point "
                "output grid cannot represent — call solve(..., "
                "save_trajectory=False) for the terminal value (or "
                "solve_adaptive for the accepted-grid stats)")
    if backend.validate is not None:
        backend.validate(spec, noise=noise, save_trajectory=save_trajectory,
                         use_pallas=use_pallas_kernels, adaptive=adaptive)


# =============================================================================
# Adaptive stepping: PI-controlled accept/reject loop (DESIGN.md §10)
# =============================================================================

#: PI step-size controller gains, as the reference's: with the error ratio
#: r (accept iff r <= 1) the next step is
#: dt' = dt · clip(SAFETY · r^-BETA1 · r_prev^BETA2, FMIN, FMAX), r_prev
#: the ratio of the last accepted step.
_PI_SAFETY = 0.9
_PI_BETA1 = 0.35
_PI_BETA2 = 0.2
_PI_FACTOR_MIN = 0.2
_PI_FACTOR_MAX = 5.0
_MIN_ERR_RATIO = 1e-10  # a zero error estimate must not produce dt = inf


class AdaptiveStats(NamedTuple):
    """Controller diagnostics of an adaptive solve, one entry per key row
    of the Brownian path (shape ``K = bm.batch_shape``; ``()`` for a
    single path).

    ``dts``/``ts`` are ``(*K, max_steps)`` buffers: entry ``i <
    num_accepted`` holds accepted step ``i``'s size and left endpoint, the
    tail is zero.  ``nfe`` counts drift+diffusion evaluation pairs,
    rejected attempts included.  ``converged`` is False where the step
    budget ran out before ``t1`` (that row's state sits at ``t_final``).
    ``iterations`` is the number of loop iterations the batch took, the
    most attempts of any row (a host int)."""

    num_accepted: torch.Tensor
    num_rejected: torch.Tensor
    nfe: torch.Tensor
    t_final: torch.Tensor
    converged: torch.Tensor
    dts: torch.Tensor
    ts: torch.Tensor
    iterations: int


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row ``K``-shaped tensor, broadcastable against ``like``
    (shape ``(*K, ...)``)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _scalar(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), float(x), dtype=dtype, device=device)


def _pow(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x ** y`` for ``x > 0`` as ``exp(y·log x)``, with ``log x`` from the
    exponent and ``log1p`` of the mantissa.  torch.pow's CPU kernel rounds
    its vectorised body and its scalar tail differently, so a row's PI
    factor would depend on how many rows sit beside it; exp, log1p and
    frexp give every position the same bits (and agree with pow within a
    few ulps — the factor is a heuristic)."""
    m, e = torch.frexp(x)
    return torch.exp(y * (torch.log1p(m - 1.0) + e.to(x.dtype) * math.log(2.0)))


def _row_mean(x: torch.Tensor, nrow: int) -> torch.Tensor:
    """Mean over every dimension after the first ``nrow``, summed in a fixed
    pairwise order (halves added elementwise), so a row's result never
    depends on how many rows sit beside it (a reduction kernel's order
    can)."""
    x = x.reshape(x.shape[:nrow] + (-1,))
    n = x.shape[-1]
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0] / n


def _adaptive_loop(spec, drift, diffusion, params, z0, bm, t0: float, t1: float,
                   rtol, atol, max_steps: int, dt0: float, noise: str,
                   use_pallas: bool = False, bridge_depth: Optional[int] = None):
    """Accept/reject loop under the PI controller -> ``(final state,
    AdaptiveStats)`` (the reference's ``_adaptive_loop``).

    One controller per key row of ``bm`` (``K = bm.batch_shape``): the
    state is ``(*K, ...)``, and ``t``, ``dt``, the previous ratio, the
    counts and ``done`` are ``K``-shaped tensors; each row's error ratio is
    the RMS over its own elements.  A single-key path (``K = ()``) is the
    library's one solve, its ratio over the whole state.  This is the
    reference's ``vmap`` of the loop written out: the batch keeps stepping
    until every row has stopped, and a row that is done or out of budget
    is frozen.  Everything stays on the tensors' device — times, the PI
    factor, the buffers; the one host read per iteration is whether any
    row still runs (with the fused kernels, the step size rides along in
    the same read: the kernels take it as a scalar).

    Brownian increments are ``value(t + dt) − W(t_left)`` with ``W(t_left)``
    carried from the last accepted step: one bridge descent per attempt,
    all of a batch's rows in one ``brownian_value`` launch, and the bits
    the exact adjoint's replay recomputes from the stored ``(ts, dts)``.
    A space-time path's values are ``(W, H)`` pairs, carried alike, and the
    interval's pair is :func:`stlevy_difference` of the two (one
    ``space_time_value`` launch an attempt), the op graph the checkpoint
    replay repeats.  A path without ``value`` is queried by ``evaluate``.

    Stepper-generic as the reference's: the carry is a :class:`RevHeunState`
    for reversible Heun (whose initial evaluation ``nfe`` counts) and the
    bare state for midpoint and heun.
    """
    dtype, dev = z0.dtype, z0.device
    rev = is_reversible(spec.embedded_stepper)
    K = bm.batch_shape
    fused = use_pallas and noise == "diagonal"
    if fused and K:
        raise ValueError(
            f"use_pallas_kernels with one controller per key row ({K} rows) is not "
            f"supported: the fused kernels take one step size per launch; pass "
            f"a single-key BrownianPath")
    dkw = {} if bridge_depth is None else {"depth": bridge_depth}
    has_value = hasattr(bm, "value")
    levy = getattr(bm, "levy_area", None) == "space-time"
    rtol, atol = _scalar(rtol, dtype, dev), _scalar(atol, dtype, dev)
    t1a = _scalar(t1, dtype, dev)
    t = torch.full(K, float(t0), dtype=dtype, device=dev)
    dt = torch.full(K, float(dt0), dtype=dtype, device=dev)
    prev_ratio = torch.ones(K, dtype=dtype, device=dev)
    n_acc = torch.zeros(K, dtype=torch.int32, device=dev)
    n_rej = torch.zeros(K, dtype=torch.int32, device=dev)
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    ts = torch.zeros(K + (max_steps,), dtype=dtype, device=dev)
    dts = torch.zeros(K + (max_steps,), dtype=dtype, device=dev)
    carry = carry_init(spec.embedded_stepper, drift, diffusion, params, z0, t0)
    w_left = _tree_cast(bm.value(t, **dkw), dtype) if has_value else None
    iterations = 0
    while True:
        running = ~done & (n_acc < max_steps) & (n_rej < max_steps)
        remaining = t1a - t
        is_last = dt >= remaining
        dt_eff = torch.minimum(dt, remaining)
        if fused:  # one read: the flag and the kernels' scalar step size
            go, dt_step = torch.stack([running.to(dtype), dt_eff]).tolist()
        else:
            go, dt_step = bool(running.any()), _rows(dt_eff, z0)
        if not go:
            break
        iterations += 1
        t_next = t + dt_eff
        if not has_value:
            w_right = w_left
            dw = _tree_cast(bm.evaluate(t, t_next, **dkw), dtype)
        else:
            w_right = _tree_cast(bm.value(t_next, **dkw), dtype)
            dw = (stlevy_difference(w_left, w_right, t, t_next, bm.t0) if levy
                  else w_right - w_left)
        # the baselines have no fused path; their midpoint time is K-shaped
        # like the rows' own
        step_kw = {"use_pallas": use_pallas} if rev else {"tm": t + 0.5 * dt_eff}
        cand, err = spec.embedded_stepper(carry, t, dt_step, dw, drift,
                                          diffusion, params, noise, t1=t_next, **step_kw)
        scale = atol + rtol * torch.maximum(carry_z(carry).abs(), carry_z(cand).abs())
        q = err / scale
        ratio = torch.sqrt(_row_mean(q * q, len(K)))
        ratio = torch.clamp(ratio, min=_MIN_ERR_RATIO)
        accept = (ratio <= 1.0) & running
        # a rejected step must shrink, an accepted one may grow up to FMAX
        factor = _PI_SAFETY * _pow(ratio, -_PI_BETA1) * _pow(prev_ratio, _PI_BETA2)
        factor = torch.clamp(factor, _PI_FACTOR_MIN, _PI_FACTOR_MAX)
        factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
        if rev:
            carry = RevHeunState(*(torch.where(_rows(accept, a), a, b)
                                   for a, b in zip(cand, carry)))
        else:
            carry = torch.where(_rows(accept, cand), cand, carry)
        slot = n_acc.clamp(max=max_steps - 1).long().unsqueeze(-1)
        for buf, val in ((dts, dt_eff), (ts, t)):
            buf.scatter_(-1, slot, torch.where(accept, val, buf.gather(-1, slot)[..., 0])
                         .unsqueeze(-1))
        t = torch.where(accept, torch.where(is_last, t1a, t_next), t)
        dt = torch.where(running, dt_eff * factor, dt)
        prev_ratio = torch.where(accept, ratio, prev_ratio)
        n_acc = n_acc + accept.to(torch.int32)
        n_rej = n_rej + (running & ~accept).to(torch.int32)
        if levy:
            keep = _rows(accept, w_left[0])
            w_left = tuple(torch.where(keep, a, b) for a, b in zip(w_right, w_left))
        elif has_value:
            w_left = torch.where(_rows(accept, w_left), w_right, w_left)
        done = done | (accept & is_last)
    nfe = (n_acc + n_rej) * spec.nfe_per_step + (1 if rev else 0)
    return carry, AdaptiveStats(n_acc, n_rej, nfe, t, done, dts, ts, iterations)


def _check_levy_area(spec: SolverSpec, bm) -> None:
    """(W, H)-pair solvers need a space-time path, and the others a plain
    one — eagerly, rather than a tuple meeting a stepper written for a bare
    ΔW deep inside the loop."""
    mode = getattr(bm, "levy_area", None)
    if spec.needs_levy_area and mode != "space-time":
        raise ValueError(
            f"solver {spec.name!r} consumes (W, H) space-time Lévy-area pairs — "
            f"construct the Brownian path with levy_area='space-time' (got "
            f"levy_area={mode!r} on {type(bm).__name__})")
    if not spec.needs_levy_area and mode == "space-time":
        raise ValueError(
            f"solver {spec.name!r} consumes plain ΔW increments but the Brownian "
            f"path was built with levy_area='space-time' — drop the flag (solvers "
            f"consuming (W, H) pairs: "
            f"{[s.name for s in SOLVERS.values() if s.needs_levy_area]})")


def _check_adaptive_bm(bm) -> None:
    if not hasattr(bm, "evaluate"):
        raise ValueError(
            f"adaptive=True queries Brownian increments over solver-chosen "
            f"intervals via bm.evaluate(s, t); {type(bm).__name__} has no "
            f"evaluate method — use BrownianPath, VirtualBrownianTree or "
            f"DenseBrownianPath")


def _check_bridge_depth(bm, bridge_depth) -> None:
    if bridge_depth is None:
        return
    if not (isinstance(bridge_depth, int) and bridge_depth >= 1):
        raise ValueError(
            f"bridge_depth must be a positive int (dyadic descent levels), "
            f"got {bridge_depth!r}")
    probe = bm.value if hasattr(bm, "value") else bm.evaluate
    if "depth" not in inspect.signature(probe).parameters:
        raise ValueError(
            f"bridge_depth requires a Brownian path whose point queries "
            f"take a depth argument (BrownianPath); {type(bm).__name__} "
            f"has a fixed resolution — drop bridge_depth")


def solve_adaptive(drift, diffusion, params, z0, bm, t0: float, t1: float, *,
                   solver: str = "reversible_heun", rtol=1e-3, atol=1e-6,
                   max_steps: int = 4096, dt0: Optional[float] = None,
                   noise: str = "diagonal", bridge_depth: Optional[int] = None,
                   precision: str = "highest"):
    """Adaptive solve -> ``(z_T, AdaptiveStats)``, forward only (no graph is
    recorded; for gradients call :func:`solve` with ``adaptive=True`` and
    ``gradient_mode="reversible_adjoint"`` or ``"checkpoint"``).

    With a batched-key path (``K = bm.batch_shape``) every row runs its own
    controller, as the reference's ``vmap`` of this function does, and the
    fields receive the rows' times as a ``K``-shaped tensor (a single path
    gives a 0-d one); ``rtol`` and ``atol`` are scalars (floats or
    tensors)."""
    spec = get_solver(solver)
    _validate(spec, "discretise", noise, False, False, adaptive=True)
    _check_levy_area(spec, bm)
    _check_adaptive_bm(bm)
    _check_bridge_depth(bm, bridge_depth)
    drift, diffusion = resolve_precision(precision).wrap_fields(drift, diffusion)
    if dt0 is None:
        dt0 = (t1 - t0) / 16
    with torch.no_grad():
        carry, stats = _adaptive_loop(spec, drift, diffusion, params, z0, bm, t0, t1,
                                      rtol, atol, max_steps, dt0, noise,
                                      bridge_depth=bridge_depth)
    return carry_z(carry), stats


def solve(drift, diffusion, params, z0, bm, t0: float, t1: float, num_steps: int, *,
          solver: str = "reversible_heun", gradient_mode: str = "discretise",
          noise: str = "diagonal", save_trajectory: bool = True,
          use_pallas_kernels: bool = False, adaptive: bool = False,
          rtol: Optional[float] = None, atol: Optional[float] = None,
          max_steps: Optional[int] = None, dt0: Optional[float] = None,
          bridge_depth: Optional[int] = None, precision: str = "highest"):
    """Solve ``dZ = μ dt + σ ∘ dW`` on ``[t0, t1]``.

    Same signature and defaults as :func:`repro.core.solve.solve`: every
    solver of the registry (srk on a ``levy_area="space-time"`` path), under
    the gradient modes
    :func:`gradient_capabilities` lists (``continuous_adjoint`` and
    ``checkpoint`` return the terminal value only), diagonal or general
    noise, ``use_pallas_kernels`` (reversible Heun, diagonal noise, the CUDA
    kernels on CUDA tensors; not under ``discretise`` or ``checkpoint``), and
    ``precision`` ``"highest"`` (the fields in the state dtype, the
    identity) or ``"bf16_compute"`` (the fields evaluated in bfloat16, the
    state, ΔW and every accumulator in the state dtype).  Returns the
    trajectory ``(num_steps+1, *z0.shape)`` or, with
    ``save_trajectory=False``, the terminal value.

    ``adaptive=True`` runs the PI-controlled embedded pair instead of the
    uniform grid (terminal value only): ``num_steps`` seeds ``dt0 = (t1 −
    t0)/num_steps`` and the default budget ``max_steps = max(4·num_steps,
    256)``; ``rtol``/``atol`` default to 1e-3/1e-6 and ``bridge_depth`` caps
    the Brownian queries' bridge descent (default: the path's 24).  The
    exact adjoint replays the accepted grid, ``checkpoint`` freezes it and
    replays it under the halving schedule; ``discretise`` is forward-only
    there and ``continuous_adjoint`` refuses it.  A solve that runs out of
    budget before ``t1`` returns NaN; use :func:`solve_adaptive` to read
    ``converged`` instead.
    """
    spec = get_solver(solver)
    _validate(spec, gradient_mode, noise, use_pallas_kernels, save_trajectory, adaptive)
    _check_levy_area(spec, bm)
    if not adaptive and any(v is not None for v in (rtol, atol, max_steps, dt0,
                                                     bridge_depth)):
        raise ValueError(
            "rtol/atol/max_steps/dt0/bridge_depth are adaptive-mode options "
            "but adaptive=False — a fixed-grid solve would silently ignore "
            "the requested tolerance")
    backend = get_backend(gradient_mode)
    # the policy wraps the fields before the backend sees them, so replays
    # and backsolves evaluate the same fields as the forward
    drift, diffusion = resolve_precision(precision).wrap_fields(drift, diffusion)
    if adaptive:
        _check_adaptive_bm(bm)
        _check_bridge_depth(bm, bridge_depth)
        rtol = 1e-3 if rtol is None else rtol
        atol = 1e-6 if atol is None else atol
        if max_steps is None:
            max_steps = max(4 * num_steps, 256)
        if dt0 is None:
            dt0 = (t1 - t0) / num_steps
        z, converged = backend.solve_adaptive(
            spec, drift, diffusion, params, z0, bm, rtol, atol, t0, t1, max_steps,
            dt0, noise=noise, use_pallas=use_pallas_kernels, bridge_depth=bridge_depth)
        # a budget-exhausted solve sits at t_final < t1: poison it rather than
        # hand back a truncated-horizon state as z_T (a select, so converged
        # solves keep their gradient)
        return torch.where(_rows(converged, z), z, torch.full((), float("nan"),
                                                               dtype=z.dtype,
                                                               device=z.device))
    return backend.solve(
        spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, noise=noise,
        save_trajectory=save_trajectory, use_pallas=use_pallas_kernels)


def solve_batched(drift, diffusion, params, z0, keys, t0: float, t1: float,
                  num_steps: int, *, w_dim: Optional[int] = None, **kwargs):
    """Many trajectories in one solve: ``z0`` ``(B, *state_shape)`` and
    ``keys`` ``(B, 2)``, one Brownian path per key row -> ``(num_steps+1,
    B, *state_shape)`` trajectories, or ``(B, *state_shape)`` terminal
    values with ``save_trajectory=False``.

    The reference vmaps :func:`solve` over ``(z0, keys)`` and so returns the
    batch axis first; here the batch is a tensor dimension (the
    :class:`BrownianPath` batches by key row) and the trajectory keeps the
    port's time-major layout.  ``w_dim`` is the Brownian dimension for
    general noise.  ``kwargs`` go to :func:`solve` and are validated once,
    eagerly; with ``adaptive=True`` every row runs its own controller and
    the rows' fields see their own times (``K``-shaped tensors), forward
    only (:func:`solve_adaptive`)."""
    from .brownian import BrownianPath

    if z0.dim() < 1 or keys.shape[0] != z0.shape[0]:
        raise ValueError(f"leading (batch) dims must agree: z0 {tuple(z0.shape)} vs "
                         f"keys {tuple(keys.shape)}")
    spec = get_solver(kwargs.get("solver", "reversible_heun"))
    _validate(spec, kwargs.get("gradient_mode", "discretise"),
              kwargs.get("noise", "diagonal"), kwargs.get("use_pallas_kernels", False),
              kwargs.get("save_trajectory", True), kwargs.get("adaptive", False))
    resolve_precision(kwargs.get("precision", "highest"))
    state_shape = tuple(z0.shape[1:])
    if kwargs.get("noise", "diagonal") == "general":
        if w_dim is None:
            raise ValueError("general noise needs w_dim= for the Brownian shape")
        bm_shape = state_shape[:-1] + (w_dim,)
    else:
        bm_shape = state_shape
    bm = BrownianPath(keys.to(device=z0.device, dtype=torch.int64).contiguous(), t0, t1,
                      bm_shape, z0.dtype,
                      levy_area="space-time" if spec.needs_levy_area else None)
    return solve(drift, diffusion, params, z0, bm, t0, t1, num_steps, **kwargs)
