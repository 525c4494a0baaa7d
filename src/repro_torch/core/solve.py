"""SDE-solve front-end, fixed grid (port of :mod:`repro.core.solve`).

One entry point, :func:`solve`, validated eagerly against a solver registry
and dispatched to a gradient backend — the reference's design.  The port
registers the reversible-Heun solver with two backends: ``discretise``
(autograd through the loop) and ``reversible_adjoint`` (the exact
O(1)-memory adjoint).  Everything else the reference accepts
raises :class:`NotPortedError` by name (solvers, gradient modes, adaptive
stepping, the bf16 policy), so nothing silently runs another solver's
numerics; ROADMAP.md lists the order they are ported in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from .gradients import GRADIENT_BACKENDS, get_backend, resolve_precision
from .solvers import reversible_heun_step

__all__ = [
    "NotPortedError",
    "SOLVERS",
    "SolverSpec",
    "available_solvers",
    "get_solver",
    "register_solver",
    "solve",
]

#: Solvers and gradient modes of the reference (repro.core.solve) that this
#: port does not register yet.
REFERENCE_SOLVERS = ("euler_maruyama", "midpoint", "heun", "reversible_heun", "srk")
REFERENCE_GRADIENT_MODES = ("discretise", "reversible_adjoint", "continuous_adjoint",
                            "checkpoint")


class NotPortedError(NotImplementedError):
    """The reference accepts this option; the port does not have it yet."""


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
    if name in REFERENCE_SOLVERS:
        raise NotPortedError(
            f"solver {name!r} is not ported yet (ported: {sorted(SOLVERS)}); "
            f"see ROADMAP.md Queue 1")
    raise ValueError(f"unknown solver {name!r}; registered: {sorted(SOLVERS)}")


def available_solvers() -> Tuple[str, ...]:
    return tuple(sorted(SOLVERS))


register_solver(SolverSpec(
    "reversible_heun", reversible_heun_step,
    nfe_per_step=1, strong_order=0.5,
    gradient_modes=("discretise", "reversible_adjoint"),
    supports_pallas=True,
    notes="algebraically reversible; O(1)-memory exact adjoint (paper §3)"))


def _validate(spec: SolverSpec, gradient_mode: str, noise: str,
              use_pallas_kernels: bool, save_trajectory: bool) -> None:
    if gradient_mode not in spec.gradient_modes:
        if gradient_mode in REFERENCE_GRADIENT_MODES:
            raise NotPortedError(
                f"gradient_mode={gradient_mode!r} is not ported yet for solver "
                f"{spec.name!r} (ported: {spec.gradient_modes}); see ROADMAP.md "
                f"Queue 1")
        get_backend(gradient_mode)  # unknown mode: lists the registry
    if noise not in ("diagonal", "general"):
        raise ValueError(f"unknown noise type {noise!r}")
    if noise not in spec.noise_types:
        raise ValueError(f"solver {spec.name!r} supports noise={spec.noise_types}, "
                         f"got {noise!r}")
    if use_pallas_kernels:
        if not spec.supports_pallas:
            raise ValueError(f"solver {spec.name!r} has no fused kernel path")
        if noise != "diagonal":
            raise ValueError(
                "use_pallas_kernels requires diagonal noise (the fused kernels "
                "are elementwise; general noise needs an einsum)")
    backend = get_backend(gradient_mode)
    if backend.validate is not None:
        backend.validate(spec, noise=noise, save_trajectory=save_trajectory,
                         use_pallas=use_pallas_kernels)


def solve(drift, diffusion, params, z0, bm, t0: float, t1: float, num_steps: int, *,
          solver: str = "reversible_heun", gradient_mode: str = "discretise",
          noise: str = "diagonal", save_trajectory: bool = True,
          use_pallas_kernels: bool = False, adaptive: bool = False,
          rtol: Optional[float] = None, atol: Optional[float] = None,
          max_steps: Optional[int] = None, dt0: Optional[float] = None,
          bridge_depth: Optional[int] = None, precision: str = "highest"):
    """Solve ``dZ = μ dt + σ ∘ dW`` on a uniform grid of ``num_steps`` steps.

    Same signature and defaults as :func:`repro.core.solve.solve`.  Ported:
    ``solver="reversible_heun"``, ``gradient_mode`` ``"discretise"`` and
    ``"reversible_adjoint"``, diagonal noise (general noise unfused),
    ``use_pallas_kernels`` (the CUDA kernels on CUDA tensors; exact adjoint
    only), ``precision="highest"``.  Returns the trajectory
    ``(num_steps+1, *z0.shape)`` or, with ``save_trajectory=False``, the
    terminal value.
    """
    spec = get_solver(solver)
    _validate(spec, gradient_mode, noise, use_pallas_kernels, save_trajectory)
    resolve_precision(precision)
    if adaptive:
        raise NotPortedError(
            "adaptive=True (the PI-controlled driver and the brownian_value "
            "kernel) is not ported yet — ROADMAP.md Queue 1, item 8")
    if any(v is not None for v in (rtol, atol, max_steps, dt0, bridge_depth)):
        raise ValueError(
            "rtol/atol/max_steps/dt0/bridge_depth are adaptive-mode options "
            "but adaptive=False — a fixed-grid solve would silently ignore "
            "the requested tolerance")
    return get_backend(gradient_mode).solve(
        spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, noise=noise,
        save_trajectory=save_trajectory, use_pallas=use_pallas_kernels)
