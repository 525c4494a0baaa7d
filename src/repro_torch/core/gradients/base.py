"""Gradient-backend registry and precision policy (port of
:mod:`repro.core.gradients.base`).

A :class:`GradientBackend` names one gradient path through a solve; the
front-end (:mod:`repro_torch.core.solve`) validates against the registry and
dispatches to ``backend.solve``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

__all__ = [
    "GRADIENT_BACKENDS",
    "PRECISION_POLICIES",
    "GradientBackend",
    "available_gradient_modes",
    "get_backend",
    "register_backend",
    "resolve_precision",
]


@dataclasses.dataclass(frozen=True)
class GradientBackend:
    """Registry entry describing one gradient path through a solve.

    ``solve``: ``(spec, drift, diffusion, params, z0, bm, t0, t1,
    num_steps, *, noise, save_trajectory, use_pallas)`` fixed-grid entry
    point; ``solve_adaptive``: ``(spec, drift, diffusion, params, z0, bm,
    rtol, atol, t0, t1, max_steps, dt0, *, noise, use_pallas,
    bridge_depth) -> (z_T, converged)``; ``validate``: backend-specific
    eager checks, or ``None``."""

    name: str
    summary: str
    solve: Callable
    solve_adaptive: Callable
    validate: Optional[Callable] = None


#: gradient_mode -> GradientBackend, in registration order.
GRADIENT_BACKENDS: dict = {}


def register_backend(backend: GradientBackend) -> GradientBackend:
    GRADIENT_BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> GradientBackend:
    try:
        return GRADIENT_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown gradient_mode {name!r}; registered backends: "
            f"{available_gradient_modes()}") from None


def available_gradient_modes() -> Tuple[str, ...]:
    return tuple(GRADIENT_BACKENDS)


PRECISION_POLICIES = ("highest", "bf16_compute")


def resolve_precision(precision) -> None:
    """Only ``"highest"`` (fields in the state dtype) is ported."""
    if precision == "highest":
        return None
    if precision == "bf16_compute":
        raise NotImplementedError(
            "precision='bf16_compute' (bf16 field evaluation, "
            "repro.core.gradients.base.resolve_precision) is not ported yet — "
            "ROADMAP.md Queue 1, "
            "'The remaining gradient backends, solvers and the precision policy'")
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISION_POLICIES}")
