"""Gradient-backend registry and precision policy (port of
:mod:`repro.core.gradients.base`).

A :class:`GradientBackend` names one gradient path through a solve; the
front-end (:mod:`repro_torch.core.solve`) validates against the registry and
dispatches to ``backend.solve``.  The four backends, registered in the
reference's order by :mod:`repro_torch.core.gradients`:

==================== ========================= ============================
mode                 what the forward keeps    backward
==================== ========================= ============================
discretise           every step's activations  autograd through the loop
reversible_adjoint   the terminal state        algebraic reversal (Alg. 2)
continuous_adjoint   the terminal value        adjoint SDE backsolve (eq. 6)
checkpoint           the segment roots         recursive recompute
==================== ========================= ============================

The precision policy rides the same layer: :func:`resolve_precision` maps
``"highest" | "bf16_compute"`` to a :class:`PrecisionPolicy` whose
``wrap_fields`` evaluates the vector fields in the compute dtype while the
solver state and every adjoint accumulator stay in the state dtype (the
casts are differentiable, so cotangents come back up-cast).  The wrap
happens before any backend sees the fields, so every backend runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "GRADIENT_BACKENDS",
    "PRECISION_POLICIES",
    "GradientBackend",
    "PrecisionPolicy",
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
    bridge_depth) -> (z_T, converged)``, or ``None`` where the backend
    refuses adaptive solves; ``validate``: backend-specific eager checks, or
    ``None``."""

    name: str
    summary: str
    solve: Callable
    solve_adaptive: Optional[Callable] = None
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


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How the vector fields' evaluation relates to the state dtype.

    ``compute_dtype=None`` ("highest") evaluates the fields untouched: the
    wrap is the identity, bitwise the unwrapped path.  A compute dtype
    (bfloat16) casts the parameters and the state for the field evaluation
    only and casts the output back, so the solver state, the Brownian path
    and every adjoint accumulator keep the state dtype."""

    name: str
    compute_dtype: Optional[torch.dtype] = None

    def wrap_fields(self, drift: Callable, diffusion: Callable):
        if self.compute_dtype is None:
            return drift, diffusion
        from ...kernels import ops

        return (ops.wrap_vector_field(drift, self.compute_dtype),
                ops.wrap_vector_field(diffusion, self.compute_dtype))


def resolve_precision(precision) -> PrecisionPolicy:
    """``precision=`` string (or a ready policy) -> :class:`PrecisionPolicy`."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision == "highest":
        return PrecisionPolicy("highest", None)
    if precision == "bf16_compute":
        return PrecisionPolicy("bf16_compute", torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISION_POLICIES}")
