"""Compatibility shim (port of :mod:`repro.core.adjoint`): the gradient
layer lives in :mod:`repro_torch.core.gradients`; this module keeps the
reference's historical import path and its four names."""

from .gradients.continuous import continuous_adjoint_solve
from .gradients.reversible import (
    reversible_heun_solve,
    reversible_heun_solve_adaptive,
    reversible_heun_solve_final,
)

__all__ = [
    "continuous_adjoint_solve",
    "reversible_heun_solve",
    "reversible_heun_solve_adaptive",
    "reversible_heun_solve_final",
]
