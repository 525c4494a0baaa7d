"""Gradient backends of the solve stack (port of
:mod:`repro.core.gradients`).  Importing the package registers the ported
backends; only ``reversible_adjoint`` (forward pass) so far."""

from .base import (  # noqa: F401
    GRADIENT_BACKENDS,
    PRECISION_POLICIES,
    GradientBackend,
    GradientNotPortedError,
    available_gradient_modes,
    get_backend,
    register_backend,
    resolve_precision,
)
from . import reversible  # noqa: F401,E402  (registers reversible_adjoint)
