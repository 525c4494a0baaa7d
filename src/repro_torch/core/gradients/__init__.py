"""Gradient backends of the solve stack (port of
:mod:`repro.core.gradients`).  Importing the package registers the ported
backends: ``discretise`` and ``reversible_adjoint``."""

from .base import (  # noqa: F401
    GRADIENT_BACKENDS,
    PRECISION_POLICIES,
    GradientBackend,
    available_gradient_modes,
    get_backend,
    register_backend,
    resolve_precision,
)
from . import discretise, reversible  # noqa: F401,E402  (register the backends)
