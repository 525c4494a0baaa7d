"""Gradient backends of the solve stack (port of
:mod:`repro.core.gradients`).  Importing the package registers the four
backends in the reference's inventory order: ``discretise``,
``reversible_adjoint``, ``continuous_adjoint`` and ``checkpoint``; see
:mod:`repro_torch.core.gradients.base` for the protocol and the precision
policy."""

from .base import (  # noqa: F401
    GRADIENT_BACKENDS,
    PRECISION_POLICIES,
    GradientBackend,
    PrecisionPolicy,
    available_gradient_modes,
    get_backend,
    register_backend,
    resolve_precision,
)
from . import discretise  # noqa: F401,E402  (registers "discretise")
from .reversible import (  # noqa: F401,E402
    reversible_heun_solve,
    reversible_heun_solve_adaptive,
    reversible_heun_solve_final,
)
from .continuous import continuous_adjoint_solve  # noqa: F401,E402
from .checkpoint import (  # noqa: F401,E402
    checkpoint_schedule,
    checkpoint_solve,
    checkpoint_solve_adaptive,
)
