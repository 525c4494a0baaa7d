"""The solve stack and the Latent-SDE model (port of :mod:`repro.core`)."""

from .brownian import BrownianPath, SpaceTimeLevyNotPortedError  # noqa: F401
from .solve import SOLVERS, NotPortedError, SolverSpec, get_solver, solve  # noqa: F401
from .solvers import (  # noqa: F401
    NFE_PER_STEP,
    RevHeunState,
    reversible_heun_reverse_step,
    reversible_heun_step,
)
