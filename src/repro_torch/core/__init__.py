"""The solve stack and the Latent-SDE model (port of :mod:`repro.core`)."""

from .brownian import AdaptiveSliceNotPortedError, BrownianPath  # noqa: F401
from .gradients import GradientNotPortedError  # noqa: F401
from .solve import SOLVERS, NotPortedError, SolverSpec, get_solver, solve  # noqa: F401
from .solvers import NFE_PER_STEP, RevHeunState, reversible_heun_step  # noqa: F401
