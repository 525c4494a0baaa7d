"""The solve stack and the Latent-SDE model (port of :mod:`repro.core`)."""

from .brownian import (  # noqa: F401
    BrownianPath,
    DenseBrownianPath,
    VirtualBrownianTree,
    brownian_increments,
    davie_levy_area,
    space_time_levy_area,
    stlevy_difference,
)
from .brownian_interval import BrownianInterval, HostVirtualBrownianTree  # noqa: F401
from .gradients import (  # noqa: F401
    GRADIENT_BACKENDS,
    GradientBackend,
    PrecisionPolicy,
    checkpoint_schedule,
    register_backend,
    resolve_precision,
)
from .solve import (  # noqa: F401
    SOLVERS,
    SolverSpec,
    available_solvers,
    get_solver,
    gradient_capabilities,
    register_solver,
    solve,
    solve_adaptive,
    solve_batched,
)
from .solvers import (  # noqa: F401
    NFE_PER_STEP,
    RevHeunState,
    ode_solve,
    reversible_heun_reverse_step,
    reversible_heun_step,
    sde_solve,
)
