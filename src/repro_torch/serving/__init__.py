"""Neural-SDE serving (port of :mod:`repro.serving`): the Latent-SDE prior
decode and the SDE-GAN generator behind FIFO coalescing drain loops, and
the SDE-GAN's adaptive terminal sampling with deadline-routed tolerances."""

from .scheduler import serve_buckets  # noqa: F401
from .service import (  # noqa: F401
    ServingNotPortedError,
    _adaptive_terminal_loop,
    _batch_loop,
    _coalesce,
    _request_keys,
    config_from_meta,
    restore_for_serving,
    serve_sde,
)
from .types import (  # noqa: F401
    DEADLINE_CLASSES,
    PAD_SEED,
    DeadlineClass,
    Request,
    ServeResult,
    deadline_class_for,
    percentile,
    route_rtol,
    synthetic_requests,
)
