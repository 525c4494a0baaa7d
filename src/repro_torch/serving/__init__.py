"""Neural-SDE serving (port of :mod:`repro.serving`): the Latent-SDE prior
decode behind a FIFO coalescing drain loop."""

from .scheduler import serve_buckets  # noqa: F401
from .service import (  # noqa: F401
    ServingNotPortedError,
    _batch_loop,
    _coalesce,
    _request_keys,
    config_from_meta,
    restore_for_serving,
    serve_sde,
)
from .types import PAD_SEED, Request, percentile, synthetic_requests  # noqa: F401
