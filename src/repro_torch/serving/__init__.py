"""Neural-SDE serving (port of :mod:`repro.serving`), the surface the serve
CLI wraps:

- :class:`Request` / :class:`ServeResult`: the wire types (a request's
  ``deadline_ms``, ``model_id`` and optional ``rtol`` floor; a result's
  per-row ``converged``).
- :class:`ModelRegistry` / :class:`LoadedModel` / :func:`load_model`: N
  named checkpoints in one process from ``repro-serving/v2`` bundles (v1
  bundles upgrade to one ``"default"`` entry), with program pools keyed
  ``(model_id, kind, bucket)`` — CUDA graphs on the card.
- :class:`Scheduler`: continuous batching of chunked rollouts (per-row
  ``t_start``; requests join at chunk boundaries in arrival order),
  adaptive terminal batches at deadline-routed tolerances, per-model
  quotas and cross-lane preemption.
- :class:`AsyncFrontend`: asyncio ingestion in front of one scheduler, and
  a JSON-lines TCP socket on localhost.
- :func:`serve_sde`: restore, buckets and the drain loops behind the CLI.
"""

from .frontend import (  # noqa: F401
    AsyncFrontend,
    request_from_wire,
    result_summary,
)
from .registry import (  # noqa: F401
    LoadedModel,
    ModelRegistry,
    config_from_meta,
    load_model,
    restore_for_serving,
)
from .scheduler import (  # noqa: F401
    Scheduler,
    class_latency_summary,
    latency_summary,
    run_open_loop,
    serve_buckets,
)
from .service import (  # noqa: F401
    _adaptive_terminal_loop,
    _batch_loop,
    _coalesce,
    _compile_pool,
    _percentile,
    _request_keys,
    _scheduler_loop,
    _stream_loop,
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

__all__ = [
    "AsyncFrontend",
    "DEADLINE_CLASSES",
    "DeadlineClass",
    "LoadedModel",
    "ModelRegistry",
    "Request",
    "Scheduler",
    "ServeResult",
    "class_latency_summary",
    "deadline_class_for",
    "latency_summary",
    "load_model",
    "percentile",
    "request_from_wire",
    "restore_for_serving",
    "result_summary",
    "route_rtol",
    "run_open_loop",
    "serve_buckets",
    "serve_sde",
    "synthetic_requests",
]
