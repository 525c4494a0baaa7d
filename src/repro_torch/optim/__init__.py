"""Optimisers as ``(init, update)`` pairs over parameter trees (port of
:mod:`repro.optim`: Adam, AdamW, Adadelta, ``chain`` and the
Lipschitz projection, global-norm clipping, the cosine schedule, SWA; the
int8 error-feedback compression)."""

from .optimizers import (  # noqa: F401
    OptState,
    adadelta,
    adam,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    cosine_schedule,
    lipschitz_projection,
    swa_update,
)
from .compression import compress_int8, decompress_int8, ef_compress_update  # noqa: F401
