"""Optimisers as ``(init, update)`` pairs over parameter trees (port of
:mod:`repro.optim`: Adam, AdamW, global-norm clipping, the cosine
schedule)."""

from .optimizers import (  # noqa: F401
    OptState,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
)
