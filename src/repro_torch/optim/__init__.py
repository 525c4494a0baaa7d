"""Optimisers as ``(init, update)`` pairs over parameter trees (port of
:mod:`repro.optim`; Adam so far)."""

from .optimizers import OptState, adam, apply_updates  # noqa: F401
