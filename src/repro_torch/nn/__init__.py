"""Functional NN building blocks (port of :mod:`repro.nn`)."""

from .core import (  # noqa: F401
    ROW_BLOCK,
    gru_cell,
    gru_init,
    gru_scan,
    linear,
    linear_init,
    lipswish,
    mlp,
    mlp_init,
    sigmoid,
    silu,
    tcat,
)
