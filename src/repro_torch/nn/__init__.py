"""Functional NN building blocks (port of :mod:`repro.nn`)."""

from .core import (  # noqa: F401
    ROW_BLOCK,
    gelu,
    gru_cell,
    gru_init,
    gru_scan,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    lipswish,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    sigmoid,
    silu,
    softplus,
    tcat,
)
