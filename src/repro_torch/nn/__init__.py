"""Functional NN building blocks (port of :mod:`repro.nn`)."""

from .cde import (  # noqa: F401
    CDEDiscriminatorSpec,
    cde_control_field,
    cde_discriminator_init,
    cde_drift,
    cde_initial,
    cde_readout,
)
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
