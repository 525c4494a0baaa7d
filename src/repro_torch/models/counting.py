"""Analytic parameter count (port of :mod:`repro.models.counting`, the
dense and pure-SSM families' branches).  It mirrors what
:func:`repro_torch.models.transformer.init_lm` allocates, and the tests
hold it to the leaf sizes and to the reference's count."""

from __future__ import annotations

from ..configs.base import ArchConfig


def _attn_params(cfg: ArchConfig) -> int:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    if cfg.qkv_bias:
        n += hq * hd + 2 * hkv * hd
    return n


def _ffn_params(cfg: ArchConfig) -> int:
    n = 2 * cfg.d_model * cfg.d_ff                    # up + down
    if cfg.ffn == "swiglu":
        n += cfg.d_model * cfg.d_ff                   # gate
    return n


def _mamba_params(cfg: ArchConfig) -> int:
    d, di, n, h, k = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * n
    total = d * (2 * di + 2 * n + h)    # in_proj
    total += k * conv_dim + conv_dim    # conv
    total += 3 * h                      # A_log, dt_bias, Dskip
    total += di                         # norm_g
    total += di * d                     # out_proj
    return total


def _norm_params(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model if cfg.norm == "layernorm" else cfg.d_model


def param_count(cfg: ArchConfig) -> int:
    """Total parameter count of a dense- or SSM-family model."""
    from .transformer import unit_pattern

    unit_pattern(cfg)  # raises for the families the port lacks
    n = cfg.vocab * cfg.d_model                       # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model                  # head
    n += _norm_params(cfg)                            # final norm
    if cfg.ssm:                                       # pure SSM stack
        layer = _mamba_params(cfg) + _norm_params(cfg)
    else:
        layer = _attn_params(cfg) + _ffn_params(cfg) + 2 * _norm_params(cfg)
    return n + cfg.num_layers * layer
