"""Analytic parameter counts (port of :mod:`repro.models.counting`: every
family, MLA attention and the encoder-decoder's encoder and
cross-attention included).  They mirror what
:func:`repro_torch.models.transformer.init_lm` allocates, and the tests
hold them to the leaf sizes and to the reference's counts."""

from __future__ import annotations

from ..configs.base import ArchConfig


def _attn_params(cfg: ArchConfig) -> int:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return (d * rq + rq                           # wq_a + q_ln
                + rq * hq * (dn + dr)                 # wq_b
                + d * (rkv + dr) + rkv                # wkv_a + kv_ln
                + rkv * hq * (dn + dv)                # wkv_b
                + hq * dv * d)                        # wo
    n = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    if cfg.qkv_bias:
        n += hq * hd + 2 * hkv * hd
    return n


def _ffn_params(cfg: ArchConfig) -> int:
    n = 2 * cfg.d_model * cfg.d_ff                    # up + down
    if cfg.ffn == "swiglu":
        n += cfg.d_model * cfg.d_ff                   # gate
    return n


def _moe_params(cfg: ArchConfig, active_only: bool = False) -> int:
    e = cfg.top_k if active_only else cfg.num_experts
    return cfg.d_model * cfg.num_experts + e * _ffn_params(cfg)  # router + experts


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


def _layer_params(cfg: ArchConfig, layer_idx: int, active_only: bool) -> int:
    """One block of the stack at global index ``layer_idx``."""
    if cfg.ssm:                                       # pure SSM stack
        return _mamba_params(cfg) + _norm_params(cfg)
    if cfg.family == "hybrid":
        is_attn = (layer_idx % cfg.attn_every) == 0
        mixer = _attn_params(cfg) if is_attn else _mamba_params(cfg)
        is_moe = cfg.moe and (layer_idx % cfg.moe_every) == 1
        ffn = _moe_params(cfg, active_only) if is_moe else _ffn_params(cfg)
        return mixer + ffn + 2 * _norm_params(cfg)
    ffn = _moe_params(cfg, active_only) if cfg.moe else _ffn_params(cfg)
    return _attn_params(cfg) + ffn + 2 * _norm_params(cfg)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total (or routing-active: ``top_k`` of the experts) parameter count
    of the full model."""
    n = cfg.vocab * cfg.d_model                       # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model                  # head
    n += _norm_params(cfg)                            # final norm
    n += sum(_layer_params(cfg, i, active_only) for i in range(cfg.num_layers))
    if cfg.encoder_layers:
        # encoder blocks: self-attention + FFN; the decoder adds a
        # cross-attention (and its norm) per block; the encoder's final norm
        n += cfg.encoder_layers * (_attn_params(cfg) + _ffn_params(cfg) + 2 * _norm_params(cfg))
        n += cfg.num_layers * (_attn_params(cfg) + _norm_params(cfg)) + _norm_params(cfg)
    return n


def model_flops_per_token(cfg: ArchConfig) -> int:
    """6·N_active — the standard training-FLOPs-per-token estimate."""
    return 6 * param_count(cfg, active_only=True)
