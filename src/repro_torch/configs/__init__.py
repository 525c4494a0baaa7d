"""Architecture registry (port of :mod:`repro.configs`): ``--arch <id>``
resolution and the reduced smoke configs.

The port has all ten architectures of the reference: the dense family
(qwen2.5-14b, tinyllama-1.1b, starcoder2-3b, and minicpm3-4b with MLA
attention), the MoE family (dbrx-132b, grok-1-314b), the pure-SSM family
(mamba2-1.3b), the hybrid family (jamba-v0.1-52b), the VLM (pixtral-12b:
a prefix of patch embeddings ahead of a GQA decoder) and the
encoder-decoder (seamless-m4t-medium).
"""

from __future__ import annotations

import dataclasses

import torch

from . import (dbrx_132b, grok_1_314b, jamba_v0_1_52b, mamba2_1_3b, minicpm3_4b,
               pixtral_12b, qwen2_5_14b, seamless_m4t_medium, starcoder2_3b, tinyllama_1_1b)
from .base import ArchConfig

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (qwen2_5_14b, starcoder2_3b, tinyllama_1_1b, minicpm3_4b, dbrx_132b,
                      grok_1_314b, jamba_v0_1_52b, mamba2_1_3b, pixtral_12b,
                      seamless_m4t_medium)}

ARCH_NAMES = sorted(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests: small layers/width, tiny
    vocab, float32 — the reference's ``smoke_config`` field for field."""
    cfg = get_config(name)
    updates = dict(
        num_layers=max(2, cfg.attn_every or 2) if cfg.family == "hybrid" else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.ssm and cfg.family == "ssm" else 128,
        vocab=256,
        dtype=torch.float32,
        frontend_len=8 if cfg.frontend else 0,
        scan_layers=False,
        remat=False,
    )
    if cfg.attention == "mla":
        updates.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                       qk_rope_head_dim=8, v_head_dim=8, head_dim=16)
    if cfg.moe:
        updates.update(num_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm or cfg.family == "hybrid":
        updates.update(ssm_state=16, ssm_headdim=16)
    if cfg.encoder_layers:
        updates.update(encoder_layers=2)
    return dataclasses.replace(cfg, **updates)


__all__ = ["REGISTRY", "ARCH_NAMES", "ArchConfig", "get_config", "smoke_config"]
