"""Architecture config schema (port of :mod:`repro.configs.base`).

The port keeps its own copy because ``repro.configs`` imports
``jax.numpy``.  :class:`ArchConfig` keeps every field of the reference, so
the families still to port need no rewrite; ``dtype`` is a torch dtype.
The execution knobs (``scan_layers``, ``attn_mha_tp``, ``attn_impl``, ...)
are layout and compile hints for XLA: the port's model reads none of them,
and they stay only so a config reads the same in both packages.  The
exceptions are ``remat`` and ``remat_policy`` (the training stack's
per-unit checkpoint) and ``adam_dtype`` (the optimizer's moments).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    ffn: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10_000.0
    dtype: object = torch.bfloat16

    # --- attention flavour
    attention: str = "gqa"           # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25

    # --- hybrid / SSM
    ssm: bool = False
    attn_every: int = 0
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- encoder-decoder
    encoder_layers: int = 0

    # --- multimodal stub frontend
    frontend: Optional[str] = None
    frontend_len: int = 0

    # --- execution knobs of the XLA reference (the port reads remat,
    #     remat_policy and adam_dtype only)
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"
    reversible_residual: bool = False
    sequence_parallel: bool = False
    attn_mha_tp: bool = True
    attn_impl: str = "scan"
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    adam_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (:func:`repro_torch.models.counting.param_count`;
        for MoE also see :meth:`active_param_count`)."""
        from ..models.counting import param_count

        return param_count(self)

    def active_param_count(self) -> int:
        from ..models.counting import param_count

        return param_count(self, active_only=True)
