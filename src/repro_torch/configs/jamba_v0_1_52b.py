"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every second layer.  [arXiv:2403.19887; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    moe=True,
    num_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,      # 1 attention : 7 mamba
    ssm_state=16,      # jamba uses mamba-1-style d_state=16
    ssm_headdim=64,
    ffn="swiglu",
    norm="rmsnorm",
)
