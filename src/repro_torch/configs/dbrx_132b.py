"""dbrx-132b [moe] — 16 experts top-4 (fine-grained MoE).
[hf:databricks/dbrx-base; unverified]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    moe=True,
    num_experts=16,
    top_k=4,
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
)
