"""grok-1-314b [moe] — 8 experts top-2.  [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    moe=True,
    num_experts=8,
    top_k=2,
    ffn="gelu",
    norm="rmsnorm",
)
