"""qwen2.5-14b [dense] — GQA with QKV bias.  [hf:Qwen/Qwen2.5-*; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)
