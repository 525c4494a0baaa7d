"""starcoder2-3b [dense] — GQA kv=2, RoPE, GELU MLP, tied embeddings.
[arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    qkv_bias=True,
    ffn="gelu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=100_000.0,
)
