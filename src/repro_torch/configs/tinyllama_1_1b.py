"""tinyllama-1.1b [dense] — llama2-architecture small.  [arXiv:2401.02385; hf]

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    ffn="swiglu",
    norm="rmsnorm",
)
