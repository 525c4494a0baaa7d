"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596; hf]

12L(enc)+12L(dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The audio frontend is a stub: the caller supplies precomputed frame
embeddings to the encoder.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,           # decoder depth
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    ffn="gelu",
    norm="layernorm",
    frontend="frame",
    frontend_len=1024,
)
