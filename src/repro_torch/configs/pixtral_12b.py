"""pixtral-12b [vlm] — Pixtral ViT frontend (stub) + Mistral-Nemo-style decoder.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The vision frontend is a stub: the caller supplies precomputed patch
embeddings for the image prefix (``frontend_len`` rows ahead of the text).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_len=1024,
)
