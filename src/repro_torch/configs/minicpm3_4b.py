"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]

62L d_model=2560 40H (kv=40 — MLA shares a compressed latent across heads)
d_ff=6400 vocab=73448.  MLA ranks follow the HF config: q_lora 768,
kv_lora 256, qk_nope 64, qk_rope 32, v_head 64.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    head_dim=96,  # nope + rope
    ffn="swiglu",
    norm="rmsnorm",
)
