"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

48L d_model=2048 vocab=50280, ssm_state=128, headdim=64, expand=2.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=32,            # unused by the mixer; kept for schema uniformity
    num_kv_heads=32,
    d_ff=0,
    vocab=50280,
    ssm=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    norm="rmsnorm",
)
