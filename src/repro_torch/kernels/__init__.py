"""Hand-written CUDA kernels for Hopper (``csrc/``), their launchers, the
plain PyTorch versions (``ref``), the Threefry PRNG (``prng``) and the
dispatch between them (``ops``).  Building and launching happen at first
use, never at import."""

from . import ops, prng, ref  # noqa: F401
