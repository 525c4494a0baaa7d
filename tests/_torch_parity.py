"""Shared helpers of the tests/test_torch_*.py parity suite (JAX package vs
the PyTorch port, on the CPU).

Every tests/test_torch_*.py imports this module (tests/test_torch_imports.py
holds them to it), and importing it gives PyTorch one intra-op thread when
no card is present.  The suite runs under xdist: each worker's torch would
otherwise start one OpenMP thread per core, and six workers starve each
other and the JAX workers beside them (a test of a few seconds alone took
minutes).  On the card (``pytest -m cuda``) the default stays.

JAX config toggles are process-global and the suite runs under xdist
(``--dist loadfile``), so :func:`jax_config` sets them and restores them in
``try/finally``.  Inputs are made with numpy from fixed seeds and handed to
both sides as numpy arrays.  JAX is imported where it is used, so the card's
tests (tests/test_torch_cuda.py, no JAX there) can import this module too.
"""

import contextlib

import numpy as np
import torch

if not torch.cuda.is_available():
    torch.set_num_threads(1)


@contextlib.contextmanager
def jax_config(x64: bool = False):
    """x64 as asked and ``jax_threefry_partitionable=False`` — the layout
    both ``repro.kernels.prng`` and the port transcribe."""
    import jax

    old = (jax.config.jax_enable_x64, jax.config.jax_threefry_partitionable)
    jax.config.update("jax_enable_x64", x64)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old[0])
        jax.config.update("jax_threefry_partitionable", old[1])


def key_words(seed: int, n: int) -> np.ndarray:
    """``(n, 2)`` uint32 key words from a numpy seed."""
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2), dtype=np.uint32)


def torch_keys(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).astype(np.int64))


def ulp_distance(a, b) -> np.ndarray:
    """|a - b| in units of the larger magnitude's spacing."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}
