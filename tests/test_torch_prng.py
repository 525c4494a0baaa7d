"""Port's Threefry PRNG (repro_torch.kernels.prng) against repro.kernels.prng
and jax.random (threefry_partitionable=False), on the CPU.

Tolerances:
* key words, ``fold_in``, ``split``, ``random_bits`` (32 and 64 bit) and the
  uniform bit patterns: bitwise.
* normals: <= 4 ulp in float32 (measured <= 3 over 200k draws; the port
  writes XLA's erf_inv polynomial as separate multiplies and adds and uses
  torch.log1p, XLA contracts FMAs and has its own log1p).  float64: <= 2**19
  ulp.  Measured: <= 32 ulp in most runs, but XLA's CPU float64 normal itself
  moves by up to 2.8e5 ulp (6e-11 relative) at |z| > 3.3 from one process
  to the next on the same script, so the bound covers that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys, ulp_distance
from repro.kernels import prng as jprng
from repro_torch.kernels import prng as tprng

SIZES = [1, 2, 7, 16, 17]


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_prngkey_and_split_match_jax(x64, num):
    with jax_config(x64):
        for seed in (0, 7, 2 ** 31 - 1):
            key = jax.random.PRNGKey(seed)
            tk = tprng.PRNGKey(seed)
            np.testing.assert_array_equal(np.asarray(key).astype(np.int64), tk.numpy())
            want = np.asarray(jax.random.split(key, num)).astype(np.int64)
            np.testing.assert_array_equal(tprng.split(tk, num).numpy(), want)


def test_threefry_words_match_reference():
    w = np.random.default_rng(0).integers(0, 2 ** 32, (4, 64), dtype=np.uint32)
    with jax_config():
        y1, y2 = jprng.threefry2x32(*w)
    t1, t2 = tprng.threefry2x32(*(torch_keys(x) for x in w))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(y1).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(y2).astype(np.int64))


@pytest.mark.parametrize("x64", [False, True])
def test_fold_in_matches_jax(x64):
    words = key_words(1, 5)
    with jax_config(x64):
        for data in (0, 1, 22, 12345, 2 ** 31 - 1):
            for k in words:
                want = np.asarray(jax.random.fold_in(jnp.asarray(k), data))
                ref = np.asarray(jprng.fold_in(k[0], k[1], data))
                got = torch.stack(tprng.fold_in(k[0], k[1], data)).numpy()
                np.testing.assert_array_equal(got, want.astype(np.int64))
                np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("size", SIZES)
def test_random_bits_match_jax(size):
    words = key_words(2, 3)
    tk = torch_keys(words)
    got32 = tprng.random_bits(tk[:, 0], tk[:, 1], 32, size).numpy()
    with jax_config(x64=True):
        for i, k in enumerate(words):
            key = jnp.asarray(k)
            want32 = np.asarray(jax.random.bits(key, (size,), jnp.uint32))
            np.testing.assert_array_equal(got32[i], want32.astype(np.int64))
            np.testing.assert_array_equal(
                got32[i], np.asarray(jprng.random_bits(k[0], k[1], 32, size)).astype(np.int64))
            want64 = np.asarray(jax.random.bits(key, (size,), jnp.uint64))
            got64 = tprng.random_bits(tk[i, 0], tk[i, 1], 64, size).numpy()
            np.testing.assert_array_equal(got64.view(np.uint64), want64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("size", SIZES)
def test_uniform_bits_match_jax(dtype, size):
    words = key_words(3, 4)
    tk = torch_keys(words)
    got = tprng.uniform(tk[:, 0], tk[:, 1], size, TORCH_DTYPES[dtype]).numpy()
    with jax_config(x64=dtype == "float64"):
        for i, k in enumerate(words):
            want = np.asarray(jax.random.uniform(jnp.asarray(k), (size,), dtype))
            np.testing.assert_array_equal(got[i].view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype,max_ulp", [("float32", 4), ("float64", 2 ** 19)])
@pytest.mark.parametrize("size", [16, 17, 1001])
def test_normal_within_ulp_of_jax(dtype, max_ulp, size):
    words = key_words(4, 6)
    tk = torch_keys(words)
    got = tprng.normal(tk[:, 0], tk[:, 1], size, TORCH_DTYPES[dtype]).numpy()
    with jax_config(x64=dtype == "float64"):
        want = np.stack([np.asarray(jax.random.normal(jnp.asarray(k), (size,), dtype))
                         for k in words])
        ref = np.stack([np.asarray(jprng.normal(k[0], k[1], size, dtype)) for k in words])
    assert got.dtype == want.dtype
    assert ulp_distance(got, want).max() <= max_ulp
    assert ulp_distance(got, ref).max() <= max_ulp


def test_batched_keys_draw_the_single_key_rows():
    """A (B, 2) key batch draws, row by row, exactly the single-key draws."""
    tk = torch_keys(key_words(5, 4))
    for dtype in (torch.float32, torch.float64):
        batch = tprng.normal_like(tk[:, 0], tk[:, 1], (3, 5), dtype)
        assert batch.shape == (4, 3, 5)
        for i in range(4):
            assert torch.equal(batch[i], tprng.normal_like(tk[i, 0], tk[i, 1], (3, 5), dtype))


def test_erf_inv_edges():
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor([-1.0, 0.0, 1.0], dtype=dtype)
        y = tprng.erf_inv(x)
        assert y[0] == -np.inf and y[1] == 0.0 and y[2] == np.inf
    with pytest.raises(ValueError, match="float32 or float64"):
        tprng.erf_inv(torch.zeros(2, dtype=torch.float16))
