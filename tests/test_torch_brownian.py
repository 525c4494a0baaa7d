"""The port's batched BrownianPath (repro_torch.core.brownian) against the
JAX package's per-row BrownianPath.increment under jax.vmap, on the CPU.

Tolerance: the normal bound of tests/test_torch_prng.py (increments are
normals times sqrt(dt)): <= 4 ulp in float32, <= 2**19 ulp in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys, ulp_distance
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro_torch.core.brownian import AdaptiveSliceNotPortedError, BrownianPath

NORMAL_ULP = {"float32": 4, "float64": 2 ** 19}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [4, 5])
def test_batched_increments_match_vmapped_jax(dtype, d):
    words = key_words(20, 6)
    num_steps = 8
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (d,), TORCH_DTYPES[dtype])
    got = bm.increments(num_steps).numpy()
    assert got.shape == (num_steps, 6, d)
    with jax_config(x64=dtype == "float64"):
        def per_row(k):
            path = JaxBrownianPath(k, 0.0, 1.0, (d,), jnp.dtype(dtype))
            return path.increments(num_steps)

        want = np.asarray(jax.jit(jax.vmap(per_row, out_axes=1))(jnp.asarray(words)))
    assert want.dtype == got.dtype
    assert ulp_distance(got, want).max() <= NORMAL_ULP[dtype]


def test_increment_is_a_pure_function_of_key_and_step():
    words = key_words(21, 4)
    bm = BrownianPath(torch_keys(words), 0.0, 2.0, (3,))
    a, b = bm.increment(5, 10), bm.increment(5, 10)
    assert torch.equal(a, b)
    sub = BrownianPath(torch_keys(words[1:3]), 0.0, 2.0, (3,))
    assert torch.equal(sub.increment(5, 10), a[1:3])
    assert not torch.equal(bm.increment(6, 10), a)


def test_off_grid_queries_name_the_adaptive_slice():
    bm = BrownianPath(torch_keys(key_words(22, 2)), 0.0, 1.0, (3,))
    with pytest.raises(AdaptiveSliceNotPortedError, match="adaptive driver"):
        bm.evaluate(0.1, 0.2)
    with pytest.raises(AdaptiveSliceNotPortedError, match="adaptive driver"):
        bm.value(0.3)
    with pytest.raises(AdaptiveSliceNotPortedError, match="srk"):
        BrownianPath(bm.key, 0.0, 1.0, (3,), levy_area="space-time")
    with pytest.raises(ValueError, match="int64"):
        BrownianPath(bm.key.to(torch.int32), 0.0, 1.0, (3,))
