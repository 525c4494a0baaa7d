"""The port's batched BrownianPath (repro_torch.core.brownian) against the
JAX package's per-row BrownianPath under jax.vmap, on the CPU: grid
increments, and the Lévy-bridge point values the adaptive loop queries
(``value``/``evaluate``, the plain version of the ``brownian_value``
kernel).

Tolerances: increments carry the normal bound of tests/test_torch_prng.py
(they are normals times sqrt(dt)): <= 4 ulp in float32, <= 2**19 ulp in
float64.  Point values are sums of ``depth + 1`` scaled normals: rtol 1e-5,
atol 1e-6 in float32 (normals within 4 ulp, and XLA contracts the
combine's multiply-adds into FMAs); atol 1e-10 in float64 (XLA's CPU
float64 normal wobbles by up to 6e-11 relative at |z| > 3.3).  Keys and
the bridge's midpoint keys are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys, ulp_distance
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.kernels import prng as jprng
from repro_torch.core.brownian import BrownianPath
from repro_torch.kernels import ref

NORMAL_ULP = {"float32": 4, "float64": 2 ** 19}
VALUE_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=0.0, atol=1e-10)}
#: query times: t0, t1, dyadic points, and off-grid ones
TIMES = [0.0, 1.0, 0.5, 0.375, 0.3, 0.123456, 0.7654321, 0.999]


def _jax_values(words, ts, shape, dtype, depth):
    """The reference path of each key row, queried at that row's time."""
    with jax_config(x64=dtype == "float64"):
        def per_row(k, t):
            return JaxBrownianPath(k, 0.0, 1.0, shape, jnp.dtype(dtype)).value(t, depth)

        return np.array(jax.jit(jax.vmap(per_row))(jnp.asarray(words), ts.astype(dtype)))


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
    """Off-grid queries, ported with the adaptive slice: one time per key
    row against the reference's per-row ``value``; ``evaluate(s, t) ==
    value(t) − value(s)`` bitwise; a scalar time broadcasts to every row.
    The space-time Lévy mode, ported with the srk slice, gives ``(W, H)``
    pairs of the same rows (tests/test_torch_levy_area.py holds their
    values); an unknown mode is refused by name."""
    words = key_words(22, len(TIMES))
    ts = np.array(TIMES)
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (3,))
    got = bm.value(torch.from_numpy(ts).float())
    assert got.shape == (len(TIMES), 3)
    torch.testing.assert_close(got, torch.from_numpy(_jax_values(words, ts, (3,),
                                                                 "float32", 24)),
                               **VALUE_TOL["float32"])
    assert torch.equal(got[0], torch.zeros(3))  # W(t0) = 0
    s, t = torch.full((len(TIMES),), 0.25), torch.from_numpy(ts).float()
    assert torch.equal(bm.evaluate(s, t), bm.value(t) - bm.value(s))
    assert torch.equal(bm.value(0.3), bm.value(torch.full((len(TIMES),), 0.3)))
    st = BrownianPath(bm.key, 0.0, 1.0, (3,), levy_area="space-time")
    w, h = st.value(torch.from_numpy(ts).float())
    assert w.shape == h.shape == (len(TIMES), 3)
    assert torch.equal(w[0], torch.zeros(3)) and torch.equal(h[0], torch.zeros(3))
    with pytest.raises(ValueError, match="levy_area"):
        BrownianPath(bm.key, 0.0, 1.0, (3,), levy_area="space-time-time")
    with pytest.raises(ValueError, match="int64"):
        BrownianPath(bm.key.to(torch.int32), 0.0, 1.0, (3,))


@pytest.mark.parametrize("depth", [10, 24])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_values_match_vmapped_jax(dtype, depth):
    words = key_words(23, len(TIMES))
    ts = np.array(TIMES)
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (2, 3), TORCH_DTYPES[dtype])
    got = bm.value(torch.from_numpy(ts), depth)
    want = _jax_values(words, ts, (2, 3), dtype, depth)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == want.shape
    torch.testing.assert_close(got, torch.from_numpy(want), **VALUE_TOL[dtype])


def test_single_key_value_spans_the_whole_state():
    """One key over a ``(B, d)`` state (the library solve's path): a scalar
    time, and the reference's one draw of the whole shape."""
    words = key_words(24, 1)
    bm = BrownianPath(torch_keys(words[0]), 0.0, 1.0, (4, 5))
    got = bm.value(torch.tensor(0.3), 10)
    want = _jax_values(words, np.array([0.3]), (4, 5), "float32", 10)[0]
    assert got.shape == (4, 5)
    torch.testing.assert_close(got, torch.from_numpy(want), **VALUE_TOL["float32"])


def test_bridge_keys_and_decisions_match_the_reference_bitwise():
    """The scalar walk: the reference's key chain (``fold_in(key, 0xB0B)``,
    midpoint ``fold_in(c, 1)``, child ``fold_in(c, 2 | 3)``) and its
    go-left bits, level by level."""
    words = key_words(25, len(TIMES))
    ts = np.array(TIMES, np.float32)
    depth = 12
    _, gos, km1, km2, _, _ = ref.bridge_descent(*torch_keys(words).T, torch.from_numpy(ts),
                                                0.0, 1.0, depth)
    with jax_config():
        for r, (w, t) in enumerate(zip(words, ts)):
            c = jprng.fold_in(jnp.uint32(w[0]), jnp.uint32(w[1]), jnp.uint32(0xB0B))
            a, b = np.float32(0.0), np.float32(1.0)
            for lvl in range(depth):
                m = np.float32(0.5) * (a + b)
                go = bool(t <= m)
                mid = jprng.fold_in(*c, jnp.uint32(1))
                assert [int(km1[lvl, r]), int(km2[lvl, r])] == [int(x) for x in mid]
                assert bool(gos[lvl, r]) == go
                c = jprng.fold_in(*c, jnp.uint32(2 if go else 3))
                a, b = (a, m) if go else (m, b)
