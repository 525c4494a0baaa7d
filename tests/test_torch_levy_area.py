"""The port's space-time Lévy area and the rest of the in-graph Brownian
layer (repro_torch.core.brownian) against the JAX package's, on the CPU:
``space_time_levy_area``, ``BrownianPath``'s ``(W, H)`` grid pairs and its
joint ``(W, ∫W)`` descent (the plain versions of the ``space_time_increment``
and ``space_time_value`` kernels), ``stlevy_difference``,
``DenseBrownianPath``, ``VirtualBrownianTree``, ``brownian_increments`` and
``davie_levy_area``; mirrors tests/test_levy_area.py.

The reference draws these through ``jax.random`` directly, so every
comparison sets ``jax_threefry_partitionable=False`` (``jax_config``), the
layout the port transcribes.

Tolerances, with their reasons:
* keys, the descent's go-left bits and its interval endpoints: bitwise.
* draws (normals times a scale): <= 4 ulp in float32, <= 2**19 ulp in
  float64 (tests/test_torch_prng.py's normal bound).
* values after arithmetic (the descent's levels, the tail, H from I, the
  dense prefix sums): float32 rtol 1e-5, atol 1e-6; float64 rtol 1e-9,
  atol 1e-10 — XLA contracts the multiply-adds into FMAs (the port does
  not: its kernels are bitwise its plain versions), sums in its own order,
  and its CPU float64 normal wobbles by up to 6e-11 relative at |z| > 3.3.
* inside the port: ``evaluate(s, t)[0] == value(t)[0] − value(s)[0]``
  bitwise; the Dense space-time path's ``w`` bitwise the scalar path's;
  Chen's relation to float64 roundoff (rtol 1e-9, the reference's).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys, ulp_distance
from repro.core import brownian as jb
from repro.core.brownian_interval import BrownianInterval as JaxBrownianInterval
from repro_torch.core import brownian as tb
from repro_torch.core.brownian_interval import BrownianInterval
from repro_torch.kernels import prng, ref

DTYPES = ["float32", "float64"]
NORMAL_ULP = {"float32": 4, "float64": 2 ** 19}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-9, atol=1e-10)}
#: query times: t0, t1, dyadic points and off-grid ones
TIMES = [0.0, 1.0, 0.5, 0.375, 0.3, 0.123456, 0.7654321, 0.999]
DEPTHS = [0, 1, 10, 24]


def _close(got, want, dtype):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL[dtype])


def _chen_h(w_st, h_st, w_tu, h_tu, h1, h2):
    """Chen's rule for the space-time Lévy area over adjacent intervals."""
    h = h1 + h2
    return (h1 * h_st + h2 * h_tu) / h + (h2 * w_st - h1 * w_tu) / (2.0 * h)


def _levy_path(words, shape=(3,), dtype="float64"):
    return tb.BrownianPath(torch_keys(words), 0.0, 1.0, shape, TORCH_DTYPES[dtype],
                           levy_area="space-time")


# -----------------------------------------------------------------------------
# the (W, H) draws
# -----------------------------------------------------------------------------


# (dtype, rows, shape): five keys over (4,), and the space_time_increment
# kernel's edges: an odd width (the float32 counter pairs' zero pad) and one
# key over the srk ELBO's (64, 17) state
ST_INCREMENT_CASES = [pytest.param(dtype, 5, (4,), id=dtype) for dtype in DTYPES] + [
    pytest.param(dtype, rows, shape, id=f"{dtype}-{rows}x{shape}")
    for dtype in DTYPES for rows, shape in ((5, (17,)), (1, (64, 17)))]


@pytest.mark.parametrize("dtype,rows,shape", ST_INCREMENT_CASES)
def test_space_time_increments_match_vmapped_jax(dtype, rows, shape):
    words = key_words(70, rows)
    with jax_config(x64=dtype == "float64"):
        def per_row(k):
            path = jb.BrownianPath(k, 0.0, 1.0, shape, jnp.dtype(dtype), levy_area="space-time")
            return path.increment(5, 16)

        want = jax.device_get(jax.jit(jax.vmap(per_row))(jnp.asarray(words)))
    got = _levy_path(words, shape, dtype).increment(5, 16)
    for g, w in zip(got, want):
        assert g.dtype == TORCH_DTYPES[dtype] and g.shape == (rows, *shape)
        assert ulp_distance(g.numpy(), w).max() <= NORMAL_ULP[dtype]
    stacked = _levy_path(words, shape, dtype).increments(16)
    assert torch.equal(stacked[0][5], got[0]) and torch.equal(stacked[1][5], got[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dt", [1 / 23, 0.1, 1e-3, 1 / 7])
def test_space_time_increment_launcher_scales_are_the_plain_versions(dt, dtype):
    """The launcher's scales, cached by ``(dt, dtype)``, are bitwise
    ``ref.space_time_scales``: on the first call and on a cached one."""
    from repro_torch.kernels import brownian as bk

    want = ref.space_time_scales(dt, TORCH_DTYPES[dtype])
    for _ in range(2):
        got = bk._increment_scales(float(dt), TORCH_DTYPES[dtype])
        assert np.array(got).tobytes() == np.array(want).tobytes()
    assert bk._increment_scales.cache_info().hits >= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_space_time_levy_area_and_brownian_increments_match_jax(dtype):
    words = key_words(71, 1)[0]
    with jax_config(x64=dtype == "float64"):
        key = jnp.asarray(words)
        want_wh = jax.device_get(jb.space_time_levy_area(key, 0.25, (6, 2), jnp.dtype(dtype)))
        want_inc = np.asarray(jb.brownian_increments(key, 0.0, 2.0, 8, (3,), jnp.dtype(dtype)))
    key = torch_keys(words)
    got_wh = tb.space_time_levy_area(key, 0.25, (6, 2), TORCH_DTYPES[dtype])
    for g, w in zip(got_wh, want_wh):
        assert ulp_distance(g.numpy(), w).max() <= NORMAL_ULP[dtype]
    got_inc = tb.brownian_increments(key, 0.0, 2.0, 8, (3,), TORCH_DTYPES[dtype])
    assert got_inc.shape == (8, 3)
    assert ulp_distance(got_inc.numpy(), want_inc).max() <= NORMAL_ULP[dtype]


def _jax_wh(words, ts, shape, dtype, depth):
    with jax_config(x64=dtype == "float64"):
        def per_row(k, t):
            path = jb.BrownianPath(k, 0.0, 1.0, shape, jnp.dtype(dtype), levy_area="space-time")
            return path._wh(t, depth), path.value(t, depth)

        return jax.device_get(jax.jit(jax.vmap(per_row))(jnp.asarray(words),
                                                         np.asarray(ts, dtype)))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_joint_descent_matches_jax(dtype, depth):
    """``(W(t), I(t))`` of the joint descent (the ``space_time_value``
    kernel's plain version) and the point value ``(W, H_{t0,t})`` at t0,
    t1, dyadic and off-grid times, one time per key row."""
    words = key_words(72, len(TIMES))
    (want_w, want_i), (want_vw, want_vh) = _jax_wh(words, TIMES, (2, 3), dtype, depth)
    k = torch_keys(words)
    t = torch.tensor(TIMES, dtype=TORCH_DTYPES[dtype])
    w, i = ref.space_time_value(k[:, 0], k[:, 1], t, 0.0, 1.0, (2, 3), TORCH_DTYPES[dtype],
                                depth)
    assert w.shape == i.shape == (len(TIMES), 2, 3)
    _close(w, want_w, dtype)
    _close(i, want_i, dtype)
    vw, vh = _levy_path(words, (2, 3), dtype).value(t, depth)
    assert torch.equal(vw, w)
    _close(vh, want_vh, dtype)
    assert torch.equal(vw[0], torch.zeros_like(vw[0])) and torch.equal(vh[0], vw[0])


def test_joint_descent_keys_and_decisions_are_bitwise():
    """The walk of :func:`ref.wh_descent` against the reference's key chain
    and interval, level by level: the root key ``fold_in(key, 0xB0BA)``,
    each level's ``split(fold_in(c, 1))`` and the child ``fold_in(c, 2|3)``,
    the go-left bits and the endpoints, all bitwise."""
    words = key_words(73, 4)
    ts = [0.3, 0.75, 0.123456, 1.0]
    depth = 24
    k = torch_keys(words)
    with jax_config(x64=True):
        want_keys, want_go, want_ab = [], [], []
        for w, t in zip(words, ts):
            c = jax.random.fold_in(jnp.asarray(w), 0xB0BA)
            a, b = np.float64(0.0), np.float64(1.0)
            row_k, row_go = [], []
            for _ in range(depth):
                half = 0.5 * (b - a)
                m = a + half
                row_k.append(np.asarray(jax.random.split(jax.random.fold_in(c, 1))))
                row_go.append(t <= m)
                c = jax.random.fold_in(c, 2 if t <= m else 3)
                a, b = (a, m) if t <= m else (m, b)
            want_keys.append(row_k)
            want_go.append(row_go)
            want_ab.append((a, b))
    h, half, go, s0, s1, k0, k1, a, b = ref.wh_descent(
        k[:, 0], k[:, 1], torch.tensor(ts, dtype=torch.float64), 0.0, 1.0, depth)
    want_keys = np.asarray(want_keys, dtype=np.int64)  # (rows, depth, 2, 2)
    assert np.array_equal(torch.stack(k0, -1).numpy(), want_keys[:, :, 0].transpose(1, 0, 2))
    assert np.array_equal(torch.stack(k1, -1).numpy(), want_keys[:, :, 1].transpose(1, 0, 2))
    assert np.array_equal(go.numpy(), np.asarray(want_go).T)
    assert np.array_equal(a.numpy(), [x for x, _ in want_ab])
    assert np.array_equal(b.numpy(), [y for _, y in want_ab])


@pytest.mark.parametrize("dtype", DTYPES)
def test_stlevy_difference_matches_jax(dtype):
    """Interval pairs from two point values, zero-length queries included
    (exact zeros: the checkpoint replay's padding slots)."""
    words = key_words(74, 1)[0]
    pairs = [(0.1, 0.4), (0.21, 0.77), (0.5, 1.0), (0.3, 0.3), (0.0, 0.0)]
    with jax_config(x64=dtype == "float64"):
        path = jb.BrownianPath(jnp.asarray(words), 0.0, 1.0, (5,), jnp.dtype(dtype),
                               levy_area="space-time")
        want = jax.device_get([path.evaluate(s, t, 10) for s, t in pairs])
    path = _levy_path(words, (5,), dtype)
    for (s, t), (ww, wh) in zip(pairs, want):
        dw, dh = path.evaluate(s, t, 10)
        _close(dw, ww, dtype)
        _close(dh, wh, dtype)
        if s == t:
            assert torch.equal(dw, torch.zeros(5, dtype=dw.dtype))
            assert torch.equal(dh, torch.zeros(5, dtype=dh.dtype))
    # per-row times (the adaptive loop's K-shaped tensors)
    rows = _levy_path(key_words(75, 3), (5,), dtype)
    s = torch.tensor([0.1, 0.2, 0.6], dtype=TORCH_DTYPES[dtype])
    t = torch.tensor([0.4, 0.2, 0.9], dtype=TORCH_DTYPES[dtype])
    dw, dh = rows.evaluate(s, t, 10)
    vs, vt = rows.value(s, 10), rows.value(t, 10)
    assert torch.equal(dw, vt[0] - vs[0]) and torch.equal(dh[1], torch.zeros_like(dh[1]))


# -----------------------------------------------------------------------------
# the (W, H) contract inside the port
# -----------------------------------------------------------------------------


def _paths(seed):
    key = prng.PRNGKey(seed)
    return (
        tb.BrownianPath(key, 0.0, 1.0, (4,), torch.float64, levy_area="space-time"),
        tb.DenseBrownianPath.sample(prng.PRNGKey(seed + 1), 0.0, 1.0, 64, (4,), torch.float64,
                                    levy_area="space-time"),
        tb.VirtualBrownianTree(prng.PRNGKey(seed + 2), 0.0, 1.0, (4,), tol=1e-4,
                               dtype=torch.float64, levy_area="space-time"),
    )


def test_wh_value_evaluate_contract_bitwise_w():
    for path in _paths(3):
        w0, h0 = path.value(0.0)
        assert torch.equal(w0, torch.zeros(4, dtype=torch.float64))
        assert torch.equal(h0, torch.zeros(4, dtype=torch.float64))
        for s, t in ((0.0, 0.3), (0.21, 0.77), (0.5, 1.0), (0.137, 0.1371)):
            dw, dh = path.evaluate(s, t)
            assert torch.equal(dw, path.value(t)[0] - path.value(s)[0])
            assert torch.isfinite(dh).all()


def test_wh_chen_combine_over_adjacent_intervals():
    for path in _paths(17)[:2]:
        for s, t, u in ((0.1, 0.456, 0.83), (0.0, 0.25, 1.0), (0.3, 0.31, 0.42)):
            w_st, h_st = (x.numpy() for x in path.evaluate(s, t))
            w_tu, h_tu = (x.numpy() for x in path.evaluate(t, u))
            w_su, h_su = (x.numpy() for x in path.evaluate(s, u))
            np.testing.assert_allclose(w_st + w_tu, w_su, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(_chen_h(w_st, h_st, w_tu, h_tu, t - s, u - t), h_su,
                                       rtol=1e-9, atol=1e-12)


# -----------------------------------------------------------------------------
# DenseBrownianPath
# -----------------------------------------------------------------------------


def _dense_pair(seed, dtype, levy, fine=32, shape=(3,)):
    words = key_words(seed, 1)[0]
    with jax_config(x64=dtype == "float64"):
        jp = jb.DenseBrownianPath.sample(jnp.asarray(words), 0.0, 1.0, fine, shape,
                                         jnp.dtype(dtype), levy_area=levy)
    tp = tb.DenseBrownianPath.sample(torch_keys(words), 0.0, 1.0, fine, shape,
                                     TORCH_DTYPES[dtype], levy_area=levy)
    return jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_sample_matches_jax(dtype):
    jp, tp = _dense_pair(76, dtype, "space-time")
    assert tp.w.shape == tp.hh.shape == (32, 3)
    assert ulp_distance(tp.w.numpy(), np.asarray(jp.w)).max() <= NORMAL_ULP[dtype]
    assert ulp_distance(tp.hh.numpy(), np.asarray(jp.hh)).max() <= NORMAL_ULP[dtype]


@pytest.mark.parametrize("num", [32, 8, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_increments_match_jax(dtype, num):
    """Fine (r = 1) and coarsened increments, both modes: the sums and the
    chen-combined areas."""
    for levy in (None, "space-time"):
        jp, tp = _dense_pair(77, dtype, levy)
        with jax_config(x64=dtype == "float64"):
            want = jax.device_get([jp.increment(jnp.int32(n), num) for n in (0, num // 2,
                                                                            num - 1)])
        for n, w in zip((0, num // 2, num - 1), want):
            got = tp.increment(n, num)
            for g, ww in zip(*(((got,), (w,)) if levy is None else (got, w))):
                _close(g, ww, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_point_values_match_jax(dtype):
    """``_w_at`` and ``_wi_at`` at the fine nodes (prefix sums) and inside
    cells (the conditional-mean tail), through ``value``."""
    times = [0.0, 0.25, 0.5, 1.0, 0.3, 0.123456, 0.999, 31.5 / 32]
    for levy in (None, "space-time"):
        jp, tp = _dense_pair(78, dtype, levy)
        with jax_config(x64=dtype == "float64"):
            want = jax.device_get([jp.value(t) for t in times])
        for t, w in zip(times, want):
            got = tp.value(t)
            for g, ww in zip(*(((got,), (w,)) if levy is None else (got, w))):
                _close(g, ww, dtype)
    jp, tp = _dense_pair(79, "float64", "space-time")
    with jax_config(x64=True):
        want = jax.device_get([jp._wi_at(t) for t in (0.5, 0.40625, 0.41)])
    for t, (ww, wi) in zip((0.5, 0.40625, 0.41), want):
        gw, gi = tp._wi_at(t)
        _close(gw, ww, "float64")
        _close(gi, wi, "float64")


def test_dense_wh_shares_w_bitwise_with_none_mode():
    key = prng.PRNGKey(21)
    plain = tb.DenseBrownianPath.sample(key, 0.0, 1.0, 32, (3,))
    levy = tb.DenseBrownianPath.sample(key, 0.0, 1.0, 32, (3,), levy_area="space-time")
    assert torch.equal(plain.w, levy.w)
    for n, num in ((0, 8), (5, 16), (31, 32)):
        assert torch.equal(plain.increment(n, num), levy.increment(n, num)[0])


# -----------------------------------------------------------------------------
# VirtualBrownianTree
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("levy", [None, "space-time"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_virtual_brownian_tree_matches_jax(dtype, levy):
    """Both modes: the scalar descent (the ``brownian_value`` kernel's plain
    version) and the joint one at ``ceil(log2(span/tol))`` levels, through
    ``value``, ``evaluate`` and ``increment``."""
    words = key_words(80, 1)[0]
    with jax_config(x64=dtype == "float64"):
        jv = jb.VirtualBrownianTree(jnp.asarray(words), 0.0, 1.0, (2,), tol=1e-3,
                                    dtype=jnp.dtype(dtype), levy_area=levy)
        want = jax.device_get([jv.value(0.37), jv.evaluate(0.25, 0.8),
                               jv.increment(jnp.int32(3), 8)])
    tv = tb.VirtualBrownianTree(torch_keys(words), 0.0, 1.0, (2,), tol=1e-3,
                                dtype=TORCH_DTYPES[dtype], levy_area=levy)
    assert tv._depth == jv._depth == 10
    for got, w in zip([tv.value(0.37), tv.evaluate(0.25, 0.8), tv.increment(3, 8)], want):
        for g, ww in zip(*(((got,), (w,)) if levy is None else (got, w))):
            _close(g, ww, dtype)


def test_virtual_brownian_tree_is_the_path_at_its_depth():
    key = torch_keys(key_words(81, 3))
    vbt = tb.VirtualBrownianTree(key, 0.0, 1.0, (4,))
    path = tb.BrownianPath(key, 0.0, 1.0, (4,))
    assert vbt._depth == 17 and vbt.batch_shape == (3,)
    assert torch.equal(vbt.value(0.3), path.value(0.3, 17))


# -----------------------------------------------------------------------------
# Davie's approximation, and the eager rejections
# -----------------------------------------------------------------------------


def test_davie_levy_area_lambda_antisymmetry():
    """``W̃ + W̃ᵀ == w⊗w`` and ``diag(W̃) = w²/2``; the draws against JAX's."""
    key = prng.PRNGKey(3)
    dt = 0.3
    w, h = tb.space_time_levy_area(prng.fold_in_key(key, 0), dt, (64, 5))
    wt = tb.davie_levy_area(prng.fold_in_key(key, 1), w, h, dt)
    assert wt.shape == (64, 5, 5)
    outer = w[..., :, None] * w[..., None, :]
    torch.testing.assert_close(wt + wt.transpose(-1, -2), outer, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.diagonal(wt, dim1=-2, dim2=-1), 0.5 * w * w,
                               rtol=1e-5, atol=1e-6)
    with jax_config(x64=False):
        jkey = jax.random.PRNGKey(3)
        jw, jh = jb.space_time_levy_area(jax.random.fold_in(jkey, 0), dt, (64, 5))
        want = np.asarray(jb.davie_levy_area(jax.random.fold_in(jkey, 1), jw, jh, dt))
    _close(wt, want, "float32")


def test_levy_mode_rejected_eagerly():
    with pytest.raises(ValueError, match="levy_area"):
        tb.BrownianPath(prng.PRNGKey(0), 0.0, 1.0, (2,), levy_area="space-time-time")
    with pytest.raises(ValueError, match="levy_area"):
        BrownianInterval(0.0, 1.0, (2,), levy_area="full", device="cpu")
    with pytest.raises(ValueError, match="levy_area"):
        JaxBrownianInterval(0.0, 1.0, (2,), levy_area="full")
    with pytest.raises(ValueError, match="hh"):
        tb.DenseBrownianPath(torch.zeros(4, 2), t0=0.0, t1=1.0, levy_area="space-time")
    with pytest.raises(ValueError, match="levy_area"):
        tb.VirtualBrownianTree(prng.PRNGKey(0), 0.0, 1.0, (2,), levy_area="full")
    with pytest.raises(ValueError, match="must divide"):
        tb.DenseBrownianPath.sample(prng.PRNGKey(0), 0.0, 1.0, 32, (2,)).increment(0, 5)


def test_the_reference_exports_are_the_ports():
    jcore = importlib.import_module("repro.core")
    tcore = importlib.import_module("repro_torch.core")
    for name in ("BrownianPath", "DenseBrownianPath", "VirtualBrownianTree",
                 "brownian_increments", "davie_levy_area", "space_time_levy_area",
                 "stlevy_difference", "BrownianInterval", "HostVirtualBrownianTree"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
