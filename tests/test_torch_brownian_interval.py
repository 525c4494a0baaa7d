"""The port's Brownian Interval and host Virtual Brownian Tree
(repro_torch.core.brownian_interval) against the JAX package's numpy
reference (repro.core.brownian_interval), on the CPU: **bitwise in
float64**.  Both walk the same tree with the same LRU, search hints and
seeds, and draw each node's normals from numpy's ``Philox`` on the host;
the port's bridge arithmetic runs on torch tensors as separate elementwise
ops, each rounding once as numpy's does.

Cases: sequential, doubly sequential (a solve then its adjoint sweep) and
random query orders, with and without ``preplant_dt``, both ``levy_area``
modes; equal ``cache_stats``; one host-to-device copy a sampled node; the
same bad-query errors; the host Virtual Brownian Tree.  chip_smoke.py
holds the card's bits to the CPU's.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)
from repro.core import brownian_interval as jbi
from repro_torch.core import brownian_interval as tbi
from repro_torch.device import NoCudaDeviceError

N = 40
SHAPE = (3, 4)


def _orders():
    iv = [(i / N, (i + 1) / N) for i in range(N)]
    perm = np.random.default_rng(0).permutation(N)
    rng = np.random.default_rng(1)
    free = [tuple(sorted(rng.uniform(0.0, 1.0, 2))) for _ in range(N)]
    return {"sequential": iv, "doubly": iv + iv[::-1],
            "random": [iv[i] for i in perm] + free}


def _pair(levy, preplant, cache_size=16, seed=7):
    kw = dict(seed=seed, levy_area=levy, preplant_dt=preplant, cache_size=cache_size)
    return (jbi.BrownianInterval(0.0, 1.0, SHAPE, **kw),
            tbi.BrownianInterval(0.0, 1.0, SHAPE, device="cpu", **kw))


@pytest.mark.parametrize("preplant", [None, 1.0 / N])
@pytest.mark.parametrize("levy", [None, "space-time"])
@pytest.mark.parametrize("order", ["sequential", "doubly", "random"])
def test_brownian_interval_is_the_references_bitwise(order, levy, preplant):
    want, got = _pair(levy, preplant)
    for s, t in _orders()[order]:
        a, b = want(s, t), got(s, t)
        a, b = (a, b) if levy else ((a,), (b,))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert y.dtype == torch.float64 and y.shape == SHAPE
            assert np.array_equal(x, y.numpy()), (s, t)
    assert got.cache_stats == want.cache_stats
    assert got.transfers == got.cache_stats[1]  # one copy a sampled node


def test_replayed_queries_are_cache_hits_with_the_same_bits():
    _, bi = _pair("space-time", None, cache_size=512)
    first = [bi(s, t) for s, t in _orders()["sequential"]]
    hits, misses = bi.cache_stats
    again = [bi(s, t) for s, t in _orders()["sequential"]]
    assert bi.cache_stats[1] == misses and bi.cache_stats[0] > hits
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(first, again))


def test_float32_stays_within_rounding_of_the_float64_interval():
    """float32 keeps the tree and the draws; its arithmetic rounds in
    float32 (the reference mixes in float64 scalars), so it is held to
    float32 rounding of the float64 result."""
    b64 = tbi.BrownianInterval(0.0, 1.0, SHAPE, seed=3, device="cpu")
    b32 = tbi.BrownianInterval(0.0, 1.0, SHAPE, seed=3, device="cpu", dtype=torch.float32)
    for s, t in _orders()["random"]:
        torch.testing.assert_close(b32(s, t), b64(s, t).float(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,t", [(0.5, 0.5), (0.6, 0.4), (-0.1, 0.5), (0.2, 1.5)])
def test_bad_queries_raise_the_references_error(s, t):
    want, got = _pair(None, None)
    with pytest.raises(ValueError, match="outside") as w:
        want(s, t)
    with pytest.raises(ValueError, match="outside") as g:
        got(s, t)
    assert str(g.value) == str(w.value)


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is taken")
    with pytest.raises(NoCudaDeviceError):
        tbi.BrownianInterval(0.0, 1.0, SHAPE)
    with pytest.raises(NoCudaDeviceError):
        tbi.HostVirtualBrownianTree(0.0, 1.0, SHAPE)


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_host_virtual_brownian_tree_is_the_references_bitwise(eps):
    want = jbi.HostVirtualBrownianTree(0.0, 1.0, SHAPE, seed=5, eps=eps)
    got = tbi.HostVirtualBrownianTree(0.0, 1.0, SHAPE, seed=5, eps=eps, device="cpu")
    queries = _orders()["random"][:12]
    for s, t in queries:
        assert np.array_equal(want(s, t), got(s, t).numpy())
    assert got.transfers == 2 * len(queries)  # one copy a point query
