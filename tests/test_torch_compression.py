"""Int8 error-feedback gradient compression (``repro_torch.optim.compression``)
against ``repro.optim.compression`` on the CPU: ``q`` and ``scale`` bitwise
the reference's, the new error buffer within one float32 ulp of its
magnitude (XLA may fuse ``(g + e) − q·s``), and the compressed mean
all-reduce over two gloo ranks equal to the mean of the ranks' dequantised
payloads."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dp_ranks as R
from _torch_parity import jax_config
from repro.optim import compression as jcomp
from repro_torch.distributed import compat
from repro_torch.optim import compress_int8, decompress_int8, ef_compress_update
from repro_torch.optim import compression


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((7, 5)) * 3).astype(dtype),
            "b": (rng.standard_normal(5) * 1e-3).astype(dtype),
            "z": np.zeros((2, 2), dtype),
            "big": np.concatenate([rng.standard_normal(63), [40.0]]).astype(dtype)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_bitwise_the_reference(seed):
    for name, x in _tree(seed, np.float32).items():
        with jax_config():
            q, s = jax.jit(jcomp.compress_int8)(jnp.asarray(x))
            q, s = np.asarray(q), np.asarray(s)
        got_q, got_s = compress_int8(torch.from_numpy(x))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        assert np.array_equal(got_q.numpy(), q), name
        assert got_s.numpy().view(np.uint32) == s.view(np.uint32), name
        back = decompress_int8(got_q, got_s)
        assert np.array_equal(back.numpy(), np.asarray(jcomp.decompress_int8(q, s))), name


@pytest.mark.parametrize("seed", [3, 4])
def test_ef_compress_update_matches_the_reference(seed):
    grads, err = _tree(seed, np.float32), _tree(seed + 10, np.float32)
    err = {k: v * 1e-2 for k, v in err.items()}
    with jax_config():
        jq, js, jerr = jax.jit(jcomp.ef_compress_update)(
            jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
        jq, js, jerr = jax.device_get((jq, js, jerr))
    tq, ts, terr = ef_compress_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                      {k: torch.from_numpy(v) for k, v in err.items()})
    for k in grads:
        assert np.array_equal(tq[k].numpy(), jq[k]), k
        assert ts[k].numpy().view(np.uint32) == np.asarray(js[k]).view(np.uint32), k
        corrected = grads[k] + err[k]
        ulp = np.spacing(np.float32(np.abs(corrected).max() + 1e-30))
        assert np.abs(terr[k].numpy() - jerr[k]).max() <= ulp, k


@functools.lru_cache(maxsize=None)
def _two_ranks():
    return compat.launch(R.compressed_mean, 2, (5,), timeout=600.0)


def test_allreduce_compressed_means_the_dequantised_payloads():
    (mean0, err0, deq0), (mean1, err1, deq1) = _two_ranks()
    for k in deq0:
        want = (deq0[k] + deq1[k]) / 2
        assert torch.equal(mean0[k], want) and torch.equal(mean1[k], want), k
        assert not torch.equal(err0[k], err1[k]) or not err0[k].any()  # each rank's own


def test_allreduce_compressed_without_a_group_is_the_dequantised_payload():
    g = {"w": torch.linspace(-2, 3, 12).reshape(3, 4)}
    e = {"w": torch.full((3, 4), 1e-3)}
    mean, new_err = compression.allreduce_compressed(g, e)
    q, s, want_err = ef_compress_update(g, e)
    assert torch.equal(mean["w"], decompress_int8(q["w"], s["w"]))
    assert torch.equal(new_err["w"], want_err["w"])
