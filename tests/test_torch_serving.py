"""The port's Latent-SDE prior decode and its serving path against the JAX
package, on the CPU: latent_sde_sample_paths with weights carried over by
params_from_jax, serving bundles read across packages, serve_sde on the
CPU, bitwise padding invariance, and the no-GPU named error.

Tolerances: trajectories rtol=2e-5, atol=2e-6 in float32 and rtol=1e-11,
atol=1e-13 in float64, for draws inside |z| < 3.3 (asserted; beyond, XLA's
CPU float64 normal wobbles by up to 6e-11 relative, see
tests/test_torch_prng.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config
from repro import checkpoint as jax_ckpt
from repro.core import sde as jax_sde
from repro_torch import NoCudaDeviceError
from repro_torch import checkpoint as ckpt
from repro_torch.core import sde
from repro_torch.kernels import prng
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.steps import make_sample_step
from repro_torch.serving import (PAD_SEED, ServingNotPortedError, _request_keys,
                                 restore_for_serving, serve_buckets, serve_sde,
                                 synthetic_requests)

TRAJ_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
WIDTHS = dict(data_dim=2, hidden_dim=5, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=8, t1=1.0)


def _jax_keys(seed, n):
    return jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(seed), j))(jnp.arange(n))


def _max_draw(keys, cfg):
    """Largest |z| among the decode's standard-normal draws (ζ input and ΔW)."""
    kk = prng.split(keys)
    kv, kw = kk[:, 0], kk[:, 1]
    v = prng.normal(kv[:, 0], kv[:, 1], cfg.initial_noise_dim, cfg.dtype)
    z = [prng.normal_like(*prng.fold_in(kw[:, 0], kw[:, 1], n), (cfg.hidden_dim,), cfg.dtype)
         for n in range(cfg.num_steps)]
    return max(v.abs().max().item(), torch.stack(z).abs().max().item())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sample_paths_match_jax(dtype, fused):
    with jax_config(x64=dtype == "float64"):
        jcfg = jax_sde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=fused,
                                       dtype=jnp.dtype(dtype))
        jparams = jax_sde.latent_sde_init(jax.random.PRNGKey(40), jcfg)
        jkeys = _jax_keys(43, 6)
        want = np.array(jax.jit(lambda p, k: jax_sde.latent_sde_sample_paths(p, jcfg, k))(
            jparams, jkeys))
        params = ckpt.params_from_jax(jax.device_get(jparams))
        keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    cfg = sde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=fused, dtype=TORCH_DTYPES[dtype])
    assert _max_draw(keys, cfg) < 3.3  # inside the float64 bound's range (docstring)
    got = sde.latent_sde_sample_paths(params, cfg, keys)
    assert got.shape == (9, 6, 2) and got.dtype == TORCH_DTYPES[dtype]
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


def test_jax_written_bundle_is_read_by_the_port(tmp_path):
    with jax_config():
        jcfg = jax_sde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=True)
        jparams = jax_sde.latent_sde_init(jax.random.PRNGKey(42), jcfg)
        jax_ckpt.save_serving_bundle(tmp_path, 3, jparams, "latent-sde", jcfg)
        want = jax.device_get(jparams)
    params, cfg, step = restore_for_serving("latent-sde", tmp_path, "cpu")
    assert step == 3
    assert cfg == sde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=True)
    for net in ("zeta", "mu", "sigma", "nu", "qz0"):
        for got_l, want_l in zip(params[net]["layers"], want[net]["layers"]):
            assert np.array_equal(got_l["w"].numpy(), want_l["w"])
            assert np.array_equal(got_l["b"].numpy(), want_l["b"])
    assert np.array_equal(params["enc"]["h0"].numpy(), want["enc"]["h0"])
    stats = serve_sde("latent-sde", tmp_path, max_batch=4, requests=3, request_max=4,
                      device="cpu")
    assert stats["trajectories"] == sum(r.size for r in synthetic_requests(3, 4, 0))


def test_port_written_bundle_is_read_by_jax(tmp_path):
    from repro.serving.registry import load_model

    cfg = sde.LatentSDEConfig(**WIDTHS)
    params = sde.latent_sde_init(torch.Generator().manual_seed(43), cfg)
    ckpt.save_serving_bundle(tmp_path, 0, params, "latent-sde", cfg)
    with jax_config():
        loaded = jax.tree.map(np.asarray, load_model(tmp_path).params)
        assert loaded_cfg_equal(load_model(tmp_path).cfg, cfg)
    assert np.array_equal(loaded["mu"]["layers"][1]["w"], params["mu"]["layers"][1]["w"].numpy())
    assert np.array_equal(loaded["ell"]["b"], params["ell"]["b"].numpy())


def loaded_cfg_equal(jcfg, cfg) -> bool:
    j = dataclasses.asdict(jcfg)
    t = dataclasses.asdict(cfg)
    return ({k: v for k, v in j.items() if k != "dtype"}
            == {k: v for k, v in t.items() if k != "dtype"}
            and np.dtype(j["dtype"]).name == str(t["dtype"]).removeprefix("torch."))


@pytest.mark.parametrize("pallas", [False, True])
def test_serve_sde_on_cpu_answers_every_request(pallas):
    stats = serve_sde("latent-sde", max_batch=8, requests=5, request_max=6, seed=1,
                      device="cpu", sde_steps=4, pallas=pallas, collect=True)
    reqs = synthetic_requests(5, 6, 1)
    assert stats["trajectories"] == sum(r.size for r in reqs)
    assert stats["buckets"] == [1, 2, 4, 8] and stats["device"] == "cpu"
    for r in reqs:
        ys = stats["samples"][r.rid]
        assert ys.shape == (5, r.size, 2) and torch.isfinite(ys).all()
    assert stats["p50_s"] <= stats["p99_s"]


def test_padding_invariance_bitwise():
    """A request's rows served solo equal the same rows served coalesced,
    whatever the bucket and the position in it."""
    cfg = sde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=True)
    params = sde.latent_sde_init(torch.Generator().manual_seed(44), cfg)
    sampler = make_sample_step("latent-sde", cfg, device="cpu")
    reqs = list(synthetic_requests(4, 3, 2))
    coalesced = sampler(params, _request_keys(reqs, 16, "cpu"))
    buckets = serve_buckets(16)
    row = 0
    for r in reqs:
        bucket = next(b for b in buckets if b >= r.size)
        solo = sampler(params, _request_keys([r], bucket, "cpu"))
        assert torch.equal(solo[:, :r.size], coalesced[:, row:row + r.size])
        row += r.size


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sde.LatentSDEConfig(**WIDTHS)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        serve_sde("latent-sde", requests=1, request_max=1)
    with pytest.raises(NoCudaDeviceError):
        make_sample_step("latent-sde", cfg)
    with pytest.raises(NoCudaDeviceError):
        serve_cli.main(["--workload", "latent-sde", "--requests", "1"])


def test_unported_workloads_and_modes_raise_named_errors():
    with pytest.raises(ServingNotPortedError, match="ROADMAP"):
        serve_sde("sde-gan", device="cpu")
    with pytest.raises(ServingNotPortedError, match="posterior"):
        serve_sde("latent-sde", latent_mode="posterior", device="cpu")
    with pytest.raises(ServingNotPortedError, match="ROADMAP"):
        make_sample_step("sde-gan", None, device="cpu")
    with pytest.raises(ServingNotPortedError, match="ROADMAP"):
        serve_cli.main(["--workload", "lm"])


def _request_keys_per_request(requests, pad_to):
    """The previous derivation: one fold_in per request on the host."""
    parts = []
    for r in requests:
        k = prng.PRNGKey(r.seed)
        parts.append(torch.stack(prng.fold_in(k[0], k[1], torch.arange(r.size)), -1))
    used = sum(r.size for r in requests)
    if pad_to > used:
        k = prng.PRNGKey(PAD_SEED)
        parts.append(torch.stack(prng.fold_in(k[0], k[1], torch.arange(pad_to - used)), -1))
    return torch.cat(parts)


@pytest.mark.parametrize("n,pad_to", [(0, 4), (1, 1), (3, 16), (9, 32), (9, 8)])
def test_batched_request_keys_equal_per_request_derivation(n, pad_to):
    """One batched fold_in over all rows gives the per-request keys bitwise,
    over mixed request sizes, with and without padding rows."""
    reqs = list(synthetic_requests(9, 5, 3))[:n]
    want = _request_keys_per_request(reqs, pad_to)
    got = _request_keys(reqs, pad_to, "cpu")
    assert got.dtype == torch.int64 and got.is_contiguous()
    assert torch.equal(got, want)
