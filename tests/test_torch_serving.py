"""The port's serving path against the JAX package, on the CPU: the
Latent-SDE prior decode and the SDE-GAN generator's rollout with weights
carried over by params_from_jax, serving bundles read across packages,
serve_sde on the CPU (fixed grid and adaptive terminal sampling), the
deadline classes and tolerance routing, bitwise padding invariance, and
the no-GPU named error.  (The adaptive samplers' numbers against the
reference are in tests/test_torch_adaptive.py.)

Tolerances: trajectories rtol=2e-5, atol=2e-6 in float32 and rtol=1e-11,
atol=1e-13 in float64, for draws inside |z| < 3.3 (asserted; beyond, XLA's
CPU float64 normal wobbles by up to 6e-11 relative, see
tests/test_torch_prng.py).
"""

import math

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
from repro_torch.launch.steps import make_adaptive_terminal_step
from repro_torch.serving import (DEADLINE_CLASSES, PAD_SEED,
                                 Request, _request_keys, deadline_class_for, restore_for_serving,
                                 route_rtol, serve_buckets, serve_sde, synthetic_requests)
from repro.serving import types as jax_types

TRAJ_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
WIDTHS = dict(data_dim=2, hidden_dim=5, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=8, t1=1.0)
GAN_WIDTHS = dict(data_dim=1, hidden_dim=5, noise_dim=3, initial_noise_dim=2, width=8,
                  depth=1, num_steps=8, t1=1.0)


def gan_params(dtype, seed=50, sigma_scale=0.2):
    """Generator weights from a numpy seed, in the reference's tree; the
    diffusion's last layer scaled by ``sigma_scale`` keeps the adaptive
    solves a few dozen steps long."""
    rng = np.random.default_rng(seed)

    def net(sizes, scale=1.0):
        return {"layers": [{"w": (scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    h, w, n = GAN_WIDTHS["hidden_dim"], GAN_WIDTHS["width"], GAN_WIDTHS["noise_dim"]
    sigma = net([1 + h, w, h * n])
    sigma["layers"][-1]["w"] *= sigma_scale
    return {"zeta": net([GAN_WIDTHS["initial_noise_dim"], w, h]), "mu": net([1 + h, w, h]),
            "sigma": sigma,
            "ell": {"w": (rng.standard_normal((h, 1)) / np.sqrt(h)).astype(dtype),
                    "b": np.zeros(1, dtype)}}


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
    """Every serving mode of the reference is ported, data-parallel serving
    too (tests/test_torch_distributed.py runs ``--host-devices 2``); its
    refusals are the reference's own (adaptive needs sde-gan and excludes
    streaming)."""
    with pytest.raises(ValueError, match="--adaptive serves terminal samples"):
        serve_sde("latent-sde", adaptive=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve_sde("sde-gan", adaptive=True, stream_chunks=4, device="cpu")
    with pytest.raises(ValueError, match="workload must be one of"):
        make_sample_step("gan", None, device="cpu")
    stats = serve_sde("latent-sde", latent_mode="posterior", obs_len=5, max_batch=2,
                      requests=2, request_max=2, sde_steps=4, device="cpu")
    assert stats["trajectories"] == sum(r.size for r in synthetic_requests(2, 2, 0))


def test_lm_workload_serves_on_the_cpu_and_defaults_to_the_card(capsys):
    """``--workload lm`` runs the dense LM's prefill + greedy decode (the
    smoke config, as the reference's CLI defaults); without a card and
    without ``--device cpu`` it stops with the named error."""
    tokens = serve_cli.main(["--workload", "lm", "--device", "cpu", "--arch",
                             "tinyllama-1.1b", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] tinyllama-1.1b: batch=4 prefill(32 tok)" in out
    assert "decode 3 steps @" in out and "tok/s" in out
    assert tokens.shape == (4, 4) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 256
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            serve_cli.main(["--workload", "lm"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generator_sample_paths_match_jax(dtype):
    params = gan_params(dtype)
    with jax_config(x64=dtype == "float64"):
        jcfg = jax_sde.NeuralSDEConfig(**GAN_WIDTHS, dtype=jnp.dtype(dtype))
        jkeys = _jax_keys(45, 5)
        want = np.array(jax.jit(lambda p, k: jax_sde.generator_sample_paths(p, jcfg, k))(
            params, jkeys))
        keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    cfg = sde.NeuralSDEConfig(**GAN_WIDTHS, dtype=TORCH_DTYPES[dtype])
    got = make_sample_step("sde-gan", cfg, device="cpu")(ckpt.params_from_jax(params), keys)
    assert got.shape == (9, 5, 1) and got.dtype == TORCH_DTYPES[dtype]
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generator_fields_match_jax_with_per_row_times(dtype):
    """``mlp(..., final_activation=tanh)`` over ``tcat(t, x)``: the port's
    fields take one time per row (the adaptive loop's), the reference's a
    scalar per vmapped row."""
    params = gan_params(dtype, seed=53)
    rng = np.random.default_rng(54)
    x = rng.standard_normal((4, GAN_WIDTHS["hidden_dim"])).astype(dtype)
    t = np.array([0.0, 0.3, 0.71, 1.0], dtype)
    cfg = sde.NeuralSDEConfig(**GAN_WIDTHS, dtype=TORCH_DTYPES[dtype])
    p = ckpt.params_from_jax(params)
    got = [f(cfg)(p, torch.from_numpy(t), torch.from_numpy(x))
           for f in (sde.gen_drift, sde.gen_diffusion)]
    with jax_config(x64=dtype == "float64"):
        jcfg = jax_sde.NeuralSDEConfig(**GAN_WIDTHS, dtype=jnp.dtype(dtype))
        want = [np.array(jax.jit(jax.vmap(lambda tt, xx, f=f: f(jcfg)(params, tt, xx)))(t, x))
                for f in (jax_sde.gen_drift, jax_sde.gen_diffusion)]
    assert got[1].shape == (4, GAN_WIDTHS["hidden_dim"], GAN_WIDTHS["noise_dim"])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(w), **TRAJ_TOL[dtype])


def test_sde_gan_samplers_padding_invariance_bitwise():
    """Both SDE-GAN samplers: a request's rows served in a bucket of 1 (or
    its own size) equal its rows inside a 16-row coalesced batch, bitwise —
    the adaptive one with a controller per row."""
    cfg = sde.NeuralSDEConfig(**GAN_WIDTHS)
    params = ckpt.params_from_jax(gan_params("float32", seed=51))
    reqs = list(synthetic_requests(3, 3, 4))
    paths = make_sample_step("sde-gan", cfg, device="cpu")
    terminal = make_adaptive_terminal_step(cfg, atol=1e-4, max_steps=64, device="cpu")
    coalesced = paths(params, _request_keys(reqs, 16, "cpu"))
    y16, conv16, _ = terminal(params, _request_keys(reqs, 16, "cpu"), 1e-2)
    row = 0
    for r in reqs:
        bucket = next(b for b in serve_buckets(16) if b >= r.size)
        keys = _request_keys([r], bucket, "cpu")
        assert torch.equal(paths(params, keys)[:, :r.size], coalesced[:, row:row + r.size])
        y, conv, _ = terminal(params, keys, 1e-2)
        assert torch.equal(y[:r.size], y16[row:row + r.size])
        assert torch.equal(conv[:r.size], conv16[row:row + r.size])
        row += r.size


def test_sde_gan_samplers_padding_invariance_at_1024_rows():
    """A one-row request in a bucket of 1 equals its row deep inside a
    1024-row bucket, bitwise, for both SDE-GAN samplers.  There the
    controller's PI factor runs in the CPU kernels' vector bodies (a small
    tensor reaches only their scalar tails), where torch.pow rounds
    differently: this guards the written-out ``core/solve.py:_pow`` (with
    torch.pow in its place the row takes 34 accepted steps, not 38).  The
    serving atol and the realtime class's rtol, with the diffusion
    unscaled, so the PI factor is seldom clipped."""
    cfg = sde.NeuralSDEConfig(**GAN_WIDTHS)
    params = ckpt.params_from_jax(gan_params("float32", seed=51, sigma_scale=1.0))
    others = list(synthetic_requests(20, 64, 7, adaptive=True))
    one = Request(rid=20, size=1, seed=424242, kind="terminal")
    row = sum(r.size for r in others)
    assert 256 < row < 1023
    big = _request_keys(others + [one], 1024, "cpu")
    small = _request_keys([one], 1, "cpu")
    paths = make_sample_step("sde-gan", cfg, device="cpu")
    assert torch.equal(paths(params, small)[:, 0], paths(params, big)[:, row])
    terminal = make_adaptive_terminal_step(cfg, atol=1e-6, max_steps=64, device="cpu")
    y1, c1, s1 = terminal(params, small, 1e-2)
    y2, c2, s2 = terminal(params, big, 1e-2)
    assert torch.equal(y1[0], y2[row]) and bool(c1[0]) and bool(c2[row])
    assert int(s1.num_accepted[0]) == int(s2.num_accepted[row])
    assert int(s1.num_rejected[0]) == int(s2.num_rejected[row])


def test_deadline_classes_and_rtol_routing_match_the_reference():
    assert [(c.name, c.max_deadline_ms, c.rtol) for c in DEADLINE_CLASSES] == [
        (c.name, c.max_deadline_ms, c.rtol) for c in jax_types.DEADLINE_CLASSES]
    for dl in (0.0, 50.0, 50.5, 250.0, 999.0, 1000.0, 5e3, math.inf):
        assert deadline_class_for(dl).name == jax_types.deadline_class_for(dl).name
    batches = [[Request(0, 1, 0, deadline_ms=40.0), Request(1, 2, 1, deadline_ms=900.0)],
               [Request(0, 1, 0, deadline_ms=40.0, rtol=1e-4)],
               [Request(0, 1, 0)], [Request(0, 1, 0, rtol=5e-3, deadline_ms=200.0)]]
    for batch in batches:
        jbatch = [jax_types.Request(r.rid, r.size, r.seed, rtol=r.rtol,
                                    deadline_ms=r.deadline_ms) for r in batch]
        assert route_rtol(batch) == jax_types.route_rtol(jbatch)
    with pytest.raises(ValueError, match="non-empty"):
        route_rtol([])
    for adaptive in (False, True):
        got = synthetic_requests(9, 5, 2, adaptive=adaptive)
        want = jax_types.synthetic_requests(9, 5, 2, adaptive=adaptive)
        assert [(r.rid, r.size, r.seed, r.deadline_ms, r.kind) for r in got] == [
            (r.rid, r.size, r.seed, r.deadline_ms, r.kind) for r in want]


def test_jax_written_sde_gan_bundle_is_served_by_the_port_cli(tmp_path, capsys):
    """A bundle the JAX package wrote serves through the port's CLI on the
    CPU: fixed-grid rollouts, then adaptive terminal samples routed through
    all four deadline classes (atol 1e-2 keeps the CPU run short)."""
    params = gan_params("float32", seed=52)
    with jax_config():
        jcfg = jax_sde.NeuralSDEConfig(**GAN_WIDTHS)
        jax_ckpt.save_serving_bundle(tmp_path, 5, params, "sde-gan", jcfg)
    restored, cfg, step = restore_for_serving("sde-gan", tmp_path, "cpu")
    assert step == 5 and cfg == sde.NeuralSDEConfig(**GAN_WIDTHS)
    assert np.array_equal(restored["sigma"]["layers"][1]["w"].numpy(),
                          params["sigma"]["layers"][1]["w"])
    common = ["--workload", "sde-gan", "--ckpt-dir", str(tmp_path), "--device", "cpu",
              "--max-batch", "4", "--requests", "4", "--request-max", "3"]
    stats = serve_cli.main(common)
    assert stats["trajectories"] == sum(r.size for r in synthetic_requests(4, 3, 0))
    stats = serve_cli.main(common + ["--adaptive", "--atol", "1e-2"])
    reqs = synthetic_requests(4, 3, 0, adaptive=True)
    assert stats["classes_served"] == [c.name for c in DEADLINE_CLASSES]
    assert stats["rtols_served"] == sorted(c.rtol for c in DEADLINE_CLASSES)
    assert stats["non_converged"] == 0
    assert sorted((r.rid, r.size, r.rtol) for r in stats["results"]) == sorted(
        (r.rid, r.size, route_rtol([r])) for r in reqs)
    assert all(b["iterations"] > 0 for b in stats["batch_log"])
    assert "class realtime" in capsys.readouterr().out


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
