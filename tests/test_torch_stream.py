"""The streamed SDE-GAN rollout and the Latent SDE's posterior decode, the
port against the JAX package on the CPU: ``generator_initial_state``,
``generator_rollout_chunk`` with a scalar and a per-row ``t_start`` (every
registered general-noise solver), the per-row grid's times against the
times the compiled reference's fields see, the stream loop's rows against
the reference's chunk programs, ``latent_sde_posterior_decode`` and the
posterior ``make_sample_step`` (observations drawn per row).

Tolerances: trajectories rtol=2e-5, atol=2e-6 in float32 and rtol=1e-11,
atol=1e-13 in float64 (the decode tolerances of tests/test_torch_serving.py;
XLA contracts the state updates into FMAs); the initial state within one
float32 ulp-scale atol of 2e-6 (XLA's normal transform, parity rule 2); the
per-row times bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config
from repro.core import sde as jax_sde
from repro.launch import steps as jax_steps
from repro_torch import checkpoint as ckpt
from repro_torch.core import sde
from repro_torch.core.solvers import RowGrid
from repro_torch.kernels import prng
from repro_torch.launch.steps import make_sample_step, make_stream_chunk_step
from repro_torch.serving import Request, serve_sde, synthetic_requests
from repro_torch.serving.service import _request_keys

TRAJ_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
GAN = dict(data_dim=1, hidden_dim=5, noise_dim=3, initial_noise_dim=2, width=8, depth=1,
           num_steps=24, t1=1.0)
LATENT = dict(data_dim=2, hidden_dim=5, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=16, t1=1.0)


def _gan(dtype, seed=70, **over):
    """The reference's generator at GAN (jax.random init), its config, and
    the port's copy."""
    widths = dict(GAN, **over)
    jcfg = jax_sde.NeuralSDEConfig(**widths, dtype=jnp.dtype(dtype))
    jparams = jax_sde.generator_init(jax.random.PRNGKey(seed), jcfg)
    cfg = sde.NeuralSDEConfig(**widths, dtype=TORCH_DTYPES[dtype])
    return jcfg, jparams, cfg, ckpt.params_from_jax(jax.device_get(jparams))


def _tk(jkeys):
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generator_initial_state_matches_jax(dtype):
    with jax_config(x64=dtype == "float64"):
        jcfg, jparams, cfg, params = _gan(dtype)
        jkeys = jax.random.split(jax.random.PRNGKey(3), 7)
        want = np.asarray(jax.jit(lambda p, k: jax_sde.generator_initial_state(p, jcfg, k))(
            jparams, jkeys))
    got = sde.generator_initial_state(params, cfg, _tk(jkeys))
    assert got.shape == (7, GAN["hidden_dim"])
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


@pytest.mark.parametrize("solver", ["reversible_heun", "midpoint", "heun", "euler_maruyama"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rollout_chunk_matches_jax_scalar_and_per_row(dtype, solver):
    """Chunks of a third of the horizon (spans and step sizes that round),
    rows at different chunk positions in one batch, and the scalar form."""
    span, n = 1.0 / 3, 8
    with jax_config(x64=dtype == "float64"):
        jcfg, jparams, cfg, params = _gan(dtype, solver=solver)
        jkeys = jax.random.split(jax.random.PRNGKey(4), 6)
        x0 = np.random.default_rng(5).standard_normal((6, GAN["hidden_dim"])).astype(dtype)
        ts = np.asarray([0.0, span, 2 * span, span, 0.0, 2 * span], dtype)
        chunk = jax.jit(lambda p, k, x, t: jax_sde.generator_rollout_chunk(
            p, jcfg, k, x, t, span, n))
        want_rows = [np.asarray(a) for a in chunk(jparams, jkeys, x0, ts)]
        want_scalar = [np.asarray(a) for a in chunk(jparams, jkeys, x0,
                                                    jnp.asarray(span, jnp.dtype(dtype)))]
    step = make_stream_chunk_step(cfg, span, n, device="cpu")
    got_rows = step(params, _tk(jkeys), torch.from_numpy(x0), torch.from_numpy(ts))
    got_scalar = step(params, _tk(jkeys), torch.from_numpy(x0), span)
    assert got_rows[0].shape == (n + 1, 6, 1) and got_rows[1].shape == (6, GAN["hidden_dim"])
    for got, want in zip(got_rows + got_scalar, want_rows + want_scalar):
        torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


def _recorded_times(monkeypatch, module, record):
    """Patch ``module.gen_drift`` so every evaluation's time lands in
    ``record`` (the reference's through ``jax.debug.callback``)."""
    orig = module.gen_drift

    def gen_drift(cfg):
        mu = orig(cfg)

        def f(p, t, x):
            if module is jax_sde:
                jax.debug.callback(lambda tt: record.append(np.asarray(tt).reshape(-1)), t)
            else:
                record.append(t.numpy().reshape(-1).copy())
            return mu(p, t, x)

        return f

    monkeypatch.setattr(module, "gen_drift", gen_drift)


@pytest.mark.parametrize("chunks,num_steps", [(3, 24), (5, 35)])
@pytest.mark.parametrize("solver", ["reversible_heun", "midpoint"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_row_grid_times_equal_the_reference_field_times(monkeypatch, dtype, solver, chunks,
                                                        num_steps):
    """The times every field evaluation sees, one row per chunk position,
    as multisets: bitwise the compiled reference's (XLA's reciprocal step
    size and ``fma(n, dt, t0)``, the model :class:`RowGrid` states)."""
    span, n = 1.0 / chunks, num_steps // chunks
    want, got = [], []
    with jax_config(x64=dtype == "float64"):
        jcfg, jparams, cfg, params = _gan(dtype, solver=solver, num_steps=num_steps)
        jkeys = jax.random.split(jax.random.PRNGKey(6), chunks)
        x0 = np.zeros((chunks, GAN["hidden_dim"]), dtype)
        ts = np.asarray([c * span for c in range(chunks)], dtype)
        _recorded_times(monkeypatch, jax_sde, want)
        jax.block_until_ready(jax.jit(lambda p, k, x, t: jax_sde.generator_rollout_chunk(
            p, jcfg, k, x, t, span, n))(jparams, jkeys, x0, ts))
    _recorded_times(monkeypatch, sde, got)
    sde.generator_rollout_chunk(params, cfg, _tk(jkeys), torch.from_numpy(x0),
                                torch.from_numpy(ts), span, n)
    want, got = np.sort(np.concatenate(want)), np.sort(np.concatenate(got))
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(got, want)


def test_row_grid_rejects_mismatched_times():
    with pytest.raises(ValueError, match=r"\(B,\) start and end times"):
        RowGrid(torch.zeros(3), torch.zeros(4), 8)


def test_stream_loop_rows_equal_the_reference_chunk_programs():
    """``serve_sde(stream_chunks=4)``: each request's chunks, concatenated,
    against the reference stream loop's arithmetic (its initial-state and
    chunk programs over the same keys, chunk keys ``fold_in(key, 1000 +
    c)``), and bitwise the scheduler's rollout of the same requests."""
    with jax_config():
        jcfg, jparams, cfg, params = _gan("float32", num_steps=8)
    reqs = list(synthetic_requests(3, 3, 5))
    stats = serve_sde("sde-gan", max_batch=4, requests=3, request_max=3, seed=5,
                      stream_chunks=4, device="cpu", sde_steps=8, collect=True)
    assert stats["trajectories"] == sum(r.size for r in reqs) and stats["first_chunk_ms"] > 0
    sched = serve_sde("sde-gan", max_batch=4, requests=3, request_max=3, seed=5,
                      scheduler="continuous", device="cpu", sde_steps=8, collect=True)
    fresh = sde.generator_init(torch.Generator().manual_seed(5), sde.NeuralSDEConfig(
        data_dim=1, hidden_dim=16, noise_dim=4, width=32, num_steps=8))
    span = 1.0 / 4
    with jax_config():
        jcfg = jax_sde.NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, width=32,
                                       num_steps=8)
        jp = jax.tree.map(lambda t: np.asarray(t.numpy()), fresh)
        chunk = jax.jit(jax_steps.make_stream_chunk_step(jcfg, span, 2))
        for r in reqs:
            keys = jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(r.seed), j))(
                jnp.arange(r.size))
            x = jax_sde.generator_initial_state(jp, jcfg, keys)
            want = []
            for c in range(4):
                ck = jax.vmap(lambda k, c=c: jax.random.fold_in(k, 1000 + c))(keys)
                ys, x = chunk(jp, ck, x, jnp.asarray(c * span, jnp.float32))
                want.append(np.asarray(ys if c == 0 else ys[1:]))
            got = stats["samples"][r.rid]
            assert got.shape == (9, r.size, 1)
            torch.testing.assert_close(got, torch.from_numpy(np.concatenate(want)),
                                       **TRAJ_TOL["float32"])
            assert torch.equal(got, sched["samples"][r.rid])


def test_stream_chunks_refusals():
    with pytest.raises(ValueError, match="streams the SDE-GAN"):
        serve_sde("latent-sde", stream_chunks=4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        serve_sde("sde-gan", stream_chunks=3, sde_steps=8, device="cpu")


def _latent(dtype, fused=False, seed=71):
    jcfg = jax_sde.LatentSDEConfig(**LATENT, use_pallas_kernels=fused, dtype=jnp.dtype(dtype))
    jparams = jax_sde.latent_sde_init(jax.random.PRNGKey(seed), jcfg)
    cfg = sde.LatentSDEConfig(**LATENT, use_pallas_kernels=fused, dtype=TORCH_DTYPES[dtype])
    return jcfg, jparams, cfg, ckpt.params_from_jax(jax.device_get(jparams))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_posterior_decode_matches_jax(dtype, fused):
    with jax_config(x64=dtype == "float64"):
        jcfg, jparams, cfg, params = _latent(dtype, fused)
        jkeys = jax.random.split(jax.random.PRNGKey(7), 5)
        y = np.random.default_rng(8).standard_normal((9, 5, 2)).astype(dtype)
        want = np.asarray(jax.jit(lambda p, k, yy: jax_sde.latent_sde_posterior_decode(
            p, jcfg, k, yy))(jparams, jkeys, y))
    got = sde.latent_sde_posterior_decode(params, cfg, _tk(jkeys), torch.from_numpy(y))
    assert got.shape == (LATENT["num_steps"] + 1, 5, 2)
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_posterior_sample_step_matches_jax(dtype):
    """The posterior sampler with its per-row observations
    ``air_quality_like(fold_in(key, 2), 1, obs_len)``."""
    with jax_config(x64=dtype == "float64"):
        jcfg, jparams, cfg, params = _latent(dtype)
        jkeys = jax.random.split(jax.random.PRNGKey(9), 6)
        want = np.asarray(jax.jit(jax_steps.make_sample_step(
            "latent-sde", jcfg, latent_mode="posterior", obs_len=9))(jparams, jkeys))
    got = make_sample_step("latent-sde", cfg, latent_mode="posterior", obs_len=9,
                           device="cpu")(params, _tk(jkeys))
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL[dtype])


def test_air_quality_rows_are_one_profile_per_key():
    """Column i of the batched draw is ``air_quality_like(keys[i], 1, n)``:
    labels (the bits) decide the profile, the floats within float32 ulps."""
    from repro_torch.data import air_quality_like, air_quality_rows

    keys = prng.fold_in_key(_request_keys([Request(rid=0, size=4, seed=3)], 5, "cpu"), 2)
    rows = air_quality_rows(keys, 9)
    for i in range(5):
        one, _ = air_quality_like(keys[i], 1, 9)
        torch.testing.assert_close(rows[:, i], one[:, 0], rtol=1e-6, atol=1e-6)


def test_posterior_padding_invariance_bitwise():
    cfg = sde.LatentSDEConfig(**LATENT, use_pallas_kernels=True)
    params = sde.latent_sde_init(torch.Generator().manual_seed(12), cfg)
    sampler = make_sample_step("latent-sde", cfg, latent_mode="posterior", obs_len=9,
                               device="cpu")
    reqs = list(synthetic_requests(3, 3, 2))
    coalesced = sampler(params, _request_keys(reqs, 8, "cpu"))
    row = 0
    for r in reqs:
        solo = sampler(params, _request_keys([r], r.size, "cpu"))
        assert torch.equal(solo, coalesced[:, row:row + r.size])
        row += r.size


def test_posterior_validation_is_eager():
    cfg = sde.LatentSDEConfig(**LATENT)
    with pytest.raises(ValueError, match="obs_len >= 2"):
        make_sample_step("latent-sde", cfg, latent_mode="posterior", obs_len=1, device="cpu")
    with pytest.raises(ValueError, match="misaligned"):
        make_sample_step("latent-sde", cfg, latent_mode="posterior", obs_len=4, device="cpu")
