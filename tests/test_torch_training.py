"""The Latent-SDE ELBO training slice of the port against the JAX package,
on the CPU: the data generator, the encoder GRU, the ELBO (trajectory and
terminal forms), one ``make_latent_sde_step`` (loss, metrics, gradients,
updated parameters) and the train CLI.  Weights come from the JAX tree
through ``params_from_jax``.

Tolerances, with their reasons:
* bits: ``randint`` labels and the data's labels are bitwise.
* data floats: float32 rtol=1e-5, atol=2e-6; float64 rtol=1e-12, atol=1e-13 —
  ``sin``/``exp`` and the normal transform differ from XLA's by ulps.
* GRU: float32 rtol=1e-5, atol=1e-6; float64 rtol=1e-13, atol=1e-14 (XLA's
  FMA contraction and its sigmoid/tanh).
* ELBO, metrics and gradients: float32 rtol=1e-4, atol=1e-5; float64
  rtol=1e-9, atol=1e-12 — per-ulp field differences carried through 23
  steps forward and back and a 24-step GRU.
* updated parameters: atol = ``lr``·1e-2 in float32 and ``lr``·1e-6 in
  float64 (rtol 1e-6 / 1e-12 on top).  Adam's first step moves each entry by
  about ``lr·g/(|g|+eps)``, which magnifies the difference of an entry near
  ``eps``, and it rounds the update to float32 even for float64 parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, torch_keys
from repro import optim as joptim
from repro.core import sde as jsde
from repro.data.synthetic import air_quality_like as jax_air_quality_like
from repro.launch.steps import make_latent_sde_step as jax_make_latent_sde_step
from repro.nn.core import gru_init as jax_gru_init
from repro.nn.core import gru_scan as jax_gru_scan
from repro_torch import NoCudaDeviceError, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import sde as tsde
from repro_torch.data import air_quality_like
from repro_torch.kernels import prng
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_latent_sde_optimizer, make_latent_sde_step
from repro_torch.nn import gru_scan
from repro_torch.serving import restore_for_serving

DATA_TOL = {"float32": dict(rtol=1e-5, atol=2e-6), "float64": dict(rtol=1e-12, atol=1e-13)}
GRU_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-13, atol=1e-14)}
ELBO_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
LR = 1e-2
PARAM_TOL = {"float32": dict(rtol=1e-6, atol=LR * 1e-2),
             "float64": dict(rtol=1e-12, atol=LR * 1e-6)}
# Narrow widths; the air-quality grid (24 observations, 23 steps).
WIDTHS = dict(data_dim=2, hidden_dim=4, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=23, kl_weight=0.1)
BATCH, SEQ_LEN = 4, 24


def _close(got, want, tol):
    torch.testing.assert_close(torch.as_tensor(got), torch.from_numpy(np.array(want)), **tol)


def _jax_key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("dtype,lo,hi,n", [
    (torch.int32, 0, 12, 64), (torch.int32, -5, 1000, 33), (torch.int32, 0, 2 ** 31 - 1, 17),
    (torch.int32, 4, 4, 3), (torch.int64, 0, 12, 64), (torch.int64, 0, 2 ** 40 + 7, 17)])
def test_randint_bitwise(dtype, lo, hi, n):
    with jax_config(x64=dtype == torch.int64):
        key = jax.random.PRNGKey(hi % 97 + n)
        want = np.asarray(jax.random.randint(key, (n,), lo, hi))
    got = prng.randint(torch_keys(np.asarray(key)), n, lo, hi, dtype)
    assert got.dtype == dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_air_quality_like_matches_jax(dtype):
    with jax_config(x64=dtype == "float64"):
        key = jax.random.PRNGKey(60)
        ys, labels = jax_air_quality_like(key, 8, SEQ_LEN, dtype=jnp.dtype(dtype))
        ys, labels, key = map(np.asarray, (ys, labels, key))
    got_ys, got_labels = air_quality_like(torch_keys(key), 8, SEQ_LEN,
                                          dtype=TORCH_DTYPES[dtype])
    assert np.array_equal(got_labels.numpy(), labels)
    assert got_ys.shape == (SEQ_LEN, 8, 2)
    _close(got_ys, ys, DATA_TOL[dtype])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gru_scan_matches_jax(dtype, reverse):
    xs = np.random.default_rng(61).standard_normal((7, 3, 2)).astype(dtype)
    with jax_config(x64=dtype == "float64"):
        params = jax.device_get(jax_gru_init(jax.random.PRNGKey(62), 2, 5,
                                             dtype=jnp.dtype(dtype)))
        params["h0"] = np.linspace(-0.5, 0.5, 5).astype(dtype)  # a nonzero start
        want = jax.jit(lambda p, x: jax_gru_scan(p, x, reverse=reverse))(params, xs)
    got = gru_scan(params_from_jax(params), torch.from_numpy(xs), reverse=reverse)
    assert got.shape == (7, 3, 5)
    _close(got, want, GRU_TOL[dtype])


def _problem(dtype, fused=False):
    """JAX params and config, the port's counterparts, and a numpy batch."""
    with jax_config(x64=dtype == "float64"):
        jcfg = jsde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=fused,
                                    dtype=jnp.dtype(dtype))
        params = jax.device_get(jsde.latent_sde_init(jax.random.PRNGKey(63), jcfg))
    tcfg = tsde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=fused,
                                dtype=TORCH_DTYPES[dtype])
    y = np.random.default_rng(64).standard_normal((SEQ_LEN, BATCH, 2)).astype(dtype)
    return jcfg, tcfg, params, y


def _torch_loss_and_grads(loss_fn, params, tcfg, key, y):
    leaves, spec = tree.flatten(params_from_jax(params))
    leaves = [x.requires_grad_() for x in leaves]
    loss, parts = loss_fn(tree.unflatten(spec, leaves), tcfg, torch_keys(key),
                          torch.from_numpy(y))
    return loss, parts, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("terminal", [False, True], ids=["trajectory", "terminal"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_latent_sde_loss_metrics_and_grads_match_jax(dtype, terminal):
    jcfg, tcfg, params, y = _problem(dtype)
    jax_fn = jsde.latent_sde_loss_terminal if terminal else jsde.latent_sde_loss
    with jax_config(x64=dtype == "float64"):
        key = _jax_key(65)
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_fn(p, jcfg, key, y), has_aux=True))(params)
        want_grads = [np.asarray(g) for g in jax.tree.leaves(grads)]
    torch_fn = tsde.latent_sde_loss_terminal if terminal else tsde.latent_sde_loss
    got, got_parts, got_grads = _torch_loss_and_grads(torch_fn, params, tcfg, key, y)
    _close(got.detach(), loss, ELBO_TOL[dtype])
    assert sorted(got_parts) == sorted(parts) == ["kl_path", "kl_v", "recon"]
    for name in parts:
        _close(got_parts[name].detach(), parts[name], ELBO_TOL[dtype])
    assert len(got_grads) == len(want_grads)
    for g, w in zip(got_grads, want_grads):
        _close(g, w, ELBO_TOL[dtype])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_latent_sde_step_matches_jax_step(dtype, fused):
    jcfg, tcfg, params, _ = _problem(dtype, fused)
    with jax_config(x64=dtype == "float64"):
        ji, ju = joptim.adam(LR)
        step = jax.jit(jax_make_latent_sde_step(jcfg, ju, BATCH, SEQ_LEN))
        key = jax.random.PRNGKey(66)
        new_params, _, metrics = step(params, ji(params), key)
        new_params, metrics, key = jax.device_get((new_params, metrics, np.asarray(key)))
    init, update = make_latent_sde_optimizer(LR)
    tparams = params_from_jax(params)
    got_params, state, got_metrics = make_latent_sde_step(tcfg, update, BATCH, SEQ_LEN,
                                                          device="cpu")(
        tparams, init(tparams), torch_keys(key))
    assert state.step == 1
    assert sorted(got_metrics) == sorted(metrics)
    for name in metrics:
        _close(got_metrics[name], metrics[name], ELBO_TOL[dtype])
    for g, w in zip(tree.leaves(got_params), jax.tree.leaves(new_params)):
        assert g.dtype == TORCH_DTYPES[dtype] and not g.requires_grad
        _close(g, w, PARAM_TOL[dtype])


def test_fused_step_equals_unfused_step_bitwise():
    """In-port identity on the whole training step, float64."""
    _, tcfg, params, _ = _problem("float64")
    init, update = make_latent_sde_optimizer(LR)
    runs = []
    for fused in (False, True):
        cfg = tsde.LatentSDEConfig(**WIDTHS, use_pallas_kernels=fused, dtype=torch.float64)
        p = params_from_jax(params)
        runs.append(make_latent_sde_step(cfg, update, BATCH, SEQ_LEN, device="cpu")(
            p, init(p), prng.PRNGKey(67)))
    for a, b in zip(tree.leaves(runs[0][0]), tree.leaves(runs[1][0])):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][2]["loss"], runs[1][2]["loss"])


@pytest.mark.parametrize("kw,err,match", [
    (dict(num_steps=30), ValueError, "misaligned"),
    (dict(data_dim=1), ValueError, "data_dim must be 2"),
    (dict(adjoint="backsolve"), ValueError, "continuous-adjoint backward integrator"),
    (dict(adjoint="checkpoint", use_pallas_kernels=True), ValueError, "checkpointing"),
    (dict(adjoint="bogus"), ValueError, "adjoint must be"),
    (dict(use_pallas_kernels=True, exact_adjoint=False), ValueError, "exact_adjoint=True"),
    (dict(seq_len=1), ValueError, "seq_len must be"),
])
def test_step_builder_validates_eagerly(kw, err, match):
    adjoint = kw.pop("adjoint", "exact")
    seq_len = kw.pop("seq_len", SEQ_LEN)
    cfg = tsde.LatentSDEConfig(**{**WIDTHS, **kw})
    with pytest.raises(err, match=match):
        make_latent_sde_step(cfg, make_latent_sde_optimizer()[1], BATCH, seq_len,
                             adjoint=adjoint, device="cpu")


def test_train_cli_on_cpu_writes_a_servable_bundle(tmp_path, capsys):
    losses = train_cli.main(["--workload", "latent-sde", "--device", "cpu", "--steps", "2",
                             "--batch", "4", "--pallas", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: first -ELBO" in capsys.readouterr().out
    params, cfg, step = restore_for_serving("latent-sde", tmp_path, "cpu")
    assert step == 2 and cfg.use_pallas_kernels and cfg.num_steps == 23
    assert params["nu"]["layers"][0]["w"].shape == (1 + 16 + 16, 32)


def test_train_cli_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        train_cli.main(["--workload", "latent-sde", "--steps", "1"])
