"""The port's other gradient backends and the precision policy against the
JAX package on the CPU: the continuous adjoint (eq. (6) backsolve) against
the reference's ``continuous_adjoint_solve``; recursive checkpointing
against the port's discretise-then-optimise, on the fixed grid (powers of
two and not) and on an adaptive solve's frozen grid, its schedule against
the reference's; ``precision="bf16_compute"`` under every gradient mode;
one ``make_latent_sde_step`` for each of ``adjoint="backsolve"`` and
``"checkpoint"`` and one SDE-GAN gradient-penalty step with midpoint
against the JAX steps; the train CLI's baseline flags; and the launch
counts of every new path, the card's routing replaced by counted plain
launches (chip_smoke.py asserts the same formulas on the card).

Tolerances, with their reasons:
* continuous adjoint vs the reference: float32 rtol 1e-4, atol 1e-5;
  float64 rtol 1e-9, atol 1e-12 (per-ulp field differences carried through
  the solve forward and the backsolve; the adds keep the reference's
  order).
* checkpoint vs discretise inside the port: ≤1e-12 relative L1 in float64
  (the same discrete steps, recomputed: the paper's "exact to floating
  point"), the value bitwise.
* bf16_compute: its gradients' shift from "highest" inside
  ``BF16_SHIFT_BOUNDS = (1e-6, 0.2)`` (benchmarks/gradient_error.py: above
  zero, so the cast happened; far below O(1), so accumulation stayed in the
  state dtype); against the reference's bf16 gradients ≤ 2e-2 relative L1
  (both evaluate the fields in bfloat16, but XLA and PyTorch round the
  matmuls' sums differently: a few bf16 ulps a field).
* steps: tests/test_torch_training.py's and tests/test_torch_gan_train.py's.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys
from repro import optim as joptim
from repro.core import sde as jsde
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.core.gradients import checkpoint_schedule as jax_checkpoint_schedule
from repro.launch.steps import make_gan_optimizers as jax_make_gan_optimizers
from repro.launch.steps import make_latent_sde_step as jax_make_latent_sde_step
from repro.launch.steps import make_sde_gan_step as jax_make_sde_gan_step
from repro.nn.core import mlp as jax_mlp
from repro.nn.core import tcat as jax_tcat
from repro_torch import tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import BrownianPath
from repro_torch.core import sde as tsde
from repro_torch.core import solvers as tsolvers
from repro_torch.core.gradients import checkpoint_schedule
from repro_torch.core.solve import solve, solve_adaptive
from repro_torch.kernels import brownian as bk
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import ops, prng, ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_cli
from repro_torch.nn import core as nn_core
from repro_torch.nn import mlp, tcat

jsolve = importlib.import_module("repro.core.solve")  # the package exports solve()

DTYPES = ["float32", "float64"]
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
EXACT_RTOL = 1e-12
BF16_SHIFT_BOUNDS = (1e-6, 0.2)   # benchmarks/gradient_error.py:194
BF16_VS_JAX = 2e-2
D, W, WDIM, STEPS = 4, 8, 3, 8
BASELINES = ["euler_maruyama", "midpoint", "heun"]


def _params(dtype, noise="diagonal", seed=50):
    rng = np.random.default_rng(seed)

    def net(sizes):
        return {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    out = D if noise == "diagonal" else D * WDIM
    return {"mu": net([1 + D, W, D]), "sigma": net([1 + D, W, out])}


def _jax_fields(noise="diagonal"):
    drift = lambda p, t, z: jax_mlp(p["mu"], jax_tcat(t, z), final_activation=jnp.tanh)

    def diffusion(p, t, z):
        s = 0.3 * jax.nn.sigmoid(jax_mlp(p["sigma"], jax_tcat(t, z)))
        return s if noise == "diagonal" else s.reshape(z.shape[:-1] + (D, WDIM))

    return drift, diffusion


def _torch_fields(noise="diagonal"):
    drift = lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh)

    def diffusion(p, t, z):
        s = 0.3 * torch.sigmoid(mlp(p["sigma"], tcat(t, z)))
        return s if noise == "diagonal" else s.reshape(z.shape[:-1] + (D, WDIM))

    return drift, diffusion


def _problem(dtype, noise="diagonal", batch=3, seed=51):
    params = _params(dtype, noise)
    z0 = np.random.default_rng(seed).standard_normal((batch, D)).astype(dtype)
    words = key_words(seed + 1, 1)[0]
    shape = (batch, D if noise == "diagonal" else WDIM)
    return params, z0, words, shape


def _port_grads(params, z0, words, shape, dtype, n=STEPS, noise="diagonal", **kw):
    """``(z_T, [d/dθ, d/dz0] of Σ z_T²)`` through the port's solve."""
    leaves, spec = tree.flatten(params_from_jax(params))
    leaves = [x.requires_grad_() for x in leaves]
    z = torch.from_numpy(z0).requires_grad_()
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, shape, TORCH_DTYPES[dtype])
    zT = solve(*_torch_fields(noise), tree.unflatten(spec, leaves), z, bm, 0.0, 1.0, n,
               noise=noise, save_trajectory=False, **kw)
    return zT.detach(), torch.autograd.grad((zT * zT).sum(), leaves + [z])


def _rel_l1(got, want) -> float:
    num = sum((a - b).abs().sum().item() for a, b in zip(got, want))
    return num / sum(b.abs().sum().item() for b in want)


# -----------------------------------------------------------------------------
# the continuous adjoint
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,solver,noise", [("float64", s, "diagonal") for s in BASELINES]
                         + [("float32", "midpoint", "general")])
def test_continuous_adjoint_matches_jax(dtype, solver, noise):
    params, z0, words, shape = _problem(dtype, noise)
    with jax_config(x64=dtype == "float64"):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, shape, jnp.dtype(dtype))

        def loss(p, z):
            zT = jsolve.solve(*_jax_fields(noise), p, z, jbm, 0.0, 1.0, STEPS, solver=solver,
                              gradient_mode="continuous_adjoint", noise=noise,
                              save_trajectory=False)
            return jnp.sum(zT ** 2)

        want = jax.device_get(jax.jit(jax.grad(loss, argnums=(0, 1)))(params, z0))
    _, got = _port_grads(params, z0, words, shape, dtype, solver=solver, noise=noise,
                         gradient_mode="continuous_adjoint")
    want = jax.tree.leaves(want[0]) + [want[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **GRAD_TOL[dtype])


def test_continuous_adjoint_error_shrinks_with_the_step():
    """The baseline's O(√h) gradient error against discretise: it falls as N
    grows (the measured baseline, not an exact gradient)."""
    params, z0, words, shape = _problem("float64")
    errs = []
    for n in (4, 32):
        _, dto = _port_grads(params, z0, words, shape, "float64", n=n, solver="midpoint")
        _, otd = _port_grads(params, z0, words, shape, "float64", n=n, solver="midpoint",
                             gradient_mode="continuous_adjoint")
        errs.append(_rel_l1(otd, dto))
    assert 0 < errs[1] < errs[0]


# -----------------------------------------------------------------------------
# checkpointing
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [7, 16])
@pytest.mark.parametrize("solver", BASELINES + ["reversible_heun"])
def test_checkpoint_equals_discretise(solver, n):
    params, z0, words, shape = _problem("float64")
    z_dto, dto = _port_grads(params, z0, words, shape, "float64", n=n, solver=solver)
    z_ck, ck = _port_grads(params, z0, words, shape, "float64", n=n, solver=solver,
                           gradient_mode="checkpoint")
    assert torch.equal(z_ck, z_dto)
    assert _rel_l1(ck, dto) <= EXACT_RTOL


def test_checkpoint_general_noise_equals_discretise():
    params, z0, words, shape = _problem("float64", "general")
    z_dto, dto = _port_grads(params, z0, words, shape, "float64", n=11, solver="heun",
                             noise="general")
    z_ck, ck = _port_grads(params, z0, words, shape, "float64", n=11, solver="heun",
                           noise="general", gradient_mode="checkpoint")
    assert torch.equal(z_ck, z_dto) and _rel_l1(ck, dto) <= EXACT_RTOL


def test_checkpoint_schedule_is_the_references():
    for n in range(1, 1101):
        assert checkpoint_schedule(n) == jax_checkpoint_schedule(n), n
    with pytest.raises(ValueError, match="num_steps"):
        checkpoint_schedule(0)


def _replay(solver, params, z0, bm, stats, depth):
    """Autograd through the accepted steps with the grid held fixed (the
    oracle of the frozen-grid replay)."""
    step = tsolvers.BASELINE_STEPPERS.get(solver, tsolvers.reversible_heun_step)
    carry = tsolvers.carry_init(step, *_torch_fields(), params, z0, 0.0)
    for i in range(int(stats.num_accepted)):
        t, dt = stats.ts[i], stats.dts[i]
        dw = bm.value(t + dt, depth=depth) - bm.value(t, depth=depth)
        kw = {} if tsolvers.is_reversible(step) else {"tm": t + 0.5 * dt}
        carry = step(carry, t, dt, dw, *_torch_fields(), params, "diagonal", t1=t + dt, **kw)
    return tsolvers.carry_z(carry)


@pytest.mark.parametrize("solver", ["midpoint", "reversible_heun"])
def test_checkpoint_adaptive_replays_the_frozen_grid(solver):
    params, z0, words, shape = _problem("float64", batch=4)
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, shape, torch.float64)
    kw = dict(solver=solver, rtol=3e-2, atol=1e-4, max_steps=256, dt0=1 / 8,
              bridge_depth=10)
    with torch.no_grad():
        want_z, stats = solve_adaptive(*_torch_fields(), params_from_jax(params),
                                       torch.from_numpy(z0), bm, 0.0, 1.0, **kw)
    grads = {}
    for mode in ("checkpoint", "oracle") + (("reversible_adjoint",)
                                            if solver == "reversible_heun" else ()):
        leaves, spec = tree.flatten(params_from_jax(params))
        leaves = [x.requires_grad_() for x in leaves]
        p = tree.unflatten(spec, leaves)
        if mode == "oracle":
            zT = _replay(solver, p, torch.from_numpy(z0), bm, stats, 10)
        else:
            zT = solve(*_torch_fields(), p, torch.from_numpy(z0), bm, 0.0, 1.0, 8,
                       gradient_mode=mode, save_trajectory=False, adaptive=True,
                       **{k: v for k, v in kw.items() if k != "dt0"}, dt0=1 / 8)
        assert torch.equal(zT.detach(), want_z), mode
        grads[mode] = torch.autograd.grad((zT * zT).sum(), leaves)
    for mode, g in grads.items():
        assert _rel_l1(g, grads["oracle"]) <= EXACT_RTOL, mode


@pytest.mark.parametrize("kw,match", [
    (dict(save_trajectory=True), "terminal-value cotangent"),
    (dict(solver="reversible_heun", use_pallas_kernels=True), "incompatible"),
])
def test_checkpoint_validates_eagerly(kw, match):
    params, z0, words, shape = _problem("float32")
    args = dict(gradient_mode="checkpoint", save_trajectory=False, solver="midpoint")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        solve(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0),
              BrownianPath(torch_keys(words), 0.0, 1.0, shape), 0.0, 1.0, 4, **args)


@pytest.mark.parametrize("kw,match", [
    (dict(solver="reversible_heun"), "does not support"),
    (dict(save_trajectory=True), "terminal-value cotangent"),
    (dict(adaptive=True), "incompatible"),
])
def test_continuous_adjoint_validates_eagerly(kw, match):
    params, z0, words, shape = _problem("float32")
    args = dict(gradient_mode="continuous_adjoint", save_trajectory=False, solver="heun")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        solve(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0),
              BrownianPath(torch_keys(words), 0.0, 1.0, shape), 0.0, 1.0, 4, **args)


# -----------------------------------------------------------------------------
# the precision policy
# -----------------------------------------------------------------------------


def test_wrap_vector_field_casts_the_evaluation_only():
    seen = {}

    def field(p, t, z):
        seen.update(p=p["w"].dtype, ints=p["n"].dtype, z=z.dtype, t=type(t))
        return z * p["w"]

    w = torch.tensor([1.5, 2.0], dtype=torch.float32, requires_grad=True)
    z = torch.tensor([0.3, -0.7], dtype=torch.float32, requires_grad=True)
    out = ops.wrap_vector_field(field, torch.bfloat16)(
        {"w": w, "n": torch.tensor([3])}, np.float32(0.5), z)
    assert out.dtype == torch.float32 and seen == dict(
        p=torch.bfloat16, ints=torch.int64, z=torch.bfloat16, t=np.float32)
    gw, gz = torch.autograd.grad(out.sum(), [w, z])
    assert gw.dtype == gz.dtype == torch.float32


@pytest.mark.parametrize("mode,solver", [("discretise", "heun"),
                                         ("continuous_adjoint", "midpoint"),
                                         ("checkpoint", "heun"),
                                         ("reversible_adjoint", "reversible_heun")])
def test_bf16_compute_shifts_gradients_within_bounds(mode, solver):
    params, z0, words, shape = _problem("float64", "general", batch=8)
    kw = dict(solver=solver, noise="general", gradient_mode=mode, n=16)
    z_hi, hi = _port_grads(params, z0, words, shape, "float64", **kw)
    z_lo, lo = _port_grads(params, z0, words, shape, "float64", precision="bf16_compute",
                           **kw)
    assert z_lo.dtype == torch.float64 and all(g.dtype == torch.float64 for g in lo)
    lo_bound, hi_bound = BF16_SHIFT_BOUNDS
    assert lo_bound < _rel_l1(lo, hi) < hi_bound
    assert torch.isfinite(z_lo).all() and not torch.equal(z_lo, z_hi)


def test_bf16_compute_gradients_match_the_references():
    """The gradient_error benchmark's problem (heun, 16 steps, checkpoint,
    general noise, float64 state) at narrow widths, both sides in
    bf16_compute."""
    params, z0, words, shape = _problem("float64", "general", batch=8)
    with jax_config(x64=True):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, shape, jnp.float64)

        def loss(p, z):
            zT = jsolve.solve(*_jax_fields("general"), p, z, jbm, 0.0, 1.0, 16, solver="heun",
                              gradient_mode="checkpoint", noise="general",
                              save_trajectory=False, precision="bf16_compute")
            return jnp.sum(zT ** 2)

        want = jax.device_get(jax.jit(jax.grad(loss, argnums=(0, 1)))(params, z0))
    _, got = _port_grads(params, z0, words, shape, "float64", n=16, solver="heun",
                         noise="general", gradient_mode="checkpoint",
                         precision="bf16_compute")
    want = [torch.from_numpy(np.array(w)) for w in jax.tree.leaves(want[0]) + [want[1]]]
    assert _rel_l1(got, want) <= BF16_VS_JAX


def test_unknown_precision_is_refused_by_name():
    params, z0, words, shape = _problem("float32")
    with pytest.raises(ValueError, match="unknown precision"):
        _port_grads(params, z0, words, shape, "float32", precision="bf16")


# -----------------------------------------------------------------------------
# the training steps
# -----------------------------------------------------------------------------

LR = 1e-2
ELBO_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
PARAM_TOL = {"float32": dict(rtol=1e-6, atol=LR * 1e-2),
             "float64": dict(rtol=1e-12, atol=LR * 1e-6)}
LATENT = dict(data_dim=2, hidden_dim=4, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=23, kl_weight=0.1)
BATCH, SEQ_LEN = 4, 24


def _close(got, want, tol):
    torch.testing.assert_close(torch.as_tensor(got).detach(),
                               torch.from_numpy(np.array(want)), **tol)


def _recording(module, monkeypatch, torch_side):
    """Wrap ``module._step_index_lookup`` so every lookup records its
    ``(index, t)`` — on the JAX side through an ordered debug callback, so
    the indices are the compiled program's own."""
    seen = []
    orig = module._step_index_lookup

    def lookup(t1, T, *rest):
        at = orig(t1, T, *rest)

        def recorded(p, t):
            if torch_side:
                seen.append((module._step_index(t, t1, T, *rest), float(t)))
            else:
                idx = jnp.clip(jnp.asarray(t / t1 * T).astype(jnp.int32), 0, T)
                jax.debug.callback(lambda i, tt: seen.append((int(i), float(tt))), idx,
                                   jnp.asarray(t), ordered=True)
            return at(p, t)

        return recorded

    monkeypatch.setattr(module, "_step_index_lookup", lookup)
    return seen


@pytest.mark.parametrize("adjoint,solver,dtype,n", [
    ("backsolve", "midpoint", "float32", 230), ("checkpoint", "midpoint", "float64", 23)])
def test_latent_sde_step_matches_jax_step(monkeypatch, adjoint, solver, dtype, n):
    """One step against the JAX step, and every (context row, time) its
    solve and gradient read, in order, the compiled reference's — the left
    grid times ``k·dt`` included, where XLA folds the index's constants
    (float32 N 230: 36 of the backsolve's times; float64 N 23: k 13)."""
    cfg = dict(LATENT, num_steps=n)
    want_idx = _recording(jsde, monkeypatch, False)
    with jax_config(x64=dtype == "float64"):
        jcfg = jsde.LatentSDEConfig(**cfg, solver=solver, exact_adjoint=False,
                                    dtype=jnp.dtype(dtype))
        params = jax.device_get(jsde.latent_sde_init(jax.random.PRNGKey(63), jcfg))
        ji, ju = joptim.adam(LR)
        step = jax.jit(jax_make_latent_sde_step(jcfg, ju, BATCH, SEQ_LEN, adjoint=adjoint))
        key = jax.random.PRNGKey(68)
        new_params, _, metrics = step(params, ji(params), key)
        new_params, metrics, key = jax.device_get((new_params, metrics, np.asarray(key)))
        jax.effects_barrier()
    got_idx = _recording(tsde, monkeypatch, True)
    tcfg = tsde.LatentSDEConfig(**cfg, solver=solver, exact_adjoint=False,
                                dtype=TORCH_DTYPES[dtype])
    init, update = tsteps.make_latent_sde_optimizer(LR)
    tparams = params_from_jax(params)
    got_params, _, got_metrics = tsteps.make_latent_sde_step(
        tcfg, update, BATCH, SEQ_LEN, adjoint=adjoint, device="cpu")(
            tparams, init(tparams), torch_keys(key))
    assert sorted(got_metrics) == sorted(metrics)
    for name in metrics:
        _close(got_metrics[name], metrics[name], ELBO_TOL[dtype])
    for g, w in zip(tree.leaves(got_params), jax.tree.leaves(new_params)):
        assert g.dtype == TORCH_DTYPES[dtype] and not g.requires_grad
        _close(g, w, PARAM_TOL[dtype])
    assert len(got_idx) == len(want_idx) > 0 and got_idx == want_idx


GAN = dict(num_steps=4)
GAN_BATCH, GAN_SEQ = 8, 5
STEP0 = math.sqrt(1e-6 / (1 - 0.9))  # Adadelta's first step at lr 1
GAN_PARAM_TOL = dict(rtol=1e-6, atol=STEP0 * 1e-2)


def test_sde_gan_gp_midpoint_step_matches_jax():
    """The WGAN-GP baseline with the midpoint solver (README.md:112):
    discretise through midpoint with general noise, float32."""
    with jax_config(x64=False):
        jcfg = jsde.NeuralSDEConfig(**GAN, solver="midpoint", exact_adjoint=False)
        key = jax.random.PRNGKey(90)
        params = jax.device_get({"gen": jsde.generator_init(key, jcfg),
                                 "disc": jsde.discriminator_init(jax.random.fold_in(key, 1),
                                                                 jcfg)})
        (gi, gu), (di, du) = jax_make_gan_optimizers(1.0, "gp")
        step = jax.jit(jax_make_sde_gan_step(jcfg, gu, du, GAN_BATCH, GAN_SEQ,
                                             constraint="gp"))
        key = jax.random.PRNGKey(99)
        new_params, _, _, metrics = step(params, gi(params["gen"]), di(params["disc"]), key)
        new_params, metrics, key = jax.device_get((new_params, metrics, np.asarray(key)))
    tcfg = tsde.NeuralSDEConfig(**GAN, solver="midpoint", exact_adjoint=False)
    (gi, gu), (di, du) = tsteps.make_gan_optimizers(1.0, "gp")
    tp = params_from_jax(params)
    got, _, _, got_metrics = tsteps.make_sde_gan_step(
        tcfg, gu, du, GAN_BATCH, GAN_SEQ, constraint="gp", device="cpu")(
            tp, gi(tp["gen"]), di(tp["disc"]), torch_keys(key))
    for name in metrics:
        _close(got_metrics[name], metrics[name], ELBO_TOL["float32"])
    for g, w in zip(tree.leaves(got), jax.tree.leaves(new_params)):
        _close(g, w, GAN_PARAM_TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(adjoint="backsolve"), "continuous-adjoint backward integrator"),
    (dict(adjoint="backsolve", solver="midpoint", use_pallas_kernels=True), "backsolve path"),
    (dict(adjoint="checkpoint", use_pallas_kernels=True), "checkpointing differentiates"),
])
def test_latent_step_builder_validates_the_baselines_eagerly(kw, match):
    adjoint = kw.pop("adjoint")
    cfg = tsde.LatentSDEConfig(**{**LATENT, **kw})
    with pytest.raises(ValueError, match=match):
        tsteps.make_latent_sde_step(cfg, tsteps.make_latent_sde_optimizer()[1], BATCH,
                                    SEQ_LEN, adjoint=adjoint, device="cpu")


# -----------------------------------------------------------------------------
# the train CLI
# -----------------------------------------------------------------------------

LATENT_CLI = ["--workload", "latent-sde", "--device", "cpu", "--steps", "1", "--batch", "4"]


@pytest.mark.parametrize("flags,note", [
    (["--backsolve"], "--backsolve: using midpoint"),
    (["--solver", "heun", "--adjoint", "checkpoint"], None),
    (["--precision", "bf16_compute", "--pallas"], None),
])
def test_train_cli_runs_the_latent_baselines(capsys, flags, note):
    losses = train_cli.main(LATENT_CLI + flags)
    out = capsys.readouterr().out
    assert len(losses) == 1 and np.isfinite(losses[0]) and "done: first -ELBO" in out
    assert note is None or note in out


def test_train_cli_runs_the_gan_gp_midpoint_baseline(capsys):
    hist = train_cli.main(["--workload", "sde-gan", "--device", "cpu", "--steps", "1",
                           "--batch", "8", "--sde-steps", "8", "--seq-len", "9",
                           "--constraint", "gp", "--solver", "midpoint"])
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_train_cli_refuses_conflicting_adjoints():
    with pytest.raises(SystemExit):
        train_cli.main(LATENT_CLI + ["--backsolve", "--adjoint", "checkpoint"])


# -----------------------------------------------------------------------------
# launch counts (the card's routing, with counted plain launches)
# -----------------------------------------------------------------------------


@pytest.fixture
def counted_kernels(monkeypatch):
    """Every depth-1 field through ``fused_mlp``'s node and the Brownian
    draws through their launchers, each launch a counted plain version."""

    def fwd(*args):
        fm.LAUNCHES["fused_mlp"] += 1
        return ref.fused_mlp(*args)

    def bwd(*args):
        fm.LAUNCHES["fused_mlp_bwd"] += 1
        return ref.fused_mlp_bwd(*args)

    def dispatch(layers, x):
        (l1, l2) = layers
        args = (x, l1["w"], l1["b"], l2["w"], l2["b"])
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return fm.MLPFunction.apply(fwd, bwd, *args)
        return fwd(*args)

    monkeypatch.setattr(nn_core, "_fusable", lambda layers, x, act: (
        len(layers) == 2 and act is nn_core.lipswish and all("b" in p for p in layers)))
    monkeypatch.setattr(nn_core, "_mlp_dispatch", dispatch)
    originals = {name: getattr(ops, name) for name in
                 ("brownian_increment", "brownian_value", "space_time_increment",
                  "space_time_value")}

    def counted(name):
        def call(*args, **kw):
            bk.LAUNCHES[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in originals:
        monkeypatch.setattr(ops, name, counted(name))
    ops.reset_launch_counts()
    yield ops
    ops.reset_launch_counts()


def _solve_launches(mode: str, solver: str, n: int) -> dict:
    """Launches of one gradient of a solve whose drift and diffusion are one
    depth-1 MLP each: ``checkpoint`` evaluates ``padded + recompute`` steps
    (and reversible Heun's carry once at t0) and differentiates the padded
    steps once; ``continuous_adjoint`` solves forward without a graph, then
    per step pulls each stage's drift and diffusion once."""
    nfe = tsolvers.NFE_PER_STEP[solver]
    init = 2 if solver == "reversible_heun" else 0
    if mode == "checkpoint":
        sch = checkpoint_schedule(n)
        evals = sch["padded_steps"] + sch["recompute_steps"]
        return {"fused_mlp": 2 * nfe * evals + init,
                "fused_mlp_bwd": 2 * nfe * sch["padded_steps"] + init,
                "brownian_increment": evals}
    return {"fused_mlp": 4 * nfe * n, "fused_mlp_bwd": 2 * nfe * n,
            "brownian_increment": 2 * n}


def _lipswish_fields():
    drift = lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh)
    diffusion = lambda p, t, z: 0.3 * nn_core.sigmoid(mlp(p["sigma"], tcat(t, z)))
    return drift, diffusion


@pytest.mark.parametrize("mode,solver,n", [
    ("checkpoint", "midpoint", 7), ("checkpoint", "reversible_heun", 23),
    ("checkpoint", "euler_maruyama", 16), ("continuous_adjoint", "heun", 5),
    ("continuous_adjoint", "euler_maruyama", 6)])
def test_solve_launch_counts_follow_the_schedule(counted_kernels, mode, solver, n):
    params, z0, words, shape = _problem("float32")
    leaves, spec = tree.flatten(params_from_jax(params))
    leaves = [x.requires_grad_() for x in leaves]
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, shape)
    zT = solve(*_lipswish_fields(), tree.unflatten(spec, leaves), torch.from_numpy(z0), bm,
               0.0, 1.0, n, solver=solver, gradient_mode=mode, save_trajectory=False)
    torch.autograd.grad(zT.sum(), leaves)
    counts = counted_kernels.launch_counts()
    want = _solve_launches(mode, solver, n)
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())


def elbo_launches(adjoint: str, solver: str, n: int) -> dict:
    """One terminal-form ELBO step (``latent_sde_loss_terminal``): qz0 and ζ
    are one launch each (both differentiated); an evaluation of the
    posterior is 4 fields (ν, μ, σ in the drift, σ in the diffusion)."""
    nfe = tsolvers.NFE_PER_STEP[solver]
    init = 4 if solver == "reversible_heun" else 0
    if adjoint == "checkpoint":
        sch = checkpoint_schedule(n)
        evals = sch["padded_steps"] + sch["recompute_steps"]
        return {"fused_mlp": 2 + 4 * nfe * evals + init,
                "fused_mlp_bwd": 2 + 4 * nfe * sch["padded_steps"] + init,
                "brownian_increment": evals}
    return {"fused_mlp": 2 + 8 * nfe * n, "fused_mlp_bwd": 2 + 4 * nfe * n,
            "brownian_increment": 2 * n}


def gp_launches(n: int, seq_len: int) -> dict:
    """One WGAN-GP step under discretise (a solver other than reversible
    Heun): an evaluation of the joint SDE is 5 fields, of the CDE 2.  The
    discriminator's loss (ζ without a gradient), the penalty's CDE solve
    (its backward launches in the outer backward, none under create_graph),
    then the generator's fake score; every field launch of a recorded solve
    makes a node."""
    nfe, T = tsolvers.NFE_PER_STEP["midpoint"], seq_len - 1
    joint, cde = 5 * nfe * n, 2 * nfe * T
    return {"fused_mlp": (2 + joint) + (1 + cde) + (1 + cde) + (2 + joint),
            "fused_mlp_bwd": (1 + joint) + (1 + cde) + (1 + cde) + (2 + joint),
            "brownian_increment": 2 * n}


@pytest.mark.parametrize("adjoint,solver", [("backsolve", "midpoint"),
                                            ("checkpoint", "midpoint"),
                                            ("checkpoint", "reversible_heun")])
def test_elbo_step_launch_counts_follow_the_code(counted_kernels, adjoint, solver):
    cfg = tsde.LatentSDEConfig(**LATENT, solver=solver, exact_adjoint=False)
    params = tsde.latent_sde_init(torch.Generator().manual_seed(3), cfg)
    init, update = tsteps.make_latent_sde_optimizer(LR)
    step = tsteps.make_latent_sde_step(cfg, update, BATCH, SEQ_LEN, adjoint=adjoint,
                                       device="cpu")
    step(params, init(params), prng.PRNGKey(4))
    counts = counted_kernels.launch_counts()
    want = elbo_launches(adjoint, solver, LATENT["num_steps"])
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())


def test_gp_midpoint_step_launch_counts_follow_the_code(counted_kernels):
    tcfg = tsde.NeuralSDEConfig(**GAN, solver="midpoint", exact_adjoint=False)
    gen = torch.Generator().manual_seed(5)
    p = {"gen": tsde.generator_init(gen, tcfg), "disc": tsde.discriminator_init(gen, tcfg)}
    (gi, gu), (di, du) = tsteps.make_gan_optimizers(1.0, "gp")
    tsteps.make_sde_gan_step(tcfg, gu, du, GAN_BATCH, GAN_SEQ, constraint="gp",
                             device="cpu")(p, gi(p["gen"]), di(p["disc"]), prng.PRNGKey(6))
    counts = counted_kernels.launch_counts()
    want = gp_launches(GAN["num_steps"], GAN_SEQ)
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())


def test_chip_smoke_constants_are_these_formulas():
    import chip_smoke

    assert chip_smoke.BASELINE_STEP_LAUNCHES == {
        "midpoint/backsolve": elbo_launches("backsolve", "midpoint", 23),
        "midpoint/checkpoint": elbo_launches("checkpoint", "midpoint", 23),
        "reversible_heun/checkpoint": elbo_launches("checkpoint", "reversible_heun", 23)}
    assert chip_smoke.GP_MIDPOINT_STEP_LAUNCHES == gp_launches(31, 32)
