"""The SDE-GAN training step and loop in the port, on the CPU: one clip step
and one gradient-penalty step against the JAX step (``make_sde_gan_step``),
the one-pull gradients bitwise the reference's two pulls, the exact adjoint
against discretise-then-optimise (≤1e-12 in float64), three clip steps
bitwise on a rerun with the Wasserstein estimate falling, the step
builder's eager errors, the launch counts of a step (the card's kernels
replaced by counted plain versions), and the train CLI: ``--workload
sde-gan`` with both constraints, the bundle it writes served by the port's
serve CLI, a rerun that resumes, a checkpoint of the other constraint
refused by name, and the Latent SDE's resume on the same loop.  Sizes are
the JAX suite's ``TINY`` (8 solver steps, batch 16, 9 observations).

Tolerances (those of tests/test_torch_training.py:9-17):
* losses and gradients: float32 rtol 1e-4, atol 1e-5; float64 rtol 1e-9,
  atol 1e-12 — per-ulp field differences carried through three solves
  forward and back.
* updated parameters: atol 1e-2 (float32) and 1e-6 (float64) of
  Adadelta's first-step size, ``lr·sqrt(eps/(1−ρ))`` ≈ 3.2e-3 at lr 1
  (rtol 1e-6 / 1e-12 on top): an entry's first update is ``−g·sqrt(eps) /
  sqrt((1−ρ)g² + eps)``, which magnifies the difference of a gradient
  near ``sqrt(eps/(1−ρ))``; the clip's box edges are exact.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gan_pulls import two_pull_grads
from _torch_parity import TORCH_DTYPES, jax_config, torch_keys
from repro.core import sde as jsde
from repro.launch.steps import make_gan_optimizers as jax_make_gan_optimizers
from repro.launch.steps import make_sde_gan_step as jax_make_sde_gan_step
from repro_torch import NoCudaDeviceError, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import clipping
from repro_torch.core import sde as tsde
from repro_torch.data import ou_process
from repro_torch.kernels import brownian as bk
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import ops, prng, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_cli
from repro_torch.serving import restore_for_serving

DTYPES = ["float32", "float64"]
LOSS_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
STEP0 = math.sqrt(1e-6 / (1 - 0.9))  # Adadelta's first step at lr 1
PARAM_TOL = {"float32": dict(rtol=1e-6, atol=STEP0 * 1e-2),
             "float64": dict(rtol=1e-12, atol=STEP0 * 1e-6)}
TINY = dict(num_steps=8)
BATCH, SEQ = 16, 9
CLI = ["--workload", "sde-gan", "--device", "cpu", "--batch", "8", "--sde-steps", "8",
       "--seq-len", "9"]


def _close(got, want, tol):
    torch.testing.assert_close(torch.as_tensor(got).detach(),
                               torch.from_numpy(np.array(want)), **tol)


@functools.lru_cache(maxsize=None)
def _problem(dtype, seed=90):
    """JAX config and parameters (numpy) and the port's config."""
    with jax_config(x64=dtype == "float64"):
        jcfg = jsde.NeuralSDEConfig(**TINY, dtype=jnp.dtype(dtype))
        key = jax.random.PRNGKey(seed)
        params = jax.device_get({"gen": jsde.generator_init(key, jcfg),
                                 "disc": jsde.discriminator_init(jax.random.fold_in(key, 1),
                                                                 jcfg)})
    return jcfg, tsde.NeuralSDEConfig(**TINY, dtype=TORCH_DTYPES[dtype]), params


def _port_step(tcfg, params, constraint, key, seq=SEQ):
    (gi, gu), (di, du) = tsteps.make_gan_optimizers(1.0, constraint)
    tp = params_from_jax(params)
    step = tsteps.make_sde_gan_step(tcfg, gu, du, BATCH, seq, constraint=constraint,
                                    device="cpu")
    return step(tp, gi(tp["gen"]), di(tp["disc"]), torch_keys(key))


@pytest.mark.parametrize("constraint", ["clip", "gp"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sde_gan_step_matches_jax_step(dtype, constraint):
    jcfg, tcfg, params = _problem(dtype)
    with jax_config(x64=dtype == "float64"):
        (gi, gu), (di, du) = jax_make_gan_optimizers(1.0, constraint)
        step = jax.jit(jax_make_sde_gan_step(jcfg, gu, du, BATCH, SEQ, constraint=constraint))
        key = jax.random.PRNGKey(91)
        new_params, g_state, d_state, metrics = step(params, gi(params["gen"]),
                                                     di(params["disc"]), key)
        new_params, g_state, d_state, metrics, key = jax.device_get(
            (new_params, g_state, d_state, metrics, np.asarray(key)))
    got, got_g, got_d, got_metrics = _port_step(tcfg, params, constraint, key)
    assert sorted(got_metrics) == sorted(metrics) == ["disc_loss", "gen_loss", "wasserstein"]
    for name in metrics:
        _close(got_metrics[name], metrics[name], LOSS_TOL[dtype])
    for g, w in zip(tree.leaves(got), jax.tree.leaves(new_params)):
        assert g.dtype == TORCH_DTYPES[dtype] and not g.requires_grad
        _close(g, w, PARAM_TOL[dtype])
    for g, w in zip(tree.leaves((got_g, got_d)), jax.tree.leaves((g_state, d_state))):
        if isinstance(g, int):
            assert g == int(w) == 1
    if constraint == "clip":
        for name in ("f", "g", "xi"):
            assert clipping.per_layer_violation(got["disc"][name]).item() <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_pull_gradients_equal_two_pulls_bitwise(dtype):
    _, tcfg, params = _problem(dtype)
    key = prng.PRNGKey(92)
    y_real = ou_process(prng.fold_in_key(key, 0), BATCH, SEQ, dtype=tcfg.dtype)
    runs = [fn(params_from_jax(params), tcfg, prng.fold_in_key(key, 1), y_real, BATCH)
            for fn in (tsteps.sde_gan_grads, two_pull_grads)]
    for a, b in zip(tree.leaves(runs[0]), tree.leaves(runs[1])):
        assert torch.equal(a, b)


def test_exact_adjoint_equals_discretise_for_both_players():
    """float64: the clip step's gradients through the exact adjoint against
    autograd through the unrolled solves, ≤1e-12 relative."""
    _, tcfg, params = _problem("float64")
    key = prng.PRNGKey(93)
    y_real = ou_process(prng.fold_in_key(key, 0), BATCH, SEQ, dtype=torch.float64)
    runs = [tsteps.sde_gan_grads(params_from_jax(params), cfg, prng.fold_in_key(key, 1),
                                 y_real, BATCH)
            for cfg in (tcfg, tsde.NeuralSDEConfig(**TINY, dtype=torch.float64,
                                                   gradient_mode="discretise"))]
    for part in (2, 3):  # the generator's and the discriminator's gradients
        exact, dto = tree.leaves(runs[0][part]), tree.leaves(runs[1][part])
        num = sum((a - b).abs().sum().item() for a, b in zip(exact, dto))
        assert num / sum(b.abs().sum().item() for b in dto) <= 1e-12


def test_three_clip_steps_bitwise_on_rerun_and_wasserstein_falls():
    """As tests/test_gan_training.py's two-step test: three calls on one
    key (the metrics are pre-update, so they see two updates) decrease the
    Wasserstein loss estimate, and the trajectory is bitwise on a rerun."""
    _, tcfg, params = _problem("float32", seed=0)
    (gi, gu), (di, du) = tsteps.make_gan_optimizers(1.0, "clip")
    step = tsteps.make_sde_gan_step(tcfg, gu, du, BATCH, SEQ, device="cpu")

    def run():
        p = params_from_jax(params)
        state = (p, gi(p["gen"]), di(p["disc"]))
        losses = []
        for _ in range(3):
            *state, m = step(*state, prng.PRNGKey(94))
            losses.append(m["disc_loss"].item())
        return losses, state[0]

    (a, pa), (b, pb) = run(), run()
    assert a == b and all(torch.equal(x, y) for x, y in zip(tree.leaves(pa), tree.leaves(pb)))
    assert a[1] < a[0] and a[2] < a[1], f"W estimate not decreasing: {a}"


@pytest.mark.parametrize("constraint,seq,match", [
    ("lipschitz", SEQ, "constraint must be"),
    ("gp", SEQ + 1, "seq_len == num_steps"),
])
def test_step_builder_validates_eagerly(constraint, seq, match):
    with pytest.raises(ValueError, match=match):
        tsteps.make_sde_gan_step(tsde.NeuralSDEConfig(**TINY), None, None, BATCH, seq,
                                 constraint=constraint, device="cpu")
    if constraint == "lipschitz":
        with pytest.raises(ValueError, match=match):
            tsteps.make_gan_optimizers(1.0, constraint)


@pytest.fixture
def counted_kernels(monkeypatch):
    """The card's routing on the CPU: every depth-1 field through
    ``fused_mlp``'s node and the Brownian draws through their launcher,
    each launch a counted plain version (what chip_smoke.py asserts on the
    card)."""
    from repro_torch.nn import core as nn_core

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
    increment = ops.brownian_increment

    def counted_increment(*args, **kw):
        bk.LAUNCHES["brownian_increment"] += 1
        return increment(*args, **kw)

    monkeypatch.setattr(ops, "brownian_increment", counted_increment)
    ops.reset_launch_counts()
    yield ops
    ops.reset_launch_counts()


def _launches_per_step(constraint: str, num_steps: int, seq_len: int) -> dict:
    """The formula chip_smoke.py's GAN_STEP_LAUNCHES and GP_STEP_LAUNCHES
    take at 31 steps, by solve: a general-noise reversible solve of N steps
    evaluates its fields N + 1 times forward, then per step twice (the
    reconstruction and the local VJP, which differentiates one) and once at
    t0; each evaluation is 5 fields in the joint solve (μ, σ, f, g twice)
    and 2 in a CDE solve (f, g); ζ and ξ are one launch each."""
    N, T = num_steps, seq_len - 1
    joint_fwd, joint_bwd = 5 * (N + 1), 5 * (2 * N + 1)
    cde_fwd, cde_bwd = 2 * (T + 1), 2 * (2 * T + 1)
    fake_fwd = 2 + joint_fwd          # zeta, xi, the joint forward
    real_fwd = 1 + cde_fwd            # xi, the CDE forward
    if constraint == "clip":          # one backward of both
        return {"fused_mlp": fake_fwd + real_fwd + joint_bwd + cde_bwd,
                "fused_mlp_bwd": 3 + 5 * (N + 1) + 2 * (T + 1),
                "brownian_increment": 2 * N}
    # gp: the discriminator's loss (zeta has no gradient), the penalty's
    # discretise CDE solve and its double backward (one backward launch a
    # field launch, none under create_graph), then the fake score again
    # for the generator (xi's input carries a gradient, the real path no).
    gp_fwd = 1 + cde_fwd
    return {"fused_mlp": fake_fwd + real_fwd + joint_bwd + cde_bwd + gp_fwd
                         + fake_fwd + joint_bwd,
            "fused_mlp_bwd": (2 + 5 * (N + 1) + 2 * (T + 1)) + gp_fwd + (2 + 5 * (N + 1)),
            "brownian_increment": 4 * N}


@pytest.mark.parametrize("constraint", ["clip", "gp"])
def test_step_launch_counts_follow_the_code(counted_kernels, constraint):
    _, tcfg, params = _problem("float32")
    got, _, _, _ = _port_step(tcfg, params, constraint, np.asarray([0, 95], np.uint32))
    counts = counted_kernels.launch_counts()
    want = _launches_per_step(constraint, TINY["num_steps"], SEQ)
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())
    import chip_smoke

    # the constants the card run asserts are this formula at its widths
    assert _launches_per_step("clip", 31, 32) == chip_smoke.GAN_STEP_LAUNCHES
    assert _launches_per_step("gp", 31, 32) == chip_smoke.GP_STEP_LAUNCHES


def test_gradient_penalty_double_backward_launches_no_backward_kernel(counted_kernels):
    """Under create_graph every field node runs the plain version's VJP."""
    _, tcfg, params = _problem("float32")
    disc = params_from_jax(params)["disc"]
    leaves, spec = tree.flatten(disc)
    leaves = [x.requires_grad_() for x in leaves]
    y = torch.from_numpy(np.random.default_rng(96).standard_normal((SEQ, BATCH, 1))
                         .astype("float32"))
    gp = tsde.gradient_penalty(tree.unflatten(spec, leaves), tcfg, prng.PRNGKey(97), y, y * 0.5)
    assert counted_kernels.launch_counts()["fused_mlp"] == 1 + 2 * SEQ
    assert counted_kernels.launch_counts()["fused_mlp_bwd"] == 0
    torch.autograd.grad(gp, leaves, allow_unused=True)
    assert counted_kernels.launch_counts()["fused_mlp_bwd"] == 1 + 2 * SEQ


# -----------------------------------------------------------------------------
# the train CLI
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("constraint", ["clip", "gp"])
def test_train_cli_trains_writes_a_servable_bundle_and_resumes(tmp_path, capsys, constraint):
    args = CLI + ["--constraint", constraint, "--ckpt-dir", str(tmp_path)]
    mmds = train_cli.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert len(mmds) == 1 and np.isfinite(mmds[0]) and "done: first sig-MMD" in out
    params, cfg, step = restore_for_serving("sde-gan", tmp_path, "cpu")
    assert step == 2 and cfg.num_steps == 8 and sorted(params) == ["ell", "mu", "sigma", "zeta"]
    serve_cli.main(["--workload", "sde-gan", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                    "--requests", "3", "--max-batch", "4", "--request-max", "2"])
    assert "trajectories" in capsys.readouterr().out
    # a rerun to 3 steps resumes at 2 and runs one step
    train_cli.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: first W" in out
    assert restore_for_serving("sde-gan", tmp_path, "cpu")[2] == 3
    other = "gp" if constraint == "clip" else "clip"
    with pytest.raises(train_cli.CheckpointLayoutError, match="--constraint"):
        train_cli.main(CLI + ["--constraint", other, "--ckpt-dir", str(tmp_path),
                              "--steps", "4"])


def test_train_sde_gan_resume_continues_bitwise(tmp_path):
    """Two steps with a checkpoint, then a rerun to three: the third step's
    metrics and the final parameters are the uninterrupted run's bits."""
    kw = dict(seed=3, log_every=100, num_steps=8, seq_len=9, device="cpu")
    full, full_hist = train_cli.train_sde_gan(3, 8, **kw)
    train_cli.train_sde_gan(2, 8, ckpt_dir=str(tmp_path), **kw)
    resumed, hist = train_cli.train_sde_gan(3, 8, ckpt_dir=str(tmp_path), **kw)
    assert [r["step"] for r in hist] == [2] and hist[0] == full_hist[2]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed), tree.leaves(full)))


def test_train_latent_sde_resumes_on_the_shared_loop(tmp_path, capsys):
    kw = dict(num_steps=23, device="cpu")
    _, full = train_cli.train_latent_sde(3, 4, **kw)
    train_cli.train_latent_sde(2, 4, ckpt_dir=str(tmp_path), **kw)
    _, resumed = train_cli.train_latent_sde(3, 4, ckpt_dir=str(tmp_path), **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == full[2:]
    assert restore_for_serving("latent-sde", tmp_path, "cpu")[2] == 3


def test_train_cli_sde_gan_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        train_cli.main(["--workload", "sde-gan", "--steps", "1"])
