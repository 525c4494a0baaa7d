"""The port's strong-order-1.5 SRK solver (repro_torch.core.solvers
``_srk_step`` / ``_srk_embedded_step``, registered in repro_torch.core.solve)
against the JAX package on the CPU; mirrors tests/test_srk.py case for
case: the registry entry, the eager rejections, a bare ΔW refused, a fixed
grid against the reference's, checkpoint ≡ discretise, additive noise, the
adaptive loop (its floats held by replaying the reference's accepted grid:
the PI controller amplifies ulps, ROADMAP.md Queue 3), the ``dt = 0``
padding step, batched solves on space-time paths, the config path, srk
against euler on a shared Dense path; then the slice: three srk ELBO steps
(discretise and checkpoint) against the reference's ``make_latent_sde_step``
and their kernel launches, derived from the code.

The (W, H) draws come from ``jax.random`` directly in the reference, so
every comparison sets ``jax_threefry_partitionable=False`` (``jax_config``).

Tolerances, with their reasons:
* a step or a fixed-grid solve against the reference: float32 rtol 2e-5,
  atol 2e-6; float64 rtol 1e-11, atol 1e-13 (XLA contracts the scheme's
  multiply-adds into FMAs and rounds ``3.0·dt`` in double; the draws carry
  the normals' few-ulp bound).
* the adaptive terminal value over the reference's replayed grid: float64
  rtol 1e-9, atol 1e-11 (the joint descent's float64 normals, ~94 steps).
* checkpoint vs discretise gradients inside the port: ≤ 1e-12 relative in
  float64 (the same steps recomputed); the adaptive replay's value bitwise
  the controller's.
* the ELBO steps: float32 rtol 1e-4, atol 1e-5 on the metrics, the
  parameters rtol 1e-5, atol 1e-4·lr after three Adam steps (as
  tests/test_torch_gradients.py, over three steps).
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
from repro.core import brownian as jb
from repro.core import sde as jsde
from repro.launch.steps import make_latent_sde_step as jax_make_latent_sde_step
from repro.nn.core import mlp as jax_mlp
from repro.nn.core import tcat as jax_tcat
from repro_torch import tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import BrownianPath, DenseBrownianPath, stlevy_difference
from repro_torch.core import sde as tsde
from repro_torch.core import solvers as tsolvers
from repro_torch.core.gradients import checkpoint_schedule
from repro_torch.core.solve import get_solver, solve, solve_adaptive, solve_batched
from repro_torch.kernels import prng
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_cli
from repro_torch.nn import mlp, tcat
from test_torch_gradients import counted_kernels  # noqa: F401  (the fixture)

jsolve = importlib.import_module("repro.core.solve")  # the package exports solve()

DTYPES = ["float32", "float64"]
SOLVE_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
D, W = 3, 8


def _gbm_torch():
    return (lambda p, t, z: p * z), (lambda p, t, z: 0.4 * z)


def _levy_bm(seed=5, shape=(), dtype=torch.float32):
    return BrownianPath(prng.PRNGKey(seed), 0.0, 1.0, shape, dtype, levy_area="space-time")


def _params(dtype, seed=40):
    rng = np.random.default_rng(seed)

    def net(sizes):
        return {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    return {"mu": net([1 + D, W, D]), "sigma": net([1 + D, W, D])}


def _jax_fields():
    return (lambda p, t, z: jax_mlp(p["mu"], jax_tcat(t, z), final_activation=jnp.tanh),
            lambda p, t, z: 0.3 * jax.nn.sigmoid(jax_mlp(p["sigma"], jax_tcat(t, z))) * z)


def _torch_fields():
    return (lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh),
            lambda p, t, z: 0.3 * torch.sigmoid(mlp(p["sigma"], tcat(t, z))) * z)


def _close(got, want, tol):
    torch.testing.assert_close(torch.as_tensor(got).detach(),
                               torch.from_numpy(np.array(want)), **tol)


# -----------------------------------------------------------------------------
# registry + eager validation
# -----------------------------------------------------------------------------


def test_srk_spec_registered():
    spec, want = get_solver("srk"), jsolve.get_solver("srk")
    assert spec.strong_order == want.strong_order == 1.5
    assert spec.needs_levy_area and want.needs_levy_area
    assert spec.noise_types == want.noise_types == ("diagonal",)
    assert spec.sde_type == want.sde_type == "ito"
    assert spec.gradient_modes == want.gradient_modes == ("discretise", "checkpoint")
    assert spec.embedded_stepper is not None and not spec.reversible
    assert tsolvers.NFE_PER_STEP["srk"] == spec.nfe_per_step == 5


@pytest.mark.parametrize("kw,path,match", [
    (dict(gradient_mode="reversible_adjoint"), "levy", "reversible_adjoint"),
    (dict(use_pallas_kernels=True), "levy", "Pallas"),
    (dict(noise="general"), "levy", "noise"),
    (dict(), "plain", "space-time"),
    (dict(solver="heun"), "levy", "space-time"),
])
def test_srk_eager_rejections(kw, path, match):
    drift, diffusion = _gbm_torch()
    bm = _levy_bm() if path == "levy" else BrownianPath(prng.PRNGKey(5), 0.0, 1.0, ())
    args = dict(solver="srk", save_trajectory=False)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        solve(drift, diffusion, 0.7, torch.tensor(1.0), bm, 0.0, 1.0, 8, **args)


def test_srk_stepper_rejects_bare_dw():
    drift, diffusion = _gbm_torch()
    with pytest.raises(TypeError, match="space-time"):
        tsolvers._srk_embedded_step(torch.tensor(1.0), 0.0, np.float32(0.125),
                                    torch.tensor(0.1), drift, diffusion, 0.7, "diagonal")
    with pytest.raises(ValueError, match="diagonal noise only"):
        tsolvers._srk_embedded_step(torch.tensor(1.0), 0.0, np.float32(0.125),
                                    (torch.tensor(0.1), torch.tensor(0.0)), drift, diffusion,
                                    0.7, "general")


# -----------------------------------------------------------------------------
# solve paths
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_srk_fixed_grid_matches_jax(dtype):
    """The trajectory of a 16-step srk solve with MLP fields and
    multiplicative diagonal noise, the fields at the grid's times."""
    params = _params(dtype)
    words = key_words(41, 1)[0]
    z0 = (0.5 * np.random.default_rng(42).standard_normal((2, D))).astype(dtype)
    with jax_config(x64=dtype == "float64"):
        bm = jb.BrownianPath(jnp.asarray(words), 0.0, 1.0, (2, D), jnp.dtype(dtype),
                             levy_area="space-time")
        want = np.asarray(jax.jit(lambda p, z: jsolve.solve(
            *_jax_fields(), p, z, bm, 0.0, 1.0, 16, solver="srk"))(params, z0))
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (2, D), TORCH_DTYPES[dtype],
                      levy_area="space-time")
    got = solve(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0), bm, 0.0,
                1.0, 16, solver="srk")
    assert got.shape == (17, 2, D) and torch.equal(got[0], torch.from_numpy(z0))
    _close(got, want, SOLVE_TOL[dtype])


def test_srk_checkpoint_matches_discretise_gradients():
    """Checkpointing recomputes the same discrete scheme: float64 gradients
    agree to roundoff, the values bitwise."""
    drift, diffusion = _gbm_torch()
    bm = _levy_bm(dtype=torch.float64, shape=(3,))
    z0 = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)

    def grad(mode):
        p = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        z = solve(drift, diffusion, p, z0, bm, 0.0, 1.0, 16, solver="srk",
                  gradient_mode=mode, save_trajectory=False)
        return z.detach(), torch.autograd.grad(z.sum(), p)[0]

    (z_d, g_d), (z_c, g_c) = grad("discretise"), grad("checkpoint")
    assert torch.equal(z_d, z_c)
    assert abs(g_c.item() - g_d.item()) <= 1e-12 * abs(g_d.item())


def test_srk_additive_noise_interpolates_exactly_in_w():
    """Additive noise, zero drift: the scheme reduces to z + σΔW, and the
    Dense path's grid increments telescope to value(t1)."""
    bm = DenseBrownianPath.sample(prng.PRNGKey(9), 0.0, 1.0, 64, (4,), torch.float64,
                                  levy_area="space-time")
    z = solve(lambda p, t, z: torch.zeros_like(z), lambda p, t, z: torch.full_like(z, 0.3),
              None, torch.zeros(4, dtype=torch.float64), bm, 0.0, 1.0, 8, solver="srk",
              save_trajectory=False)
    w1, _ = bm.value(1.0)
    torch.testing.assert_close(z, 0.3 * w1, rtol=1e-12, atol=1e-14)


ADAPT = dict(solver="srk", rtol=2e-3, atol=1e-6, max_steps=256, dt0=1 / 16, bridge_depth=10)


def test_srk_adaptive_matches_jax_by_replaying_its_grid():
    """The reference's adaptive srk solve (float64, bridge depth 10) and the
    port's: the same accepted and rejected counts; the reference's accepted
    grid replayed through the port's steps and the path's interval pairs
    gives its terminal value."""
    params = _params("float64")
    words = key_words(43, 1)[0]
    z0 = (0.5 * np.random.default_rng(44).standard_normal((2, D)))
    with jax_config(x64=True):
        jbm = jb.BrownianPath(jnp.asarray(words), 0.0, 1.0, (2, D), jnp.float64,
                              levy_area="space-time")
        want_z, want = jax.device_get(jax.jit(lambda p, z: jsolve.solve_adaptive(
            *_jax_fields(), p, z, jbm, 0.0, 1.0, **ADAPT))(params, z0))
    tp = params_from_jax(params)
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (2, D), torch.float64,
                      levy_area="space-time")
    z, stats = solve_adaptive(*_torch_fields(), tp, torch.from_numpy(z0), bm, 0.0, 1.0,
                              **ADAPT)
    assert bool(stats.converged) and bool(want.converged)
    assert (int(stats.num_accepted), int(stats.num_rejected)) == (
        int(want.num_accepted), int(want.num_rejected))
    assert int(stats.nfe) == 5 * (int(stats.num_accepted) + int(stats.num_rejected))
    zr = torch.from_numpy(z0)
    for t, dt in zip(want.ts[:int(want.num_accepted)], want.dts[:int(want.num_accepted)]):
        t, dt = torch.tensor(t), torch.tensor(dt)
        dw = stlevy_difference(bm.value(t, 10), bm.value(t + dt, 10), t, t + dt, 0.0)
        zr = tsolvers._srk_step(zr, t, dt, dw, *_torch_fields(), tp, "diagonal", t1=t + dt)
    _close(zr, want_z, dict(rtol=1e-9, atol=1e-11))


def test_srk_adaptive_composes_and_checkpoint_grad_finite():
    """The checkpoint backend replays the accepted grid (the interval pairs
    re-formed by ``stlevy_difference``): its value is bitwise the
    controller's, its gradient finite and non-zero.  At bridge depth 10 and
    rtol 1e-2 (the reference's test: depth 24, rtol 2e-3), so that the
    plain descent's replay stays a few seconds on the CPU."""
    drift, diffusion = _gbm_torch()
    bm = _levy_bm(dtype=torch.float64)
    kw = dict(solver="srk", rtol=1e-2, atol=1e-6, bridge_depth=10)
    z, stats = solve_adaptive(drift, diffusion, 0.7, torch.tensor(1.0, dtype=torch.float64),
                              bm, 0.0, 1.0, **kw)
    assert bool(stats.converged) and int(stats.num_accepted) > 0
    assert int(stats.nfe) == 5 * (int(stats.num_accepted) + int(stats.num_rejected))
    p = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    zc = solve(drift, diffusion, p, torch.tensor(1.0, dtype=torch.float64), bm, 0.0, 1.0, 16,
               gradient_mode="checkpoint", save_trajectory=False, adaptive=True, **kw)
    assert torch.equal(zc.detach(), z)
    g = torch.autograd.grad(zc, p)[0]
    assert torch.isfinite(g) and g.item() != 0.0


def test_srk_dt_zero_padding_step_is_identity_with_clean_gradient():
    """The checkpoint replay's padding slots run the stepper at dt = 0 on
    the zero pair; the dt_safe guard makes that an exact identity and keeps
    NaN out of the backward."""
    drift, diffusion = _gbm_torch()
    z0 = torch.tensor(1.3)
    p = torch.tensor(0.7, requires_grad=True)
    pair = (torch.zeros(()), torch.zeros(()))
    out, err = tsolvers._srk_embedded_step(z0, torch.tensor(0.0), torch.tensor(0.0), pair,
                                           drift, diffusion, p, "diagonal")
    assert out.item() == z0.item() and err.item() == 0.0
    assert torch.isfinite(torch.autograd.grad(out, p)[0])
    # a padding slot of the replay: the zero-length interval's pair is exact zeros
    zero = stlevy_difference(_levy_bm().value(0.0), _levy_bm().value(0.0), 0.0, 0.0, 0.0)
    assert all(torch.equal(x, torch.zeros(())) for x in zero)


def test_srk_batched_constructs_levy_paths():
    """``solve_batched`` builds the rows' paths in space-time mode: each row
    is the reference's vmapped solve of its own key."""
    drift, diffusion = _gbm_torch()
    words = key_words(45, 4)
    with jax_config(x64=False):
        want = np.asarray(jsolve.solve_batched(
            lambda p, t, z: p * z, lambda p, t, z: 0.4 * z, 0.7, jnp.ones((4,)),
            jnp.asarray(words), 0.0, 1.0, 8, solver="srk", save_trajectory=False))
    z = solve_batched(drift, diffusion, 0.7, torch.ones(4), torch_keys(words), 0.0, 1.0, 8,
                      solver="srk", save_trajectory=False)
    assert z.shape == (4,) and torch.isfinite(z).all()
    _close(z, want, SOLVE_TOL["float32"])


def test_srk_via_config_path():
    """``cfg.solver="srk"`` through ``_cfg_solve``: the diagonal-noise path
    is rebuilt in space-time mode, as the reference rebuilds it."""
    words = key_words(46, 1)[0]
    with jax_config(x64=False):
        jcfg = jsde.NeuralSDEConfig(solver="srk", exact_adjoint=False, num_steps=8)
        jbm = jb.BrownianPath(jnp.asarray(words), 0.0, jcfg.t1, (3,), jcfg.dtype)
        want = np.asarray(jsde._cfg_solve(jcfg, lambda p, t, z: p * z,
                                          lambda p, t, z: 0.4 * z, 0.7, jnp.ones(3),
                                          jbm, jcfg.num_steps, "diagonal"))
    cfg = tsde.NeuralSDEConfig(solver="srk", exact_adjoint=False, num_steps=8)
    bm = BrownianPath(torch_keys(words), 0.0, cfg.t1, (3,), cfg.dtype)
    traj = tsde._cfg_solve(cfg, *_gbm_torch(), 0.7, torch.ones(3), bm, cfg.num_steps,
                           "diagonal")
    assert traj.shape == (9, 3) and torch.isfinite(traj).all()
    _close(traj, want, SOLVE_TOL["float32"])


def test_srk_strong_error_beats_euler_on_shared_path():
    """On one shared Dense path (W shared bitwise between the modes), srk at
    n = 32 beats euler-maruyama at the same n on the GBM terminal error
    (the order-1.5 claim in miniature; chip_smoke.py runs the slope gate)."""
    mu, sig, paths = 0.7, 0.5, 256
    drift = lambda p, t, z: mu * z
    diffusion = lambda p, t, z: sig * z
    st = DenseBrownianPath.sample(prng.PRNGKey(0), 0.0, 1.0, 256, (paths,), torch.float64,
                                  levy_area="space-time")
    plain = DenseBrownianPath(st.w, 0.0, 1.0)
    exact = torch.exp((mu - 0.5 * sig ** 2) + sig * plain.value(1.0))
    z0 = torch.ones(paths, dtype=torch.float64)
    err = lambda z: torch.sqrt(torch.mean((z - exact) ** 2)).item()
    e_srk = err(solve(drift, diffusion, None, z0, st, 0.0, 1.0, 32, solver="srk",
                      save_trajectory=False))
    e_em = err(solve(drift, diffusion, None, z0, plain, 0.0, 1.0, 32,
                     solver="euler_maruyama", save_trajectory=False))
    assert e_srk < 0.2 * e_em, (e_srk, e_em)


# -----------------------------------------------------------------------------
# the slice: srk ELBO steps against the reference's, and their launches
# -----------------------------------------------------------------------------

LR = 1e-2
LATENT = dict(data_dim=2, hidden_dim=4, context_dim=4, initial_noise_dim=3, width=8,
              depth=1, num_steps=4, kl_weight=0.1)
BATCH, SEQ_LEN = 4, 5
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=LR * 1e-4)


@pytest.mark.parametrize("adjoint", ["exact", "checkpoint"])
def test_three_srk_elbo_steps_match_jax(adjoint):
    """The step ``train_latent_sde(solver="srk")`` runs, three times from
    the same parameters and keys as the reference's ``make_latent_sde_step``
    with ``cfg.solver="srk"``: discretise (``adjoint="exact"`` with a
    non-reversible solver) and checkpoint, float32."""
    with jax_config(x64=False):
        jcfg = jsde.LatentSDEConfig(**LATENT, solver="srk", exact_adjoint=False)
        params = jax.device_get(jsde.latent_sde_init(jax.random.PRNGKey(63), jcfg))
        ji, ju = joptim.adam(LR)
        step = jax.jit(jax_make_latent_sde_step(jcfg, ju, BATCH, SEQ_LEN, adjoint=adjoint))
        data_key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
        p, s, want = params, ji(params), []
        for k in range(3):
            p, s, metrics = step(p, s, jax.random.fold_in(data_key, k))
            want.append(jax.device_get(metrics))
        want_params = jax.device_get(p)
    tcfg = tsde.LatentSDEConfig(**LATENT, solver="srk", exact_adjoint=False)
    init, update = tsteps.make_latent_sde_optimizer(LR)
    tstep = tsteps.make_latent_sde_step(tcfg, update, BATCH, SEQ_LEN, adjoint=adjoint,
                                        device="cpu")
    tp = params_from_jax(params)
    ts = init(tp)
    data_key = prng.fold_in_key(prng.PRNGKey(0), 2)
    for k in range(3):
        tp, ts, metrics = tstep(tp, ts, prng.fold_in_key(data_key, k))
        for name in want[k]:
            _close(metrics[name], want[k][name], METRIC_TOL)
    for g, w in zip(tree.leaves(tp), jax.tree.leaves(want_params)):
        _close(g, w, PARAM_TOL)


def srk_elbo_launches(adjoint: str, n: int) -> dict:
    """One srk ELBO step: qz0 and ζ one launch each; an srk step evaluates
    the posterior drift 3 times (ν, μ, σ: 3 launches each) and its
    diffusion 5 times (1 launch), 14 launches.  Discretise (the trajectory
    form): n steps, every launch differentiated once, one (W, H) draw a
    step.  Checkpoint: the schedule's step evaluations, each a draw, and
    the padded steps differentiated once."""
    per = 3 * 3 + 5
    if adjoint == "checkpoint":
        sch = checkpoint_schedule(n)
        evals = sch["padded_steps"] + sch["recompute_steps"]
        return {"fused_mlp": 2 + per * evals, "fused_mlp_bwd": 2 + per * sch["padded_steps"],
                "space_time_increment": evals}
    return {"fused_mlp": 2 + per * n, "fused_mlp_bwd": 2 + per * n,
            "space_time_increment": n}


@pytest.mark.parametrize("adjoint", ["exact", "checkpoint"])
def test_srk_elbo_step_launch_counts_follow_the_code(counted_kernels, adjoint):
    """At the training widths' structure (LATENT, 23 steps): the counts
    :func:`srk_elbo_launches` derives, and no other kernel — no
    ``brownian_increment``, ``brownian_value`` or reversible-Heun launch."""
    cfg = tsde.LatentSDEConfig(**{**LATENT, "num_steps": 23}, solver="srk",
                               exact_adjoint=False)
    params = tsde.latent_sde_init(torch.Generator().manual_seed(3), cfg)
    init, update = tsteps.make_latent_sde_optimizer(LR)
    step = tsteps.make_latent_sde_step(cfg, update, BATCH, 24, adjoint=adjoint, device="cpu")
    step(params, init(params), prng.PRNGKey(4))
    counts = counted_kernels.launch_counts()
    want = srk_elbo_launches(adjoint, 23)
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())


def test_chip_smoke_srk_constants_are_these_formulas():
    import chip_smoke

    assert chip_smoke.SRK_STEP_LAUNCHES == {
        "srk/discretise": srk_elbo_launches("exact", 23),
        "srk/checkpoint": srk_elbo_launches("checkpoint", 23)}
    assert chip_smoke.SRK_VARIANTS == {"srk/discretise": dict(solver="srk"),
                                       "srk/checkpoint": dict(solver="srk",
                                                              adjoint="checkpoint")}


def test_train_cli_srk(capsys):
    """``--solver srk`` trains the Latent SDE (discretise, and checkpoint
    with ``--adjoint checkpoint``); the SDE-GAN's general noise meets the
    reference's named error."""
    base = ["--workload", "latent-sde", "--device", "cpu", "--steps", "1", "--batch", "4",
            "--solver", "srk"]
    for extra in ([], ["--adjoint", "checkpoint"]):
        losses = train_cli.main(base + extra)
        assert len(losses) == 1 and math.isfinite(losses[0])
    assert "done: first -ELBO" in capsys.readouterr().out
    with pytest.raises(ValueError, match="supports noise=\\('diagonal',\\)"):
        train_cli.main(["--workload", "sde-gan", "--device", "cpu", "--steps", "1",
                        "--batch", "4", "--sde-steps", "4", "--seq-len", "5",
                        "--solver", "srk"])
