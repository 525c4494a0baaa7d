"""The SDE-GAN's pieces in the port against the JAX package, on the CPU: the
linear control path, careful clipping and its diagnostics, Adadelta /
``chain`` / the Lipschitz projection, the CDE discriminator stack and
``discriminate_path`` (exact adjoint and discretise), the joint
generator+discriminator fields, the OU data, ``generator_sample``,
``gan_score_fake``, ``gan_losses``, the gradient penalty and the signature
MMD.  Sizes are the JAX suite's ``TINY`` (tests/test_gan_training.py:25-26:
8 solver steps, batch 16, 9 observations) at the default widths; weights
come from the JAX tree through ``params_from_jax``, and every JAX draw runs
inside ``jax_config`` (the ``jax_threefry_partitionable=False`` layout the
port transcribes).

Tolerances (those of tests/test_torch_training.py:9-17), with their reasons:
* bits: clipped trees are bitwise (a clamp rounds nothing); the
  projection's parameters are bitwise ``clip(params + upd)`` inside the
  port; keys and uniforms bitwise.
* data (OU paths, control increments, field values): float32 rtol 1e-5,
  atol 2e-6; float64 rtol 1e-12, atol 1e-13 — XLA contracts multiply-adds
  into FMAs and rounds sigmoid/tanh/erf_inv by an ulp.
* losses, scores, paths after a solve and gradients: float32 rtol 1e-4,
  atol 1e-5; float64 rtol 1e-9, atol 1e-12 — per-ulp field differences
  carried through 8 steps forward and back.
* optimiser states and updates over three Adadelta steps: the data
  tolerance (elementwise arithmetic on the same gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, torch_keys
from repro import optim as joptim
from repro.core import clipping as jclip
from repro.core import losses as jlosses
from repro.core import sde as jsde
from repro.core.paths import LinearPathControl as JaxLinearPathControl
from repro.data.synthetic import ou_process as jax_ou_process
from repro.nn import cde as jcde
from repro_torch import optim, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import clipping, losses
from repro_torch.core import sde as tsde
from repro_torch.core.paths import LinearPathControl
from repro_torch.data import ou_process
from repro_torch.nn import cde

DTYPES = ["float32", "float64"]
DATA_TOL = {"float32": dict(rtol=1e-5, atol=2e-6), "float64": dict(rtol=1e-12, atol=1e-13)}
LOSS_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
TINY = dict(num_steps=8)
BATCH, SEQ = 16, 9


def _close(got, want, tol):
    torch.testing.assert_close(torch.as_tensor(got).detach(),
                               torch.from_numpy(np.array(want)), **tol)


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def _cfgs(dtype, **kw):
    jcfg = jsde.NeuralSDEConfig(**TINY, **kw, dtype=jnp.dtype(dtype))
    tcfg = tsde.NeuralSDEConfig(**TINY, **kw, dtype=TORCH_DTYPES[dtype])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(dtype, seed=70):
    """The JAX GAN's parameters (generator and discriminator) as numpy."""
    with jax_config(x64=dtype == "float64"):
        jcfg, _ = _cfgs(dtype)
        key = jax.random.PRNGKey(seed)
        return jax.device_get({"gen": jsde.generator_init(key, jcfg),
                               "disc": jsde.discriminator_init(jax.random.fold_in(key, 1),
                                                               jcfg)})


def _paths(dtype, seed=71, T=SEQ - 1, batch=BATCH):
    return np.random.default_rng(seed).standard_normal((T + 1, batch, 1)).astype(dtype)


def _grad_leaves(params):
    leaves, spec = tree.flatten(params_from_jax(params))
    leaves = [x.requires_grad_() for x in leaves]
    return leaves, tree.unflatten(spec, leaves)


# -----------------------------------------------------------------------------
# the control path
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("num_steps", [SEQ - 1, 5, 20], ids=["on-grid", "coarser", "finer"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_path_control_increments_match_jax(dtype, num_steps):
    ys = np.random.default_rng(72).standard_normal((SEQ, 3, 2)).astype(dtype)
    with jax_config(x64=dtype == "float64"):
        inc = jax.jit(lambda y, n: JaxLinearPathControl(y).increment(n, num_steps))
        want = [np.asarray(inc(ys, n)) for n in range(num_steps)]
    control = LinearPathControl(torch.from_numpy(ys))
    for n in range(num_steps):
        got = control.increment(n, num_steps)
        assert got.shape == (3, 2) and got.dtype == TORCH_DTYPES[dtype]
        if num_steps == SEQ - 1:
            assert torch.equal(got, torch.from_numpy(ys[n + 1] - ys[n]))
        _close(got, want[n], DATA_TOL[dtype])


# -----------------------------------------------------------------------------
# careful clipping
# -----------------------------------------------------------------------------


def _wild_disc(dtype):
    """A discriminator tree far outside the clipping box (x10)."""
    return {k: jax.tree.map(lambda x: x * 10.0, v) for k, v in _params(dtype)["disc"].items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_clipping_functions_match_jax_bitwise(dtype):
    disc = _wild_disc(dtype)
    structural = {"vf": {"layers": [{"w": np.full((8, 4), 3.0, dtype), "b": np.ones(4, dtype)}]},
                  "nested": [{"layers": [{"w": np.full((2, 2), -5.0, dtype)}]}],
                  "readout": {"w": np.full((4, 1), 7.0, dtype)}}
    with jax_config(x64=dtype == "float64"):
        want = jax.device_get({"linear": jclip.clip_linear(disc["m"]),
                               "mlp": jclip.clip_mlp(disc["f"]),
                               "pytree": jclip.clip_pytree(structural),
                               "lipschitz": jclip.clip_lipschitz(disc)})
    tdisc = params_from_jax(disc)
    got = {"linear": clipping.clip_linear(tdisc["m"]), "mlp": clipping.clip_mlp(tdisc["f"]),
           "pytree": clipping.clip_pytree(params_from_jax(structural)),
           "lipschitz": clipping.clip_lipschitz(tdisc)}
    for name in want:
        g_leaves, w_leaves = tree.leaves(got[name]), jax.tree.leaves(want[name])
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            assert torch.equal(g, torch.from_numpy(np.array(w))), name
    # the readout passes through, and the input tree is not edited
    assert torch.equal(got["lipschitz"]["m"]["w"], tdisc["m"]["w"])
    assert torch.equal(tdisc["f"]["layers"][0]["w"], torch.from_numpy(disc["f"]["layers"][0]["w"]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_clipping_diagnostics_match_jax(dtype):
    disc = _wild_disc(dtype)
    with jax_config(x64=dtype == "float64"):
        want = {name: (np.asarray(jclip.lipschitz_bound_mlp(disc[name])),
                       float(jclip.per_layer_violation(disc[name]))) for name in ("f", "g", "xi")}
        want_max = np.asarray(jclip.max_lipschitz_bound(disc))
        want_clipped = np.asarray(jclip.max_lipschitz_bound(jclip.clip_lipschitz(disc)))
    tdisc = params_from_jax(disc)
    for name, (bound, violation) in want.items():
        _close(clipping.lipschitz_bound_mlp(tdisc[name]), bound, DATA_TOL[dtype])
        assert clipping.per_layer_violation(tdisc[name]).item() == violation  # one product
        assert violation > 1.0
    _close(clipping.max_lipschitz_bound(tdisc), want_max, DATA_TOL[dtype])
    clipped = clipping.clip_lipschitz(tdisc)
    _close(clipping.max_lipschitz_bound(clipped), want_clipped, DATA_TOL[dtype])
    for name in ("f", "g", "xi"):
        assert clipping.per_layer_violation(clipped[name]).item() <= 1.0


# -----------------------------------------------------------------------------
# Adadelta, chain, the projection
# -----------------------------------------------------------------------------


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype), params)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adadelta_chain_projection_three_updates_match_jax(dtype):
    disc = _params(dtype)["disc"]
    grads = [_grads_like(disc, 73 + i) for i in range(3)]
    with jax_config(x64=dtype == "float64"):
        want = []
        for opt in (joptim.adadelta(1.0), joptim.chain(
                joptim.adadelta(1.0), joptim.lipschitz_projection(jclip.clip_lipschitz))):
            init, update = opt
            p, state = disc, init(disc)
            for g in grads:
                upd, state = update(g, state, p)
                p = joptim.apply_updates(p, upd)
            want.append(jax.device_get((p, state)))
    for (init, update), (want_p, want_state) in zip(
            (optim.adadelta(1.0), optim.chain(
                optim.adadelta(1.0), optim.lipschitz_projection(clipping.clip_lipschitz))),
            want):
        p = params_from_jax(disc)
        state = init(p)
        for g in grads:
            upd, state = update(params_from_jax(g), state, p)
            p = optim.apply_updates(p, upd)
        for a, b in zip(tree.leaves(p), jax.tree.leaves(want_p)):
            _close(a, b, DATA_TOL[dtype])
        got_state = tree.leaves(state)
        want_leaves = jax.tree.leaves(want_state)
        assert len(got_state) == len(want_leaves)
        for a, b in zip(got_state, want_leaves):
            if isinstance(a, int):
                assert a == int(b) == 3
            else:
                _close(a, b, DATA_TOL[dtype])
    for name in ("f", "g", "xi"):
        assert clipping.per_layer_violation(p[name]).item() <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_projection_lands_on_clipped_parameters(dtype):
    """chain(adadelta, projection) ≡ clip(params + adadelta's update): the
    transform is clip-after-update rearranged to compose.  Bitwise from the
    discriminator's init (inside the box, where ``c − p`` is exact).  From a
    tree far outside the box (x10) ``p + (c − p)`` rounds twice, as the
    reference's does (its own test holds it to atol 1e-7): there within
    one rounding of ``c`` (2 eps relative), and an entry clipped to the box
    edge may land one ulp outside it."""
    for wild, disc in ((False, _params(dtype)["disc"]), (True, _wild_disc(dtype))):
        disc = params_from_jax(disc)
        grads = params_from_jax(_grads_like(_params(dtype)["disc"], 74))
        ai, au = optim.adadelta(1.0)
        upd, _ = au(grads, ai(disc), disc)
        want = clipping.clip_lipschitz(optim.apply_updates(disc, upd))
        ci, cu = optim.chain(optim.adadelta(1.0),
                             optim.lipschitz_projection(clipping.clip_lipschitz))
        upd2, state = cu(grads, ci(disc), disc)
        got = optim.apply_updates(disc, upd2)
        assert state[1] == ()
        eps = torch.finfo(TORCH_DTYPES[dtype]).eps
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            if wild:
                torch.testing.assert_close(a, b, rtol=2 * eps, atol=0)
            else:
                assert torch.equal(a, b)
        for name in ("f", "g", "xi"):
            assert clipping.per_layer_violation(got[name]).item() <= (1 + 2 * eps if wild else 1)
    with pytest.raises(ValueError, match="needs params"):
        optim.lipschitz_projection()[1](upd, (), None)


def test_swa_update_matches_jax():
    avg = {"a": np.linspace(-1, 1, 7).astype("float32")}
    p = {"a": np.linspace(2, 3, 7).astype("float32")}
    want = jax.device_get(joptim.swa_update(avg, p, 3))
    got = optim.swa_update(params_from_jax(avg), params_from_jax(p), 3)
    _close(got["a"], want["a"], DATA_TOL["float32"])


# -----------------------------------------------------------------------------
# the CDE discriminator
# -----------------------------------------------------------------------------


def test_cde_init_draws_inside_the_box():
    spec = cde.CDEDiscriminatorSpec()
    p = cde.cde_discriminator_init(torch.Generator().manual_seed(0), spec)
    want = jcde.cde_discriminator_init(jax.random.PRNGKey(0), jcde.CDEDiscriminatorSpec())
    assert [np.shape(x) for x in jax.tree.leaves(want)] == [tuple(x.shape)
                                                           for x in tree.leaves(p)]
    for name in ("f", "g", "xi"):
        assert clipping.per_layer_violation(p[name]).item() <= 1.0
        assert clipping.lipschitz_bound_mlp(p[name]).item() <= 1.0 + 1e-6
    assert p["g"]["layers"][-1]["w"].shape == (32, 16 * 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cde_functions_match_jax(dtype):
    disc = _params(dtype)["disc"]
    rng = np.random.default_rng(75)
    h = rng.standard_normal((BATCH, 16)).astype(dtype)
    y0 = rng.standard_normal((BATCH, 1)).astype(dtype)
    t = np.asarray(0.375, dtype)
    spec_kw = dict(data_dim=1, hidden_dim=16, width=32, depth=1)
    with jax_config(x64=dtype == "float64"):
        jspec = jcde.CDEDiscriminatorSpec(**spec_kw, dtype=jnp.dtype(dtype))
        want = jax.device_get(jax.jit(lambda p: {
            "initial": jcde.cde_initial(p, t, y0), "f": jcde.cde_drift(jspec)(p, t, h),
            "g": jcde.cde_control_field(jspec)(p, t, h), "m": jcde.cde_readout(p, h)})(disc))
    spec = cde.CDEDiscriminatorSpec(**spec_kw, dtype=TORCH_DTYPES[dtype])
    p, ht = params_from_jax(disc), torch.from_numpy(h)
    got = {"initial": cde.cde_initial(p, torch.from_numpy(t), torch.from_numpy(y0)),
           "f": cde.cde_drift(spec)(p, t, ht), "g": cde.cde_control_field(spec)(p, t, ht),
           "m": cde.cde_readout(p, ht)}
    assert got["g"].shape == (BATCH, 16, 2) and got["m"].shape == (BATCH,)
    for name in want:
        _close(got[name], want[name], DATA_TOL[dtype])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "discretise"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_discriminate_path_and_its_gradients_match_jax(dtype, exact):
    disc = _params(dtype)["disc"]
    ys = _paths(dtype)
    jcfg, tcfg = _cfgs(dtype)
    with jax_config(x64=dtype == "float64"):
        def loss(p, y):
            return jnp.sum(jsde.discriminate_path(p, jcfg, y, exact_adjoint=exact) ** 2)
        score = jax.jit(lambda p, y: jsde.discriminate_path(p, jcfg, y, exact_adjoint=exact))(
            disc, ys)
        gp, gy = jax.jit(jax.grad(loss, argnums=(0, 1)))(disc, ys)
        score, gp, gy = jax.device_get((score, gp, gy))
    leaves, p = _grad_leaves(disc)
    y = torch.from_numpy(ys).requires_grad_()
    got = tsde.discriminate_path(p, tcfg, y, exact_adjoint=exact)
    _close(got, score, LOSS_TOL[dtype])
    grads = torch.autograd.grad(torch.sum(got ** 2), [*leaves, y])
    for g, w in zip(grads, jax.tree.leaves(gp)):
        _close(g, w, LOSS_TOL[dtype])
    _close(grads[-1], gy, LOSS_TOL[dtype])
    if exact:  # no cotangent through the control: the path's gradient is H_0's
        assert not np.any(gy[1:]) and not grads[-1][1:].any()


# -----------------------------------------------------------------------------
# the joint solve, the data, the losses
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_joint_fields_match_jax(dtype):
    params = _params(dtype)
    u = np.random.default_rng(76).standard_normal((BATCH, 32)).astype(dtype)
    t = np.asarray(0.625, dtype)
    jcfg, tcfg = _cfgs(dtype)
    with jax_config(x64=dtype == "float64"):
        want = jax.device_get(jax.jit(lambda p: (jsde.joint_drift(jcfg)(p, t, u),
                                                 jsde.joint_diffusion(jcfg)(p, t, u)))(params))
    tp, ut = params_from_jax(params), torch.from_numpy(u)
    drift, diffusion = tsde.joint_drift(tcfg)(tp, t, ut), tsde.joint_diffusion(tcfg)(tp, t, ut)
    assert drift.shape == (BATCH, 32) and diffusion.shape == (BATCH, 32, 4)
    _close(drift, want[0], DATA_TOL[dtype])
    _close(diffusion, want[1], DATA_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ou_process_matches_jax(dtype):
    with jax_config(x64=dtype == "float64"):
        key = _jkey(77)
        want = np.asarray(jax_ou_process(key, BATCH, SEQ, dtype=jnp.dtype(dtype)))
    got = ou_process(torch_keys(key), BATCH, SEQ, dtype=TORCH_DTYPES[dtype])
    assert got.shape == (SEQ, BATCH, 1) and got.dtype == TORCH_DTYPES[dtype]
    _close(got, want, DATA_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_generator_sample_and_fake_score_match_jax(dtype):
    params = _params(dtype)
    jcfg, tcfg = _cfgs(dtype)
    with jax_config(x64=dtype == "float64"):
        key = _jkey(78)
        sample = jax.jit(lambda p: jsde.generator_sample(p, jcfg, key, BATCH))(params["gen"])
        score, ys = jax.jit(lambda p: jsde.gan_score_fake(p, jcfg, key, BATCH))(params)
        sample, score, ys = jax.device_get((sample, score, ys))
    tp = params_from_jax(params)
    got = tsde.generator_sample(tp["gen"], tcfg, torch_keys(key), BATCH)
    assert got.shape == (9, BATCH, 1)
    _close(got, sample, LOSS_TOL[dtype])
    got_score, got_ys = tsde.gan_score_fake(tp, tcfg, torch_keys(key), BATCH)
    assert got_score.shape == (BATCH,)
    _close(got_score, score, LOSS_TOL[dtype])
    _close(got_ys, ys, LOSS_TOL[dtype])
    # one joint solve draws the generator's own noise: its paths are the sample's
    torch.testing.assert_close(got_ys, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gan_score_fake_terminal_form_equals_the_trajectory_form(dtype):
    """``paths=False`` (the clip step's solve, O(1) states) gives the same
    score and the same gradients bitwise, and no paths."""
    _, tcfg = _cfgs(dtype)
    key = torch_keys(_jkey(78))
    runs = []
    for paths in (True, False):
        leaves, tp = _grad_leaves(_params(dtype))
        score, ys = tsde.gan_score_fake(tp, tcfg, key, BATCH, paths=paths)
        assert (ys is None) == (not paths)
        runs.append((score.detach(), torch.autograd.grad(score.mean(), leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gan_losses_and_gradients_match_jax(dtype):
    params = _params(dtype)
    y_real = _paths(dtype)
    jcfg, tcfg = _cfgs(dtype)
    with jax_config(x64=dtype == "float64"):
        key = _jkey(79)

        def both(p):
            gl, dl, _ = jsde.gan_losses(p, jcfg, key, y_real, BATCH)
            return gl + 2.0 * dl, (gl, dl)

        (_, (gl, dl)), grads = jax.jit(jax.value_and_grad(both, has_aux=True))(params)
        gl, dl, grads = jax.device_get((gl, dl, grads))
    leaves, tp = _grad_leaves(params)
    got_gl, got_dl, fake = tsde.gan_losses(tp, tcfg, torch_keys(key), torch.from_numpy(y_real),
                                           BATCH)
    assert fake.shape == (9, BATCH, 1)
    _close(got_gl, gl, LOSS_TOL[dtype])
    _close(got_dl, dl, LOSS_TOL[dtype])
    got_grads = torch.autograd.grad(got_gl + 2.0 * got_dl, leaves)
    for g, w in zip(got_grads, jax.tree.leaves(grads)):
        _close(g, w, LOSS_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradient_penalty_and_its_gradients_match_jax(dtype):
    disc = _params(dtype)["disc"]
    y_real, y_fake = _paths(dtype, 80), _paths(dtype, 81)
    jcfg, tcfg = _cfgs(dtype)
    with jax_config(x64=dtype == "float64"):
        key = _jkey(82)
        gp, grads = jax.jit(jax.value_and_grad(
            lambda p: jsde.gradient_penalty(p, jcfg, key, y_real, y_fake)))(disc)
        gp, grads = jax.device_get((gp, grads))
    leaves, tp = _grad_leaves(disc)
    got = tsde.gradient_penalty(tp, tcfg, torch_keys(key), torch.from_numpy(y_real),
                                torch.from_numpy(y_fake))
    _close(got, gp, LOSS_TOL[dtype])
    got_grads = torch.autograd.grad(got, leaves, allow_unused=True)
    assert [g is None for g in got_grads] == [not np.any(w) for w in jax.tree.leaves(grads)]
    for g, w in zip(got_grads, jax.tree.leaves(grads)):
        if g is not None:  # the readout's bias does not reach ∂F/∂Y
            _close(g, w, LOSS_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_signature_and_mmd_match_jax(dtype):
    rng = np.random.default_rng(83)
    y_p, y_q = (rng.standard_normal((SEQ, BATCH, 1)).astype(dtype) for _ in range(2))
    path = rng.standard_normal((SEQ, 5, 3)).astype(dtype)
    with jax_config(x64=dtype == "float64"):
        want_sig = np.asarray(jlosses.signature(path, depth=3))
        want_aug = np.asarray(jlosses.time_augment(y_p))
        want_mmd = np.asarray(jlosses.signature_mmd(y_p, y_q))
        want_w = jax.device_get(jlosses.wasserstein_losses(y_p[0, :, 0], y_q[0, :, 0]))
    got_sig = losses.signature(torch.from_numpy(path), depth=3)
    assert got_sig.shape == (5, 3 + 9 + 27)
    _close(got_sig, want_sig, DATA_TOL[dtype])
    _close(losses.time_augment(torch.from_numpy(y_p)), want_aug, DATA_TOL[dtype])
    _close(losses.signature_mmd(torch.from_numpy(y_p), torch.from_numpy(y_q)), want_mmd,
           DATA_TOL[dtype])
    for g, w in zip(losses.wasserstein_losses(torch.from_numpy(y_p[0, :, 0]),
                                              torch.from_numpy(y_q[0, :, 0])), want_w):
        _close(g, w, DATA_TOL[dtype])
