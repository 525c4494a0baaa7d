"""The port's LM training on the CPU against the JAX package: the token
pipeline (bitwise), the cosine schedule, global-norm clipping and AdamW
(float32 moments over bfloat16 parameters, the reference's promotion of
the parameters to float32), one and two jitted ``make_train_step`` steps on
the dense and SSM smoke configs and dbrx-132b's (MoE: the router's and
the experts' gradients and the aux loss weighted 0.01 into the loss;
weights carried across with ``params_from_jax``), the per-unit checkpoint
(remat, with a MoE and the hybrid stack too), the loss's CPU route, the
train CLI with its resume (and a MoE and the hybrid arch), and checkpoints
crossing between the two packages in both directions.

Tolerances, float32: the loss, ``xent``, ``moe_aux`` and ``grad_norm`` rtol
= 1e-5 (the same ops summed in other orders: XLA's CPU dots against torch's BLAS, the
reference's blockwise attention against the port's plain softmax); the
parameters after a step within 2·lr of the reference's (Adam's first
update is ±lr·sign(m) for a gradient above eps, so a gradient component at
the noise floor may flip its sign); the moments rtol = 1e-4 with an atol of
1e-5 of the leaf's largest magnitude (they carry the gradients' float32
noise, squared in v).  The CUDA kernels are held to their plain versions
on the card (chip_smoke.py phases 18–21, tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import optim as joptim
from repro.data.synthetic import token_batches as jax_token_batches
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.data import token_batches
from repro_torch.kernels import prng
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T

ARCHS = ["tinyllama-1.1b", "qwen2.5-14b", "starcoder2-3b", "mamba2-1.3b", "dbrx-132b"]
B, S = 2, 32
RTOL = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_tokens(B, S, V, step=0, seed=0):
    with jax_config():
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        out = jax_token_batches(key, jnp.int32(step), B, S, V)
        return {k: np.array(v) for k, v in out.items()}


def _port_tokens(B, S, V, step=0, seed=0):
    key = prng.fold_in_key(prng.PRNGKey(seed), 1)
    return token_batches(key, step, B, S, V)


# -----------------------------------------------------------------------------
# data
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,V", [(2, 32, 256), (8, 64, 256), (4, 2048, 32000)])
def test_token_batches_bitwise(B, S, V):
    for step in (0, 3):
        want = _jax_tokens(B, S, V, step)
        got = _port_tokens(B, S, V, step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].shape == (B, S)
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# -----------------------------------------------------------------------------
# optimizer pieces
# -----------------------------------------------------------------------------


def test_cosine_schedule_matches_reference():
    jl = joptim.cosine_schedule(3e-4, 100, 1000)
    tl = optim.cosine_schedule(3e-4, 100, 1000)
    for step in (0, 1, 7, 99, 100, 101, 550, 999, 1000, 1500):
        want = float(jl(jnp.int32(step)))
        assert float(np.float32(tl(step))) == tl(step)  # a float32 value
        np.testing.assert_allclose(tl(step), want, rtol=1e-7, err_msg=f"step {step}")


def _grad_tree(seed):
    r = np.random.default_rng(seed)
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return {"b": f32(7), "a": {"w": f32(3, 5)}, "c": [f32(4), f32(2, 2)]}


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grad_tree(0)
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = optim.clip_by_global_norm(tree.map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree.leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_adamw_float32_moments_promote_bfloat16_parameters():
    """clip → AdamW (moments float32) → apply_updates over bfloat16
    parameters: the reference's parameters and updates come out float32
    (its float32 lr_t promotes the decay term), and so do the port's."""
    r = np.random.default_rng(1)
    p32 = {"w": r.standard_normal((6, 4)).astype(np.float32),
           "g": r.standard_normal(4).astype(np.float32)}
    g32 = tree.map(lambda a: (0.1 * a).astype(np.float32), p32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p32)
    jgr = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), g32)
    tp = params_from_jax(jax.device_get(jp))
    tg = params_from_jax(jax.device_get(jgr))
    sched = (joptim.cosine_schedule(1e-2, 1, 10), optim.cosine_schedule(1e-2, 1, 10))
    ji, ju = joptim.adamw(sched[0], moment_dtype="float32")
    ti, tu = optim.adamw(sched[1], moment_dtype="float32")
    js, ts = ji(jp), ti(tp)
    for _ in range(2):
        jgc, _ = joptim.clip_by_global_norm(jgr, 0.5)
        tgc, _ = optim.clip_by_global_norm(tg, 0.5)
        jupd, js = ju(jgc, js, jp)
        tupd, ts = tu(tgc, ts, tp)
        jp = joptim.apply_updates(jp, jupd)
        tp = optim.apply_updates(tp, tupd)
        jgr = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jgr)
    for name in ("w", "g"):
        assert jp[name].dtype == jnp.float32 and tp[name].dtype == torch.float32
        assert js.m[name].dtype == jnp.float32 and ts.m[name].dtype == torch.float32
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ts.v[name].numpy(), np.asarray(js.v[name]), rtol=1e-6,
                                   atol=1e-12)
    assert ts.step == int(js.step) == 2


def test_adam_moment_dtype_defaults_to_the_parameters():
    init, _ = optim.adam(1e-3)
    st = init({"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert st.m["w"].dtype == torch.bfloat16
    init, _ = optim.adam(1e-3, moment_dtype="float32")
    assert init({"w": torch.zeros(3, dtype=torch.bfloat16)}).v["w"].dtype == torch.float32


# -----------------------------------------------------------------------------
# one and two train steps against the jitted reference
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def two_steps(request):
    """(arch, port cfg, port params, JAX states after steps 1 and 2, batch)."""
    arch = request.param
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        jinit, jupd = jsteps.make_optimizer(jcfg)
        jstep = jax.jit(jsteps.make_train_step(jcfg, jupd))
        state = (jparams, jinit(jparams))
        batch = _jax_tokens(B, S, jcfg.vocab)
        outs = []
        for _ in range(2):
            p, o, m = jstep(*state, {k: jnp.asarray(v) for k, v in batch.items()})
            state = (p, o)
            outs.append(jax.device_get((p, o, m)))
    return arch, cfg, params_from_jax(jax.device_get(jparams)), outs, batch


def _close_state(params, opt_state, metrics, want, lr):
    jp, jo, jm = want
    for k in ("loss", "xent", "grad_norm", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics["xent"]) + 0.01 * float(metrics["moe_aux"]),
                               rtol=1e-6)
    for a, b in zip(tree.leaves(params), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=2 * lr)
    assert opt_state.step == int(jo.step)
    for mine, ref_ in ((opt_state.m, jo.m), (opt_state.v, jo.v)):
        for a, b in zip(tree.leaves(mine), jax.tree.leaves(ref_)):
            b = np.asarray(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


def test_train_step_matches_jax_step(two_steps):
    arch, cfg, params, outs, batch = two_steps
    init, update = steps.make_optimizer(cfg)
    step_fn = steps.make_train_step(cfg, update)
    got = step_fn(params, init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    _close_state(*got, outs[0], lr=optim.cosine_schedule(3e-4, 100, 10_000)(1))


def test_two_train_steps_match_jax(two_steps):
    arch, cfg, params, outs, batch = two_steps
    init, update = steps.make_optimizer(cfg)
    step_fn = steps.make_train_step(cfg, update)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p, o, _ = step_fn(params, init(params), tb)
    p, o, m = step_fn(p, o, tb)
    lr = optim.cosine_schedule(3e-4, 100, 10_000)
    _close_state(p, o, m, outs[1], lr=lr(1) + lr(2))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "dbrx-132b",
                                  "jamba-v0.1-52b"])
def test_remat_gives_the_same_loss_and_gradients_bitwise(arch):
    cfg = configs.smoke_config(arch)
    params = T.init_lm(torch.Generator().manual_seed(3), cfg)
    batch = _port_tokens(B, S, cfg.vocab)

    def grads(c):
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, _ = T.lm_loss(tree.unflatten(spec, leaves), c, batch)
        return loss, torch.autograd.grad(loss, leaves)

    loss0, g0 = grads(dataclasses.replace(cfg, remat=False))
    loss1, g1 = grads(dataclasses.replace(cfg, remat=True))
    assert torch.equal(loss0, loss1) and len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_collectives_policy_is_not_ported():
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), remat=True,
                              remat_policy="collectives")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(T.NotPortedError, match="collectives"):
        T.lm_loss(params, cfg, _port_tokens(1, 8, cfg.vocab))
    with torch.no_grad():  # serving never checkpoints
        T.lm_forward(params, cfg, _port_tokens(1, 8, cfg.vocab)["tokens"])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-1.3b", "grok-1-314b", "jamba-v0.1-52b"])
def test_lm_loss_cpu_route_is_softmax_xent_and_matches_jax(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.device_get(jparams))
    batch = _jax_tokens(B, S, cfg.vocab, step=5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, parts = T.lm_loss(params, cfg, tb)
    logits, _ = T.lm_forward(params, cfg, tb["tokens"])
    assert torch.equal(parts["xent"], T.softmax_xent(logits, tb["labels"]))
    jloss, jparts = JT.lm_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]), rtol=RTOL)
    np.testing.assert_allclose(float(parts["moe_aux"]), float(jparts["moe_aux"]), rtol=RTOL)
    assert (float(parts["moe_aux"]) > 0) == cfg.moe


# -----------------------------------------------------------------------------
# the train CLI and checkpoints
# -----------------------------------------------------------------------------


def test_train_cli_lm_on_cpu_and_resume(tmp_path, capsys):
    args = ["--workload", "lm", "--device", "cpu", "--batch", "2", "--seq", "16"]
    full = train_cli.main(args + ["--steps", "3"])
    assert len(full) == 3 and all(np.isfinite(full))
    out = capsys.readouterr().out
    assert "mesh plan: data=1 model=1 (1 devices)" in out and "done: first loss" in out
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated node failure at step 2"):
        train_cli.main(args + ["--steps", "3", "--ckpt-dir", d, "--ckpt-every", "1",
                               "--fail-at-step", "2"])
    assert ckpt.latest_step(d) == 2
    resumed = train_cli.main(args + ["--steps", "3", "--ckpt-dir", d])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == full[2:]


@pytest.mark.parametrize("arch", ["grok-1-314b", "jamba-v0.1-52b"])
def test_train_cli_trains_the_moe_and_hybrid_archs(arch, capsys):
    """The CLI's LM loop on a MoE and the hybrid smoke config; one gradient
    of the loss reaches the router (through the combine's weights and the
    aux loss) and every expert, finite."""
    losses = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: first loss" in capsys.readouterr().out
    cfg = configs.smoke_config(arch)
    params = T.init_lm(torch.Generator().manual_seed(4), cfg)
    leaves, spec = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, parts = T.lm_loss(tree.unflatten(spec, leaves), cfg, _port_tokens(B, S, cfg.vocab))
    grads = tree.unflatten(spec, torch.autograd.grad(loss, leaves))
    assert parts["moe_aux"].item() > 0
    moe = [u["ffn"] for u in grads["units"] if "ffn" in u and "router" in u["ffn"]]
    assert moe and all(torch.isfinite(g).all() for f in moe for g in f.values())
    assert all(f["router"].abs().sum() > 0 for f in moe)


def test_resume_restores_bfloat16_runs_as_the_step_left_them(tmp_path):
    """A bfloat16 model's parameters are float32 after a step; a resumed run
    restores them so and continues bitwise."""
    kw = dict(batch=2, seq=8, smoke=True, device="cpu", log_every=100)
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), dtype=torch.bfloat16)
    p0 = T.init_lm(torch.Generator().manual_seed(0), cfg)
    p_full, full = train_cli.train("tinyllama-1.1b", 3, ckpt_dir=None, params=p0, **kw)
    train_cli.train("tinyllama-1.1b", 2, ckpt_dir=str(tmp_path), params=p0, **kw)
    p_res, res = train_cli.train("tinyllama-1.1b", 3, ckpt_dir=str(tmp_path), params=p0, **kw)
    assert res == full[2:]
    assert all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(tree.leaves(p_res), tree.leaves(p_full)))


def test_train_cli_lm_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.device import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        train_cli.main(["--steps", "1"])


@pytest.fixture(scope="module")
def stepped_state():
    """A JAX (params, OptState) after one step on the tinyllama smoke config,
    and the port's template for it."""
    jcfg, cfg = jconfigs.smoke_config("tinyllama-1.1b"), configs.smoke_config("tinyllama-1.1b")
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(2), jcfg)
        jinit, jupd = jsteps.make_optimizer(jcfg)
        batch = {k: jnp.asarray(v) for k, v in _jax_tokens(B, S, jcfg.vocab).items()}
        state = jax.jit(jsteps.make_train_step(jcfg, jupd))(jparams, jinit(jparams), batch)[:2]
    tparams = T.init_lm(torch.Generator().manual_seed(0), cfg)
    template = (tparams, steps.make_optimizer(cfg)[0](tparams))
    return state, template


def test_jax_checkpoint_restores_in_the_port(tmp_path, stepped_state):
    state, template = stepped_state
    jckpt.save_checkpoint(tmp_path, 1, state)
    assert ckpt.latest_step(tmp_path) == 1
    (params, opt), step = ckpt.restore_checkpoint(tmp_path, template)
    assert step == 1 and opt.step == 1
    for a, b in zip(tree.leaves((params, opt.m, opt.v)),
                    jax.tree.leaves((state[0], state[1].m, state[1].v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_checkpoint_restores_in_jax(tmp_path, stepped_state):
    state, template = stepped_state
    params = tree.map(lambda a: a + 1.0, template[0])
    opt = template[1]._replace(step=4)
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(tmp_path, s, (params, opt), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000000003",
                                                           "step_000000000004"]
    (jp, jo), step = jckpt.restore_checkpoint(tmp_path, state)
    assert step == 4 and int(jo.step) == 4 and jo.step.dtype == jnp.int32
    for a, b in zip(tree.leaves((params, opt.m, opt.v)), jax.tree.leaves((jp, jo.m, jo.v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_keeps_bfloat16_words(tmp_path):
    t = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    ckpt.save_checkpoint(tmp_path, 7, t)
    back, step = ckpt.restore_checkpoint(tmp_path, {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    assert step == 7 and torch.equal(back["w"], t["w"])
