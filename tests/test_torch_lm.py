"""The port's decoder-only LMs on the CPU against the JAX package, at the
smoke size of qwen2.5-14b, tinyllama-1.1b, starcoder2-3b (dense),
dbrx-132b, grok-1-314b (MoE), mamba2-1.3b (pure SSM) and jamba-v0.1-52b
(hybrid: attention, Mamba2 and MoE in one 8-layer unit), float32: weights
from the reference's ``init_lm(PRNGKey(0))`` carried across with
``params_from_jax``; RoPE, GQA attention and the FFN (dense); the Mamba2
mixer's prefill (output, conv window and SSM state) and recurrent decode
step; the forward logits and the MoE aux loss, prefill (logits and the
caches, jamba's mixed list of one attention and seven Mamba2 caches), 8
greedy decode steps, the parameter count, the served tokens and prompts;
bfloat16 weights carried across bitwise (a Mamba2 model keeps its float32
leaves, a MoE model its float32 router), and a bfloat16 prefill and 12
decode steps of qwen2.5-14b, mamba2-1.3b and dbrx-132b against the
reference.  The MoE layer alone: tests/test_torch_moe.py.

Tolerance, float32: rtol = atol = 1e-5.  Both sides compute the same ops
in float32; the sums run in other orders (XLA's CPU dot against torch's
BLAS; the reference's blockwise online softmax against the port's plain
softmax on the CPU; the reference's chunked SSD form against the port's
plain recurrence) and exp, sigmoid and pow differ by ulps, which leaves
differences of at most ~2e-6 on logits of magnitude up to ~4 after two
layers (measured on the dense configs).  jamba's smoke stack is one
8-layer unit, and the rounding grows with the depth: against the same
model run in float64 by the reference, the reference's own float32 run
misses by up to 1.36e-5 over its prefill and 8 decode steps and the port's
by 1.26e-5 (the port against the reference: 1.49e-5), so that 8-layer stack is held to rtol =
atol = 2e-5 (DEEP_TOL).  Tokens are compared exactly.  bfloat16 jamba is
not compared logit by logit: its router logits differ from the reference's
by up to 0.07 (bf16 roundings through 8 layers) and 3 of its 384 top-2
routes flip at gaps of 0.001–0.017, which moves the logits far more than
any rounding; its bf16 weights, prefill and decode run here
(tests/test_torch_moe.py) and on the card (chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import counting as jcounting
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.models import counting
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DENSE = ["qwen2.5-14b", "tinyllama-1.1b", "starcoder2-3b"]
ARCHS = DENSE + ["dbrx-132b", "grok-1-314b", "mamba2-1.3b", "jamba-v0.1-52b"]
TOL = dict(rtol=1e-5, atol=1e-5)
DEEP_TOL = dict(rtol=2e-5, atol=2e-5)  # an 8-layer smoke stack (jamba's one unit)
BF16_LOGIT_RTOL = 0.025


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX cfg, port cfg, JAX params, port params)."""
    arch = request.param
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, cfg, jparams, params_from_jax(jax.device_get(jparams))


def _tokens(cfg, B, S, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S), dtype=np.int32)


def _close(got, want, cfg=None):
    tol = DEEP_TOL if cfg is not None and cfg.num_layers > 2 else TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_smoke_config_matches_reference(model):
    arch, jcfg, cfg, _, _ = model
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32


@pytest.mark.parametrize("model", DENSE, indirect=True)
def test_rope_matches_jax(model):
    _, jcfg, cfg, _, _ = model
    x = np.random.default_rng(1).standard_normal((2, 9, 3, cfg.head_dim), dtype=np.float32)
    pos = np.arange(9, dtype=np.int32)
    jcos, jsin = JL.rope_freqs(jcfg.head_dim, jcfg.rope_theta, jnp.asarray(pos))
    cos, sin = L.rope_freqs(cfg.head_dim, cfg.rope_theta, torch.from_numpy(pos))
    _close(cos, jcos)
    _close(sin, jsin)
    _close(L.apply_rope(torch.from_numpy(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("model", DENSE, indirect=True)
def test_gqa_attend_and_ffn_match_jax(model):
    _, jcfg, cfg, jparams, params = model
    x = np.random.default_rng(2).standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    jblock = jax.tree.map(lambda a: a[0], jparams["units"][0])
    block = T._layer(params["units"], 0)[0]
    jo, (jk, jv) = JL.gqa_attend(jblock["mixer"], jcfg, jnp.asarray(x))
    o, (k, v) = L.gqa_attend(block["mixer"], cfg, torch.from_numpy(x))
    for a, b in ((o, jo), (k, jk), (v, jv)):
        _close(a, b)
    _close(L.ffn_apply(block["ffn"], cfg, torch.from_numpy(x)),
           JL.ffn_apply(jblock["ffn"], jcfg, jnp.asarray(x)))


def test_lm_forward_logits_match_jax(model):
    _, jcfg, cfg, jparams, params = model
    tok = _tokens(cfg, 2, 16)
    jlogits, jaux = JT.lm_forward(jparams, jcfg, jnp.asarray(tok))
    logits, aux = T.lm_forward(params, cfg, torch.from_numpy(tok))
    assert logits.shape == (2, 16, cfg.vocab) and aux.dtype == torch.float32
    _close(logits, jlogits, cfg)
    _close(aux, jaux, cfg)
    assert (float(aux) > 0) == cfg.moe


def test_prefill_and_eight_decode_steps_match_jax(model):
    """Prefill logits and the padded caches, then 8 greedy decode steps:
    tokens equal, logits within the tolerance."""
    _, jcfg, cfg, jparams, params = model
    B, S, gen = 2, 12, 8
    tok = _tokens(cfg, B, S, seed=4)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, max_len=S + gen))
    jdecode = jax.jit(jsteps.make_serve_step(jcfg))
    jlogits, jcaches = jprefill(jparams, {"tokens": jnp.asarray(tok)})
    logits, caches = steps.make_prefill_step(cfg, max_len=S + gen)(
        params, {"tokens": torch.from_numpy(tok)})
    _close(logits, jlogits, cfg)
    jleaves, leaves = jax.tree.leaves(jcaches), tree.leaves(caches)
    U, shapes = T.num_units(cfg), []
    for mixer, _ in T.unit_pattern(cfg):
        if mixer == "mamba":  # conv window, SSM state: no sequence axis, nothing padded
            shapes += [((U, B, cfg.ssm_conv - 1, cfg.ssm_inner + 2 * cfg.ssm_state), False),
                       ((U, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim), False)]
        else:
            shapes += [((U, B, S + gen, cfg.num_kv_heads, cfg.head_dim), True)] * 2
    assert len(leaves) == len(jleaves) == len(shapes)
    for a, b, (shape, padded) in zip(leaves, jleaves, shapes):
        assert tuple(a.shape) == b.shape == shape
        _close(a, b, cfg)
        if padded:
            assert not a[:, :, S:].any()
    zeros = T.init_cache_zeros(cfg, B, S + gen)
    assert [(k, tuple(a.shape)) for c in zeros for k, a in sorted(c.items())] == [
        (k, tuple(a.shape)) for c in caches for k, a in sorted(c.items())]
    assert not any(a.any() for a in tree.leaves(zeros))
    jtoken, token = jsteps.greedy_sample(jlogits), steps.greedy_sample(logits)
    decode = steps.make_serve_step(cfg)
    for i in range(gen):
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        assert token.dtype == torch.int32 and token.shape == (B, 1)
        jlogits, jcaches = jdecode(jparams, jcaches, jtoken, jnp.asarray(S + i, jnp.int32))
        logits, caches = decode(params, caches, token, S + i)
        _close(logits, jlogits, cfg)
        jtoken, token = jsteps.greedy_sample(jlogits), steps.greedy_sample(logits)
    for a, b in zip(tree.leaves(caches), jax.tree.leaves(jcaches)):
        _close(a, b, cfg)


def test_init_lm_leaves_match_jax_and_param_count(model):
    _, jcfg, cfg, jparams, _ = model
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = tree.leaves(fresh)
    assert [tuple(a.shape) for a in flat] == [b.shape for _, b in jflat]
    assert all(a.dtype == torch.float32 for a in flat)
    assert sum(a.numel() for a in flat) == counting.param_count(cfg) == jcounting.param_count(
        jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_jax(arch):
    """Total and active (MoE: the top-k experts) parameter counts and
    model_flops_per_token; arithmetic only: nothing of full size is
    allocated."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert counting.param_count(cfg) == jcounting.param_count(jcfg) == cfg.param_count()
    active = counting.param_count(cfg, active_only=True)
    assert active == jcounting.param_count(jcfg, active_only=True) == cfg.active_param_count()
    assert (active < cfg.param_count()) == cfg.moe
    assert counting.model_flops_per_token(cfg) == jcounting.model_flops_per_token(jcfg) \
        == 6 * active
    if arch == "mamba2-1.3b":
        assert cfg.param_count() == 1_343_740_928


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "starcoder2-3b", "mamba2-1.3b", "dbrx-132b",
                                  "jamba-v0.1-52b"])
def test_serve_lm_prompts_and_tokens_match_jax(arch, capsys):
    """Prompts bitwise the reference's randint draw; the served tokens equal
    the reference's prefill + greedy-decode loop on the same weights."""
    B, S, gen, seed = 3, 10, 6, 5
    jcfg = jconfigs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(seed), jcfg)
        jprompts = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), 1),
                                      (B, S), 0, jcfg.vocab)
    prompts = serve_cli.lm_prompts(seed, B, S, jcfg.vocab)
    assert prompts.dtype == torch.int32
    np.testing.assert_array_equal(prompts.numpy(), np.asarray(jprompts))

    logits, caches = jax.jit(jsteps.make_prefill_step(jcfg, max_len=S + gen))(
        jparams, {"tokens": jprompts})
    decode = jax.jit(jsteps.make_serve_step(jcfg))
    token = jsteps.greedy_sample(logits)
    want = [token]
    for i in range(gen - 1):
        logits, caches = decode(jparams, caches, token, jnp.asarray(S + i, jnp.int32))
        token = jsteps.greedy_sample(logits)
        want.append(token)
    got = serve_cli.serve_lm(arch, B, S, gen, seed=seed, device="cpu",
                             params=params_from_jax(jax.device_get(jparams)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.concatenate(want, axis=1)))
    assert f"[serve] {arch}: batch={B} prefill({S} tok)" in capsys.readouterr().out


def test_bf16_weights_cross_bitwise_and_serve():
    """bfloat16 leaves keep their 16-bit words through params_from_jax, and a
    bfloat16 smoke prefill runs from them."""
    x = jnp.asarray(np.random.default_rng(6).standard_normal(37, dtype=np.float32),
                    jnp.bfloat16)
    t = params_from_jax(jax.device_get(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))

    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen2.5-14b"), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.smoke_config("qwen2.5-14b"), dtype=torch.bfloat16)
    jparams = jax.device_get(JT.init_lm(jax.random.PRNGKey(1), jcfg))
    params = params_from_jax(jparams)
    for a, b in zip(tree.leaves(params), jax.tree.leaves(jparams)):
        assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
        np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
    tok = _tokens(cfg, 2, 8)
    logits, caches = steps.make_prefill_step(cfg, max_len=12)(
        params, {"tokens": torch.from_numpy(tok)})
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert caches[0]["k"].shape == (2, 2, 12, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("model", ["mamba2-1.3b"], indirect=True)
def test_mamba2_apply_and_decode_match_jax(model):
    """The mixer alone: the prefill's output, conv window and SSM state,
    then three recurrent steps against the prefill's cache (the port
    writes the cache in place and returns it)."""
    _, jcfg, cfg, jparams, params = model
    x = np.random.default_rng(8).standard_normal((2, 13, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["units"][0])["mixer"]
    p = T._layer(params["units"], 0)[0]["mixer"]
    jo, jcache = JL.mamba2_apply(jp, jcfg, jnp.asarray(x))
    o, cache = L.mamba2_apply(p, cfg, torch.from_numpy(x))
    _close(o, jo)
    assert cache["conv"].shape == (2, cfg.ssm_conv - 1, cfg.ssm_inner + 2 * cfg.ssm_state)
    assert cache["ssm"].shape == (2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)
    assert cache["ssm"].dtype == torch.float32
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])
    steps = np.random.default_rng(9).standard_normal((3, 2, 1, cfg.d_model), dtype=np.float32)
    for i, xt in enumerate(steps):
        jo, jcache = JL.mamba2_decode(jp, jcfg, jnp.asarray(xt), jcache, 13 + i)
        o, out_cache = L.mamba2_decode(p, cfg, torch.from_numpy(xt), cache, 13 + i)
        assert out_cache is cache and o.shape == (2, 1, cfg.d_model)
        _close(o, jo)
        _close(cache["conv"], jcache["conv"])
        _close(cache["ssm"], jcache["ssm"])


@pytest.mark.parametrize("model", ["mamba2-1.3b"], indirect=True)
def test_mamba2_fixed_leaves_equal_jax(model):
    """The leaves init does not draw (A_log, dt_bias, Dskip, conv_b, norm_g)
    equal the reference's, and stay float32 in a bfloat16 config."""
    _, jcfg, cfg, jparams, _ = model
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)["units"][0]["mixer"]
    jmix = jparams["units"][0]["mixer"]
    for name in ("A_log", "dt_bias", "Dskip", "conv_b", "norm_g"):
        _close(fresh[name], jmix[name])
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    mix = T.init_lm(torch.Generator().manual_seed(0), bf16)["units"][0]["mixer"]
    assert {k for k, v in mix.items() if v.dtype == torch.float32} == {"A_log", "dt_bias",
                                                                       "Dskip"}


def test_mamba2_prompt_shorter_than_the_conv_window_raises():
    """The reference's prefill leaves a short conv window for a prompt of
    fewer than ssm_conv − 1 tokens, and its decode then fails on the
    shapes; the port refuses such a prompt by name."""
    cfg = configs.smoke_config("mamba2-1.3b")
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    prefill = steps.make_prefill_step(cfg, max_len=8)
    for S in (1, 2):
        with pytest.raises(ValueError, match="ssm_conv - 1 = 3"):
            prefill(params, {"tokens": torch.zeros((2, S), dtype=torch.int32)})
    logits, caches = prefill(params, {"tokens": torch.zeros((2, 3), dtype=torch.int32)})
    assert caches[0]["conv"].shape[2] == 3
    with pytest.raises(ValueError, match="shorter than the conv window"):
        serve_cli.serve_lm("mamba2-1.3b", 2, 2, 4, device="cpu")


def test_bf16_mamba2_weights_cross_with_their_float32_leaves():
    """A bfloat16 mamba2 carries A_log, dt_bias and Dskip in float32
    (layers.py:487-489 of the reference); params_from_jax keeps every
    leaf's dtype and bits, and a bfloat16 smoke prefill and decode step run."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("mamba2-1.3b"), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.smoke_config("mamba2-1.3b"), dtype=torch.bfloat16)
    jparams = jax.device_get(JT.init_lm(jax.random.PRNGKey(2), jcfg))
    params = params_from_jax(jparams)
    for a, b in zip(tree.leaves(params), jax.tree.leaves(jparams)):
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert a.dtype == torch.float32 and b.dtype == np.float32
            np.testing.assert_array_equal(a.numpy(), b)
    mix = params["units"][0]["mixer"]
    assert [mix[k].dtype for k in ("A_log", "dt_bias", "Dskip", "in_proj")] == [
        torch.float32, torch.float32, torch.float32, torch.bfloat16]
    logits, caches = steps.make_prefill_step(cfg, max_len=12)(
        params, {"tokens": torch.from_numpy(_tokens(cfg, 2, 8))})
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    assert caches[0]["conv"].dtype == torch.bfloat16 and caches[0]["ssm"].dtype == torch.float32
    logits, _ = steps.make_serve_step(cfg)(params, caches, steps.greedy_sample(logits), 8)
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits.float()).all()


def _bf16_close(logits, jlogits, where):
    """Logits within BF16_LOGIT_RTOL of the largest |logit|; the port's
    greedy tokens equal the reference's wherever its top-two gap is at least
    that.  Returns the number of rows whose token was compared."""
    got = logits.float().numpy()[:, -1]
    want = np.asarray(jnp.asarray(jlogits, jnp.float32))[:, -1]
    tol = BF16_LOGIT_RTOL * np.abs(want).max()
    diff = np.abs(got - want).max()
    assert diff <= tol, f"{where}: logits differ by {diff} > {tol}"
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] >= tol
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided],
                                  err_msg=where)
    return int(decided.sum())


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-1.3b", "dbrx-132b"])
def test_bf16_prefill_and_decode_match_jax(arch):
    """bfloat16 smoke model, B 4, prompt 24, then 12 decode steps, each fed
    the reference's greedy token (so a near-tie does not fork the two
    runs): logits and decided tokens as _bf16_close states."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=torch.bfloat16)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.device_get(jparams))
    B, S, gen = 4, 24, 12
    tok = _tokens(cfg, B, S, seed=5)
    jlogits, jcaches = jax.jit(jsteps.make_prefill_step(jcfg, max_len=S + gen))(
        jparams, {"tokens": jnp.asarray(tok)})
    logits, caches = steps.make_prefill_step(cfg, max_len=S + gen)(
        params, {"tokens": torch.from_numpy(tok)})
    assert logits.dtype == torch.bfloat16
    compared = _bf16_close(logits, jlogits, f"{arch} prefill")
    jdecode, decode = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg)
    for i in range(gen):
        jtoken = jsteps.greedy_sample(jlogits)
        jlogits, jcaches = jdecode(jparams, jcaches, jtoken, jnp.asarray(S + i, jnp.int32))
        logits, caches = decode(params, caches, torch.from_numpy(np.array(jtoken)), S + i)
        compared += _bf16_close(logits, jlogits, f"{arch} decode step {i}")
    assert compared >= 0.75 * B * (gen + 1)
