"""The rest of the LM zoo on the CPU against the JAX package: minicpm3-4b
(MLA), pixtral-12b (a VLM: a prefix of patch embeddings ahead of a GQA
decoder), seamless-m4t-medium (the encoder-decoder) and the reversible
residual stack, at the smoke sizes, float32, weights from the reference's
``init_lm`` carried across with ``params_from_jax``.

Layers: ``mla_attend`` against the reference's (its ``blockwise_attention``
path) and ``mla_decode``; cross ``gqa_attend`` and ``gqa_cross_decode``;
the plain attention with a key length of its own against
``blockwise_attention``; ``kernel_strides`` at D = 96 and Sk != S.
Models: each family's prefill and 8 greedy decode steps, ``serve_lm``,
two ``make_train_step`` steps against the jitted reference, the train
CLI, ``param_count`` at the full configs.  The sub-word ``random_bits``
(8 and 16 bits) bitwise, and the bfloat16 normals.  The reversible stack's
value and gradients against the reference's, and ``lm_loss`` under the
flag.

Tolerances, float32: logits within 1e-5 of the largest logit (the same
ops summed in other orders: XLA's dots against torch's BLAS, the
reference's blockwise online softmax against the plain softmax); tokens
exactly; training as tests/test_torch_lm_train.py (metrics rtol 1e-5,
parameters within 2·lr, moments rtol 1e-4); the reversible stack rtol
1e-5 on its value, its gradients within 1e-5 of each leaf's largest
(the exact adjoint against the reference's exact adjoint, one float32 op
order apart).  bfloat16 normals: within one bfloat16 ulp of
``jax.random.normal`` (they share the 8-bit words and the exact uniform;
the float32 ``erf_inv`` polynomials differ by float32 ulps, which a
rounding to bfloat16 can turn into one bfloat16 ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro import configs as jconfigs
from repro.data.synthetic import token_batches as jax_token_batches
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import counting as jcounting
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.reversible import reversible_stack as jreversible_stack
from repro_torch import configs, optim, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import prng, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import counting
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.reversible import reversible_stack

ARCHS = ["minicpm3-4b", "pixtral-12b", "seamless-m4t-medium"]
FULL_COUNTS = {"minicpm3-4b": 4_261_902_848, "pixtral-12b": 12_247_782_400,
               "seamless-m4t-medium": 877_158_400}
LOGIT_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **(tol or TOL))


def _close_to_largest(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX cfg, port cfg, JAX params, port params)."""
    arch = request.param
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, cfg, jparams, params_from_jax(jax.device_get(jparams))


def _batch(cfg, B, S, seed, src_len=10):
    """A prompt batch for the family: tokens, and a VLM's prefix or the
    encoder-decoder's source embeddings, as (JAX, port) dicts."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal((B, src_len, cfg.d_model), dtype=np.float32)
    elif cfg.frontend:
        b["embeds"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model), dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# -----------------------------------------------------------------------------
# configs and counts
# -----------------------------------------------------------------------------


def test_get_config_resolves_all_ten_archs():
    assert sorted(configs.ARCH_NAMES) == sorted(jconfigs.ARCH_NAMES) and len(
        configs.ARCH_NAMES) == 10
    for arch in configs.ARCH_NAMES:
        assert configs.get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_and_param_counts(arch):
    """Every field of the full and the smoke config; the full config's
    parameter count (arithmetic only) equal to the reference's."""
    for cfg, jcfg in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.smoke_config(arch), jconfigs.smoke_config(arch))):
        for f in dataclasses.fields(jcfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = configs.get_config(arch)
    assert cfg.dtype == torch.bfloat16
    assert counting.param_count(cfg) == jcounting.param_count(jconfigs.get_config(arch)) \
        == FULL_COUNTS[arch] == cfg.param_count()
    assert counting.model_flops_per_token(cfg) == 6 * FULL_COUNTS[arch]


def test_init_lm_leaves_match_jax_and_param_count(model):
    _, jcfg, cfg, jparams, _ = model
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = tree.leaves(fresh)
    assert [tuple(a.shape) for a in flat] == [b.shape for _, b in jflat]
    assert sum(a.numel() for a in flat) == counting.param_count(cfg) == jcounting.param_count(
        jcfg)


# -----------------------------------------------------------------------------
# layers
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["minicpm3-4b"], indirect=True)
@pytest.mark.parametrize("causal", [True, False])
def test_mla_attend_matches_blockwise_reference(model, causal):
    """The output and the latent cache (ckv, k_pe); the reference runs its
    blockwise attention with blocks of 4 to exercise the online softmax."""
    _, jcfg, cfg, jparams, params = model
    jcfg = dataclasses.replace(jcfg, attn_block_q=4, attn_block_k=4)
    x = np.random.default_rng(2).standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["units"][0])["mixer"]
    p = T._layer(params["units"], 0)[0]["mixer"]
    jo, (jckv, jkpe) = JL.mla_attend(jp, jcfg, jnp.asarray(x), causal=causal)
    o, (ckv, kpe) = L.mla_attend(p, cfg, torch.from_numpy(x), causal=causal)
    assert o.shape == (2, 12, cfg.d_model) and ckv.shape == (2, 12, cfg.kv_lora_rank)
    for a, b in ((o, jo), (ckv, jckv), (kpe, jkpe)):
        _close(a, b)


@pytest.mark.parametrize("model", ["minicpm3-4b"], indirect=True)
def test_mla_decode_matches_jax(model):
    """Three latent-cache steps after a prefill's cache, written in place."""
    _, jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["units"][0])["mixer"]
    p = T._layer(params["units"], 0)[0]["mixer"]
    _, (jckv, jkpe) = JL.mla_attend(jp, jcfg, jnp.asarray(x))
    jcache = {"ckv": jnp.pad(jckv, ((0, 0), (0, 4), (0, 0))),
              "kpe": jnp.pad(jkpe, ((0, 0), (0, 4), (0, 0)))}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for i, xt in enumerate(rng.standard_normal((3, 2, 1, cfg.d_model), dtype=np.float32)):
        jo, jcache = JL.mla_decode(jp, jcfg, jnp.asarray(xt), jcache, jnp.int32(9 + i))
        o, out = L.mla_decode(p, cfg, torch.from_numpy(xt), cache, 9 + i)
        assert out is cache and o.shape == (2, 1, cfg.d_model)
        _close(o, jo)
        _close(cache["ckv"], jcache["ckv"])
        _close(cache["kpe"], jcache["kpe"])


@pytest.mark.parametrize("model", ["seamless-m4t-medium"], indirect=True)
def test_cross_attention_and_cross_decode_match_jax(model):
    """Cross gqa_attend (k and v from the encoder's 10 rows, no RoPE, full)
    and the decode against that fixed cross cache."""
    _, jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["cross"])["attn"]
    p = T._layer(params["cross"], 0)["attn"]
    jo, (jk, jv) = JL.gqa_attend(jp, jcfg, jnp.asarray(x), causal=False,
                                 kv_source=jnp.asarray(enc))
    o, (k, v) = L.gqa_attend(p, cfg, torch.from_numpy(x), causal=False,
                             kv_source=torch.from_numpy(enc))
    assert k.shape == (2, 10, cfg.num_kv_heads, cfg.head_dim)
    for a, b in ((o, jo), (k, jk), (v, jv)):
        _close(a, b)
    xt = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    _close(L.gqa_cross_decode(p, cfg, torch.from_numpy(xt), k, v),
           JL.gqa_cross_decode(jp, jcfg, jnp.asarray(xt), jk, jv))


@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D", [(2, 4, 4, 12, 10, 16), (1, 8, 2, 7, 33, 16),
                                             (2, 4, 2, 16, 8, 96), (1, 2, 1, 5, 64, 64)])
def test_plain_attention_with_its_own_key_length_matches_blockwise(B, Hq, Hkv, S, Sk, D):
    """The plain version at Sk != S (full) against the reference's
    blockwise_attention (blocks of 4) and its ref.py; causal with Sk != S
    is refused by name in the plain version and the reference has no such
    case either."""
    rng = np.random.default_rng(S * Sk)
    q = rng.standard_normal((B, Hq, S, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32) for _ in range(2))
    want = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=False, bq=4, bk=4,
                                  impl="unrolled")
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                              scale=1 / np.sqrt(D))
    _close(got, want)
    _close(got, jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False))
    with pytest.raises(ValueError, match="key length"):
        ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


def _meta(shapes, dtype=torch.bfloat16):
    ts = [torch.empty(s, dtype=dtype) for s in shapes]
    return ([t.shape for t in ts], [t.stride() for t in ts], [t.dtype for t in ts],
            [t.data_ptr() for t in ts])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,causal", [
    (((2, 40, 512, 96), (2, 40, 512, 96), (2, 40, 512, 96)), True),     # MLA, D 96
    (((4, 16, 2048, 64), (4, 16, 1024, 64), (4, 16, 1024, 64)), False),  # seamless cross
    (((2, 16, 300, 96), (2, 8, 1000, 96), (2, 8, 1000, 96)), False)])
def test_kernel_strides_take_head_dim_96_and_a_key_length(shapes, causal, dtype):
    got = fa_kernel.kernel_strides(*_meta(shapes, dtype), causal=causal)
    for st, (B, H, S, D) in zip(got, shapes):
        assert st == (H * S * D, S * D, D)


def test_kernel_strides_refuse_causal_with_a_key_length_of_its_own():
    shapes = ((2, 16, 300, 64), (2, 16, 1000, 64), (2, 16, 1000, 64))
    with pytest.raises(ValueError, match="key length equal to the query length"):
        fa_kernel.kernel_strides(*_meta(shapes), causal=True)
    with pytest.raises(ValueError, match="key length equal to the query length"):
        fa_kernel.kernel_strides(*_meta(shapes))  # causal by default
    with pytest.raises(ValueError, match="no keys"):
        fa_kernel.kernel_strides(*_meta(((1, 2, 3, 64), (1, 2, 0, 64), (1, 2, 0, 64))),
                                 causal=False)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.kernel_strides(*_meta(((1, 2, 3, 80),) * 3))
    with pytest.raises(ValueError, match="k, v"):  # k and v must agree on Sk
        fa_kernel.kernel_strides(*_meta(((1, 2, 3, 64), (1, 2, 5, 64), (1, 2, 6, 64))),
                                 causal=False)


# -----------------------------------------------------------------------------
# the models: prefill, decode, serve
# -----------------------------------------------------------------------------


def test_lm_forward_logits_match_jax(model):
    _, jcfg, cfg, jparams, params = model
    jb, b = _batch(cfg, 2, 16, seed=5)
    if cfg.family == "encdec":
        jlogits, _ = JT.encdec_forward(jparams, jcfg, jb["tokens"], jb["src_embeds"])
        logits, aux = T.encdec_forward(params, cfg, b["tokens"], b["src_embeds"])
    else:
        jlogits, _ = JT.lm_forward(jparams, jcfg, jb["tokens"], embeds=jb.get("embeds"))
        logits, aux = T.lm_forward(params, cfg, b["tokens"], embeds=b.get("embeds"))
    assert logits.shape == tuple(jlogits.shape) and float(aux) == 0.0
    _close_to_largest(logits, jlogits)


def test_prefill_and_eight_decode_steps_match_jax(model):
    """The prefill's logits and caches (padded where the reference pads:
    not the cross cache), then 8 greedy decode steps: tokens equal, logits
    within 1e-5 of the largest."""
    _, jcfg, cfg, jparams, params = model
    B, S, gen = 2, 12, 8
    jb, b = _batch(cfg, B, S, seed=6)
    P = cfg.frontend_len if "embeds" in b else 0
    max_len = S + gen + P
    jlogits, jcaches = jax.jit(jsteps.make_prefill_step(jcfg, max_len=max_len))(jparams, jb)
    logits, caches = steps.make_prefill_step(cfg, max_len=max_len)(params, b)
    _close_to_largest(logits, jlogits)
    jleaves, leaves = jax.tree.leaves(jcaches), tree.leaves(caches)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jleaves]
    for a, c in zip(leaves, jleaves):
        _close(a, c)
    if cfg.family == "encdec":
        assert caches[0]["cross"]["k"].shape[2] == 10  # the source's length
        zeros = T.encdec_cache_zeros(cfg, B, max_len, 10)
    else:
        zeros = T.init_cache_zeros(cfg, B, max_len)
    assert [tuple(a.shape) for a in tree.leaves(zeros)] == [tuple(a.shape) for a in leaves]
    assert not any(a.any() for a in tree.leaves(zeros))
    jdecode, decode = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg)
    jtoken, token = jsteps.greedy_sample(jlogits), steps.greedy_sample(logits)
    for i in range(gen):
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))
        jlogits, jcaches = jdecode(jparams, jcaches, jtoken, jnp.int32(S + P + i))
        logits, out = decode(params, caches, token, S + P + i)
        assert out is caches
        _close_to_largest(logits, jlogits)
        jtoken, token = jsteps.greedy_sample(jlogits), steps.greedy_sample(logits)
    np.testing.assert_array_equal(token.numpy(), np.asarray(jtoken))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "pixtral-12b"])
def test_serve_lm_matches_jax(arch, capsys):
    """The served tokens equal the reference's ``serve_lm`` on the same
    weights: its prompts, and for pixtral its prefix (the port's within a
    few float32 ulp of ``jax.random.normal``) and first decode position."""
    B, S, gen, seed = 2, 10, 6, 5
    jcfg = jconfigs.smoke_config(arch)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(seed), jcfg)
        want = jserve.serve_lm(arch, B, S, gen, seed=seed)
        if jcfg.frontend:
            jprefix = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), 2),
                                        (B, jcfg.frontend_len, jcfg.d_model), jcfg.dtype)
    if jcfg.frontend:
        prefix = serve_cli.lm_prefix(seed, B, configs.smoke_config(arch))
        np.testing.assert_allclose(prefix.numpy(), np.asarray(jprefix), rtol=1e-6, atol=1e-6)
    got = serve_cli.serve_lm(arch, B, S, gen, seed=seed, device="cpu",
                             params=params_from_jax(jax.device_get(jparams)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert f"[serve] {arch}: batch={B} prefill({S} tok)" in capsys.readouterr().out


def test_serve_cli_refuses_the_encoder_decoder_with_the_reference_message():
    with pytest.raises(SystemExit, match="decoder-only config"):
        jserve.serve_lm("seamless-m4t-medium", 1, 4, 2)
    with pytest.raises(SystemExit, match="use --arch with a decoder-only config for serve.py"):
        serve_cli.main(["--workload", "lm", "--arch", "seamless-m4t-medium", "--device", "cpu"])


# -----------------------------------------------------------------------------
# training
# -----------------------------------------------------------------------------


def _jax_batch(jcfg, B, S, step, seed=0):
    """The reference train CLI's batch of ``step`` (launch/train.py:107-123)."""
    with jax_config():
        data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        d = jax_token_batches(data_key, jnp.int32(step), B, S, jcfg.vocab)
        if jcfg.family == "encdec":
            d = {"src_embeds": jax.random.normal(jax.random.fold_in(data_key, step + 10_000),
                                                 (B, S, jcfg.d_model), jcfg.dtype), **d}
        elif jcfg.frontend:
            f = jcfg.frontend_len
            d = {"embeds": jax.random.normal(jax.random.fold_in(data_key, step + 10_000),
                                             (B, f, jcfg.d_model), jcfg.dtype),
                 "tokens": d["tokens"][:, f:], "labels": d["labels"][:, f:]}
        return {k: np.array(v) for k, v in d.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_matches_reference(arch):
    """Tokens and labels bitwise, the float32 prefix / source normals within
    a few ulp (the port's erf_inv against XLA's)."""
    cfg = configs.smoke_config(arch)
    want = _jax_batch(jconfigs.smoke_config(arch), 2, 24, step=3)
    got = train_cli.lm_batch(cfg, prng.fold_in_key(prng.PRNGKey(0), 1), 3, 2, 24)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(v.numpy(), want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """Two make_train_step steps against the jitted reference (the
    reference's batch carried across), metrics, parameters and moments."""
    B, S = 2, 24
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    batch = _jax_batch(jcfg, B, S, step=0)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        jinit, jupd = jsteps.make_optimizer(jcfg)
        jstep = jax.jit(jsteps.make_train_step(jcfg, jupd))
        state, outs = (jparams, jinit(jparams)), []
        for _ in range(2):
            p, o, m = jstep(*state, {k: jnp.asarray(v) for k, v in batch.items()})
            state = (p, o)
            outs.append(jax.device_get((p, o, m)))
    params = params_from_jax(jax.device_get(jparams))
    init, update = steps.make_optimizer(cfg)
    step_fn = steps.make_train_step(cfg, update)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p, o = params, init(params)
    lr = optim.cosine_schedule(3e-4, 100, 10_000)
    for i, (jp, jo, jm) in enumerate(outs):
        p, o, m = step_fn(p, o, tb)
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2 * sum(lr(j + 1) for j in range(i + 1)))
        for mine, theirs in ((o.m, jo.m), (o.v, jo.v)):
            for a, b in zip(tree.leaves(mine), jax.tree.leaves(theirs)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_new_archs(arch, capsys):
    losses = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: first loss" in capsys.readouterr().out


def test_remat_of_the_encoder_decoder_gives_the_same_gradients_bitwise():
    cfg = configs.smoke_config("seamless-m4t-medium")
    params = T.init_lm(torch.Generator().manual_seed(3), cfg)
    batch = train_cli.lm_batch(cfg, prng.fold_in_key(prng.PRNGKey(0), 1), 0, 2, 12)

    def grads(c):
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, _ = T.lm_loss(tree.unflatten(spec, leaves), c, batch)
        return loss, torch.autograd.grad(loss, leaves)

    loss0, g0 = grads(dataclasses.replace(cfg, remat=False))
    loss1, g1 = grads(dataclasses.replace(cfg, remat=True))
    assert torch.equal(loss0, loss1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


# -----------------------------------------------------------------------------
# random bits of 8 and 16 bits, bfloat16 normals
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("bit_width,dtype", [(8, jnp.uint8), (16, jnp.uint16)])
def test_sub_word_random_bits_bitwise(bit_width, dtype):
    for seed in (0, 7, 123_456_789):
        with jax_config():
            key = jax.random.PRNGKey(seed)
            for size in (1, 2, 3, 5, 64, 1001):
                want = np.asarray(jax.random.bits(key, (size,), dtype)).astype(np.int64)
                got = prng.random_bits(*prng.PRNGKey(seed), bit_width, size)
                np.testing.assert_array_equal(got.numpy(), want)


def test_bfloat16_normals_within_one_ulp():
    """bf16 normals (the full VLM prefix and encoder-decoder source draws)
    against ``jax.random.normal``: within one bfloat16 ulp; the count off
    by one is printed (0 in 3 × 20001 draws here)."""
    off = 0
    for seed in (0, 3, 11):
        with jax_config():
            want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (20001,),
                                                jnp.bfloat16)).astype(np.float32)
        got = prng.normal(*prng.PRNGKey(seed), 20001, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16  # bf16 keeps 8 bits
        assert (np.abs(got - want) <= ulp).all()
        off += int((got != want).sum())
    print(f"bf16 normals one ulp off: {off} of {3 * 20001}")


# -----------------------------------------------------------------------------
# the reversible residual stack
# -----------------------------------------------------------------------------


def _rev_setup(dtype=jnp.float32):
    jcfg = dataclasses.replace(jconfigs.smoke_config("tinyllama-1.1b"), num_layers=4,
                               reversible_residual=True, dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"), num_layers=4,
                              reversible_residual=True)
    with jax_config():
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    x0 = np.random.default_rng(5).standard_normal((2, 8, cfg.d_model), dtype=np.float32)
    return jcfg, cfg, jparams, params_from_jax(jax.device_get(jparams)), x0


def test_reversible_stack_value_and_gradients_match_jax():
    jcfg, cfg, jparams, params, x0 = _rev_setup()
    f_j = lambda units, x: jnp.sum(jreversible_stack(jcfg, units, x, JT._unit_residual) ** 2)
    jval, (jg_units, jg_x) = jax.value_and_grad(f_j, argnums=(0, 1))(jparams["units"],
                                                                     jnp.asarray(x0))
    leaves, spec = tree.flatten(params["units"])
    leaves = [a.requires_grad_() for a in leaves]
    x = torch.from_numpy(x0).requires_grad_()
    val = torch.sum(reversible_stack(cfg, tree.unflatten(spec, leaves), x,
                                     T._unit_residual) ** 2)
    grads = torch.autograd.grad(val, [*leaves, x])
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    for a, b in zip(grads, [*jax.tree.leaves(jg_units), jg_x]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_reversible_stack_is_the_two_track_recursion():
    """The stack against the plain two-track recursion of the reference's
    test (tests/test_models.py): unit 0 for the initial drift, unit
    min(n + 1, units − 1) at step n; value and input gradient."""
    _, cfg, _, params, x0 = _rev_setup()
    units, n = params["units"], T.num_units(cfg)

    def two_track(x):
        z = zh = x
        mu = T._unit_residual(T._layer(units, 0), cfg, zh)
        for i in range(n):
            zh1 = 2 * z - zh + mu
            mu1 = T._unit_residual(T._layer(units, min(i + 1, n - 1)), cfg, zh1)
            z, zh, mu = z + 0.5 * (mu + mu1), zh1, mu1
        return z

    x = torch.from_numpy(x0).requires_grad_()
    got = reversible_stack(cfg, units, x, T._unit_residual)
    want = two_track(x)
    _close(got, want.detach(), rtol=1e-6, atol=1e-6)
    g_got, = torch.autograd.grad(got.square().sum(), x)
    g_want, = torch.autograd.grad(want.square().sum(), x)
    _close(g_got, g_want.numpy(), rtol=1e-5, atol=1e-5)


def test_reversible_flag_runs_the_reversible_stack_in_lm_loss():
    """The flag is never ignored: lm_forward and lm_loss run the reversible
    stack (the reference's loss, rtol 1e-5), and differ from the vanilla
    stack's; the prefill keeps the vanilla stack, as the reference's does;
    a bfloat16 stack runs."""
    jcfg, cfg, jparams, params, _ = _rev_setup()
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    jloss, _ = JT.lm_loss(jparams, jcfg, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)})
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    loss, parts = T.lm_loss(params, cfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    vanilla, _ = T.lm_loss(params, dataclasses.replace(cfg, reversible_residual=False), tb)
    assert abs(float(vanilla) - float(loss)) > 1e-4
    _close(steps.make_prefill_step(cfg)(params, tb)[0],
           steps.make_prefill_step(dataclasses.replace(cfg, reversible_residual=False))(
               params, tb)[0], rtol=0, atol=0)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p16 = tree.map(lambda a: a.to(torch.bfloat16), params)
    leaves, spec = tree.flatten(p16)
    leaves = [a.requires_grad_() for a in leaves]
    loss16, _ = T.lm_loss(tree.unflatten(spec, leaves), bf16, tb)
    grads = torch.autograd.grad(loss16, leaves)
    assert np.isfinite(float(loss16)) and abs(float(loss16) - float(loss)) < 0.05 * float(loss)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)
