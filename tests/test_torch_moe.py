"""The port's MoE layer (``moe_init``, ``moe_topk``, ``moe_slots``,
``moe_apply``, ``moe_combine``, ``moe_aux_loss``), jamba's unit and the
MoE and hybrid families' counts on the CPU against the JAX package, at
the smoke configs of dbrx-132b, grok-1-314b and jamba-v0.1-52b (float32,
weights from the reference's ``init_lm(PRNGKey(0))`` carried across with
``params_from_jax``).

Tolerances.  Integers exactly: the experts each token picks (``top_k``,
ties to the lower expert), the positions within an expert, the kept mask
and the slot buffer, at capacity factor 1.25 and 0.25 (drops), and in
decode (S = 1).  The reference's slot buffer is read from the rows its
dispatch gathers (recorded through its sharding ``hint``).  Floats in
float32: rtol = atol = 1e-5, as tests/test_torch_lm.py (the same ops, sums
in other orders: XLA's CPU dots against torch's BLAS).  The combine's
order is held bitwise in bfloat16 against a sequential scatter-add over
the slots (the reference's ``.at[buf].add``).  The smoke models' active
parameter count is their leaves' less the unrouted experts' (the full
configs' counts: tests/test_torch_lm.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.launch import steps
from repro_torch.models import counting
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MOE_ARCHS = ["dbrx-132b", "grok-1-314b", "jamba-v0.1-52b"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_block(request):
    """(arch, JAX cfg, port cfg, JAX MoE params, port MoE params): the first
    MoE block of the smoke model's first unit, layer 0."""
    arch = request.param
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    with jax_config():
        jparams = jax.device_get(JT.init_lm(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(jparams)
    j = [f for _, f in T.unit_pattern(cfg)].index("moe")
    jp = jax.tree.map(lambda a: a[0], jparams["units"][j])["ffn"]
    return arch, jcfg, cfg, jp, T._layer(params["units"], 0)[j]["ffn"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model), dtype=np.float32)


def _reference_moe(monkeypatch, jp, jcfg, x):
    """The reference's moe_apply -> (y, logits, buf): buf (B, E·C) read
    back from the dispatched rows xe its first sharding hint receives
    (each a row of x or the zero pad row; x's rows are distinct)."""
    seen = []
    monkeypatch.setattr(JL, "hint", lambda a, *dims: (seen.append(np.asarray(a)), a)[1])
    y, logits = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    xe = seen[0]                                                  # (B, E, C, D)
    B, S, D = x.shape
    x_pad = np.concatenate([x, np.zeros((B, 1, D), x.dtype)], 1)
    eq = (xe.reshape(B, -1, 1, D) == x_pad[:, None]).all(-1)     # (B, E·C, S + 1)
    assert (eq.sum(-1) == 1).all()
    return np.asarray(y), np.asarray(logits), eq.argmax(-1)


def _positions(flat_e):
    """Position of each slot within its expert: the earlier slots of the row
    (token-major, k-minor) that chose the same expert."""
    return np.array([[int((row[:j] == e).sum()) for j, e in enumerate(row)] for row in flat_e])


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("S", [24, 1])
def test_moe_routes_and_output_match_jax(moe_block, monkeypatch, cf, S):
    """top_k, positions, the kept mask and the slot buffer bitwise the
    reference's; the output and router logits within the tolerance.  At cf
    0.25 slots are dropped; at S = 1 (decode) C is 1 and each expert
    computes one row per batch row."""
    arch, jcfg, cfg, jp, p = moe_block
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf) for c in (jcfg, cfg))
    x = _x(cfg, 3, S, seed=S + int(cf * 100))
    jy, jlogits, jbuf = _reference_moe(monkeypatch, jp, jcfg, x)
    y, logits = L.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    np.testing.assert_allclose(y.numpy(), jy, **TOL)

    E, K = cfg.num_experts, cfg.top_k
    C = L.moe_capacity(cfg, S)
    assert C == max(1, int(cf * S * K / E)) and jbuf.shape == (3, E * C)
    if S == 1:
        assert C == 1
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(jlogits), axis=-1), K)
    w, idx = L.moe_topk(logits, K)
    pos, keep, buf = L.moe_slots(idx, E, C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    flat_e = np.asarray(jidx).reshape(3, S * K)
    np.testing.assert_array_equal(pos.numpy(), _positions(flat_e))
    np.testing.assert_array_equal(keep.numpy(), _positions(flat_e) < C)
    tok = np.repeat(np.arange(S), K)
    for b in range(3):  # a kept slot holds its token; an empty slot the pad row
        kept = keep[b].numpy()
        np.testing.assert_array_equal(jbuf[b, flat_e[b, kept] * C + pos[b].numpy()[kept]],
                                      tok[kept])
        assert (np.delete(jbuf[b], flat_e[b, kept] * C + pos[b].numpy()[kept]) == S).all()
    if cf == 0.25 and S > 1:
        assert not keep.all(), "capacity factor 0.25 dropped nothing"
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert first, as jax.lax.top_k."""
    logits = np.zeros((2, 5, 8), np.float32)
    logits[0, :, [1, 3, 6]] = 2.0
    logits[1, 2, :] = np.float32(np.arange(8) % 3)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), 4)
    _, idx = L.moe_topk(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == [1, 3, 6, 0]


def test_moe_aux_loss_matches_jax(moe_block):
    _, jcfg, cfg, jp, p = moe_block
    x = _x(cfg, 2, 16, seed=11)
    _, jlogits = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    _, logits = L.moe_apply(p, cfg, torch.from_numpy(x))
    aux = L.moe_aux_loss(logits)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(JL.moe_aux_loss(jlogits)), **TOL)
    # argmax ties go to the first expert in both
    tied = np.zeros((1, 3, cfg.num_experts), np.float32)
    tied[0, 1, 2:] = 1.0
    assert float(L.moe_aux_loss(torch.from_numpy(tied))) == pytest.approx(
        float(JL.moe_aux_loss(jnp.asarray(tied))), rel=1e-6)


def _sequential_scatter(ye, w, idx, pos, keep, buf, C, S):
    """The reference's combine, slot by slot in ascending order: out[buf[s]]
    += ye[s]·wslot[s] in ye's dtype, into zero, the pad row dropped."""
    E, BC, D = ye.shape
    B, _, K = idx.shape
    out = torch.zeros(B, S + 1, D, dtype=ye.dtype)
    wslot = torch.zeros(B, E * C, dtype=ye.dtype)
    for b in range(B):
        for j in range(S * K):
            if keep[b, j]:
                wslot[b, idx[b].reshape(-1)[j] * C + pos[b, j]] = w[b].reshape(-1)[j]
        for s in range(E * C):
            e, p = divmod(s, C)
            out[b, buf[b, s]] = out[b, buf[b, s]] + ye[e, b * C + p] * wslot[b, s]
    return out[:, :S]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_combine_is_the_sequential_scatter_bitwise(dtype):
    """Four experts of eight a token (dbrx's top-4 at a small size), some
    dropped: moe_combine's fixed-order sum equals the slot-by-slot
    scatter-add bitwise."""
    g = torch.Generator().manual_seed(5)
    B, S, E, K, D = 2, 12, 8, 4, 16
    C = max(1, int(0.75 * S * K / E))
    logits = torch.randn(B, S, E, generator=g)
    w, idx = L.moe_topk(logits, K)
    pos, keep, buf = L.moe_slots(idx, E, C)
    assert not keep.all()
    ye = torch.randn(E, B * C, D, generator=g).to(dtype)
    got = L.moe_combine(ye, w.to(dtype), idx, pos, keep, C)
    want = _sequential_scatter(ye, w.to(dtype), idx, pos, keep, buf, C, S)
    assert got.dtype == dtype and torch.equal(got, want)


def test_moe_leaves_keep_a_float32_router():
    """init draws the router in float32 at a bfloat16 config, as the
    reference (layers.py:398); the experts in the config's dtype."""
    cfg = dataclasses.replace(configs.smoke_config("dbrx-132b"), dtype=torch.bfloat16)
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, lead=(2,))
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((2, d, E), torch.float32), "e_up": ((2, E, d, f), torch.bfloat16),
        "e_gate": ((2, E, d, f), torch.bfloat16), "e_down": ((2, E, f, d), torch.bfloat16)}
    grok = dataclasses.replace(configs.smoke_config("grok-1-314b"), dtype=torch.bfloat16)
    assert "e_gate" not in L.moe_init(torch.Generator().manual_seed(0), grok)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_bf16_moe_weights_cross_bitwise_with_a_float32_router(arch):
    """bfloat16 leaves keep their words and the router (and a Mamba2
    mixer's A_log, dt_bias, Dskip) stays float32 through params_from_jax,
    as in a fresh port init; a bfloat16 prefill and decode step run."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=torch.bfloat16)
    with jax_config():
        jparams = jax.device_get(JT.init_lm(jax.random.PRNGKey(2), jcfg))
    params = params_from_jax(jparams)
    f32 = set()
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            tree.leaves(params)):
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert a.dtype == torch.float32 and b.dtype == np.float32
            np.testing.assert_array_equal(a.numpy(), b)
            f32.add(path[-1].key)
    assert "router" in f32 and f32 <= {"router", "A_log", "dt_bias", "Dskip"}
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    assert [a.dtype for a in tree.leaves(fresh)] == [a.dtype for a in tree.leaves(params)]
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    logits, caches = steps.make_prefill_step(cfg, max_len=12)(
        params, {"tokens": torch.from_numpy(tok)})
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    assert {c[k].dtype for c in caches for k in c} <= {torch.bfloat16, torch.float32}
    logits, _ = steps.make_serve_step(cfg)(params, caches, steps.greedy_sample(logits), 8)
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits.float()).all()


def test_hybrid_unit_pattern_is_the_references():
    """jamba: an 8-layer unit, attention at l % 8 == 0, MoE at l % 2 == 1."""
    cfg, jcfg = configs.get_config("jamba-v0.1-52b"), jconfigs.get_config("jamba-v0.1-52b")
    pat = T.unit_pattern(cfg)
    assert pat == JT.unit_pattern(jcfg) and len(pat) == 8 and T.num_units(cfg) == 4
    assert [m for m, _ in pat] == ["attn"] + ["mamba"] * 7
    assert [f for _, f in pat] == ["dense", "moe"] * 4
    for arch in ("dbrx-132b", "grok-1-314b"):
        assert T.unit_pattern(configs.get_config(arch)) == [("attn", "moe")]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_leaf_sizes_equal_the_counts(arch):
    cfg = configs.smoke_config(arch)
    params = T.init_lm(torch.Generator().manual_seed(1), cfg)
    assert sum(a.numel() for a in tree.leaves(params)) == counting.param_count(cfg)
    experts = sum(v.numel() for u in params["units"] if "ffn" in u and "router" in u["ffn"]
                  for k, v in u["ffn"].items() if k != "router")
    assert counting.param_count(cfg) - counting.param_count(cfg, active_only=True) == \
        experts * (cfg.num_experts - cfg.top_k) // cfg.num_experts
