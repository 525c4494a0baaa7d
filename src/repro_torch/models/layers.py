"""Sequence-mixing and FFN layers of the transformer zoo (port of
:mod:`repro.models.layers`), every family's: RoPE, GQA attention (self-
and cross-attention over the full sequence, single-token decode against a
cache and against the encoder's fixed cross cache), MLA (multi-head latent
attention: the full-sequence form through the attention kernel at the
concatenated head dim, the absorbed latent-cache decode), the dense FFN,
the top-k token-choice MoE with its load-balancing loss, and the Mamba2
mixer (the chunked SSD prefill and the recurrent single-token decode).

Parameters are dicts of tensors in the reference's layout (``x @ w``).
``*_init`` draw fresh weights from an explicit ``torch.Generator`` at the
reference's scales; ``lead`` prepends a leading shape to every leaf, which
is how :func:`repro_torch.models.transformer.init_lm` stacks the layers.

Not ported: ``distributed.sharding.hint``, ``checkpoint_name`` and the
``attn_mha_tp`` K/V repeat are layout hints for XLA's partitioner with no
counterpart on one card (they return with the LM's sharded execution,
ROADMAP.md Queue 1, 'Sharded LM execution'); ``blockwise_attention`` is the XLA
path of the reference — on the card the attention runs in the CUDA kernel, on the CPU
in its plain version; likewise ``ssd_chunked_dense`` is the reference's
XLA form of the SSD scan, and the port's mixer calls the SSD kernel (its
plain version on the CPU).  The MoE layer reaches no kernel of the
reference: its routing, dispatch, expert products and combine are plain
PyTorch on both devices, the combine a fixed-order sum (no atomics).  The
reference's MLA calls ``blockwise_attention`` directly, on every backend;
the port's goes through the attention kernel (D = 96 at minicpm3-4b) with
the same float scale.  The decodes (GQA, cross, MLA) are float32 einsums
on both devices.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import nn
from ..configs.base import ArchConfig
from ..kernels import ops


def _normal(generator: torch.Generator, shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Standard normal draws in ``dtype`` on the generator's device, moved to
    ``device`` (the reference draws ``jax.random.normal`` in ``cfg.dtype``)."""
    w = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)
    return w.to(device)


# =============================================================================
# RoPE
# =============================================================================


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor, dtype=torch.float32):
    """Angles in float32, cos and sin cast to ``dtype``: ``(..., S, hd/2)``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: ``(..., S, H, hd)``; cos/sin: ``(S, hd/2)`` or broadcastable.
    Rotates the two halves (not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# =============================================================================
# GQA attention
# =============================================================================


def _attend_dispatch(cfg: ArchConfig, q, k, v, causal: bool, scale=None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors
    (:func:`repro_torch.kernels.ops.flash_attention`).  q, k, v are the
    ``(B, H, S, D)`` transposed views of the ``(B, S, H, D)`` projections;
    both read them in place, where the reference's ``swapaxes`` leave the
    copies to XLA.  k and v have the encoder's length in cross-attention
    (not causal); ``scale`` is MLA's explicit float ``1/sqrt(dn + dr)``."""
    return ops.flash_attention(q, k, v, causal=causal, scale=scale)


def gqa_init(generator: torch.Generator, cfg: ArchConfig, lead: Sequence[int] = (),
             device=None):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def w(shape):
        return _normal(generator, lead + shape, cfg.dtype, device)

    p = {
        "wq": w((d, hq * hd)).mul_(s),
        "wk": w((d, hkv * hd)).mul_(s),
        "wv": w((d, hkv * hd)).mul_(s),
        "wo": w((hq * hd, d)).mul_(s).div_(math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=cfg.dtype, device=device)
    return p


def _project_q(p, cfg: ArchConfig, x):
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(B, S, cfg.num_heads, cfg.head_dim)


def _project_qkv(p, cfg: ArchConfig, x, positions, kv_source=None):
    """q from x, k and v from ``kv_source`` ``(B, Sk, D)`` (cross-attention:
    no RoPE, as the reference's ``use_rope=False``) or from x
    (self-attention: q and k rotated at ``positions``)."""
    src = x if kv_source is None else kv_source
    B, Sk, _ = src.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    q = _project_q(p, cfg, x)
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, Sk, hkv, hd)
    v = v.reshape(B, Sk, hkv, hd)
    if kv_source is not None:
        return q, k, v
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions, x.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attend(p, cfg: ArchConfig, x, causal: bool = True, kv_source=None):
    """Full-sequence attention (train/prefill).  x: ``(B, S, D)``.
    ``kv_source`` ``(B, Sk, D)`` switches to cross-attention (the
    encoder-decoder's decoder): k and v from it, no RoPE, pass
    ``causal=False``.  Returns ``(out, (k, v))``, k and v ``(B, S|Sk, Hkv,
    hd)`` for the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, torch.arange(S, device=x.device), kv_source=kv_source)
    o = _attend_dispatch(cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return o @ p["wo"], (k, v)


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   lead: Sequence[int] = (), device=None):
    shape = tuple(lead) + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, cfg: ArchConfig, x, cache, pos):
    """Single-token decode.  x: ``(B, 1, D)``; cache k/v: ``(B, Smax, Hkv,
    hd)``; ``pos``: the current position (an int or a 0-d tensor, one for
    the whole batch).

    The new K/V row is written into ``cache`` in place at ``pos`` — where
    the reference updates a donated buffer — and ``cache`` is returned."""
    B = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = int(pos)
    positions = torch.full((1,), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    k[:, pos:pos + 1] = k_new.to(k.dtype)
    v[:, pos:pos + 1] = v_new.to(v.dtype)
    S = k.shape[1]
    qg = q.reshape(B, hkv, hq // hkv, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) / math.sqrt(hd)
    mask = (torch.arange(S, device=x.device) <= pos)[None, None, None, :]
    scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    o = o.reshape(B, 1, hq * hd).to(x.dtype)
    return o @ p["wo"], cache


def gqa_cross_decode(p, cfg: ArchConfig, x, k, v):
    """Cross-attention decode: q from one new token against ``(k, v)``
    ``(B, Sk, Hkv, hd)``, the encoder's fixed cross cache (no RoPE, no
    mask).  x: ``(B, 1, D)``.  The reference projects k and v from x too and
    drops them; the port projects q alone (the same q)."""
    B = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = _project_q(p, cfg, x).reshape(B, hkv, hq // hkv, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return o.reshape(B, 1, hq * hd).to(x.dtype) @ p["wo"]


# =============================================================================
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek style)
# =============================================================================


def mla_init(generator: torch.Generator, cfg: ArchConfig, lead: Sequence[int] = (),
             device=None):
    """The reference's ``mla_init`` scales: the query's low-rank pair
    ``wq_a`` / ``wq_b`` with the RMSNorm ``q_ln`` between, the shared
    latent projection ``wkv_a`` (``kv_lora_rank`` latent + ``qk_rope_head_dim``
    rope key), its norm ``kv_ln``, the per-head up-projection ``wkv_b`` and
    ``wo``."""
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def w(shape):
        return _normal(generator, lead + shape, cfg.dtype, device)

    def norm(width):
        return {k: v.expand(lead + v.shape).clone()
                for k, v in nn.rmsnorm_init(width, cfg.dtype, device).items()}

    return {
        "wq_a": w((d, rq)).mul_(s),
        "q_ln": norm(rq),
        "wq_b": w((rq, h * (dn + dr))).div_(math.sqrt(rq)),
        "wkv_a": w((d, rkv + dr)).mul_(s),
        "kv_ln": norm(rkv),
        "wkv_b": w((rkv, h * (dn + dv))).div_(math.sqrt(rkv)),
        "wo": w((h * dv, d)).mul_(s).div_(math.sqrt(2 * cfg.num_layers)),
    }


def _mla_qkv(p, cfg: ArchConfig, x, positions):
    """-> ``(q_nope (B, S, h, dn), q_pe (B, S, h, dr), ckv (B, S, r), k_pe
    (B, S, dr))``: the rope halves rotated at ``positions``, ``k_pe``
    shared across the heads."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = nn.rmsnorm(p["q_ln"], x @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(B, S, cfg.num_heads, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv = x @ p["wkv_a"]
    ckv = nn.rmsnorm(p["kv_ln"], kv[..., :cfg.kv_lora_rank])
    k_pe = kv[..., cfg.kv_lora_rank:]
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions, x.dtype)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[..., None, :], cos, sin)[..., 0, :]
    return q_nope, q_pe, ckv, k_pe


def mla_attend(p, cfg: ArchConfig, x, causal: bool = True):
    """MLA train/prefill.  x: ``(B, S, D)`` -> ``(out, (ckv, k_pe))``, the
    latent cache.  As the reference: the (nope ‖ rope) score split folded
    into one ``dn + dr`` head (``k_pe`` broadcast over the heads), v
    zero-padded from ``dv`` to that width and the output sliced back, so
    the attention kernel runs unchanged (D = 96 at minicpm3-4b), with the
    explicit float scale ``1/sqrt(dn + dr)``."""
    B, S, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe, ckv, k_pe = _mla_qkv(p, cfg, x, torch.arange(S, device=x.device))
    kv = (ckv @ p["wkv_b"]).reshape(B, S, h, dn + dv)
    q_cat = torch.cat([q_nope, q_pe], -1)                             # (B, S, h, dn + dr)
    k_cat = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(B, S, h, dr)], -1)
    v_pad = torch.nn.functional.pad(kv[..., dn:], (0, dn + dr - dv))
    o = _attend_dispatch(cfg, q_cat.transpose(1, 2), k_cat.transpose(1, 2),
                         v_pad.transpose(1, 2), causal, scale=1.0 / math.sqrt(dn + dr))
    o = o.transpose(1, 2)[..., :dv]                                   # (B, S, h, dv)
    return o.reshape(B, S, h * dv) @ p["wo"], (ckv, k_pe)


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   lead: Sequence[int] = (), device=None):
    lead = tuple(lead) + (batch, max_len)
    return {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype, device=device),
            "kpe": torch.zeros(lead + (cfg.qk_rope_head_dim,), dtype=dtype, device=device)}


def mla_decode(p, cfg: ArchConfig, x, cache, pos):
    """Latent-cache decode (the MLA memory win), float32 einsums: the scores
    through the absorbed ``q_nope · W_ukᵀ`` against the cached latent
    ``ckv`` plus the rope part against ``kpe``, the output through
    ``W_uv``.  The new latent row is written into ``cache`` in place at
    ``pos`` and ``cache`` is returned."""
    B = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pos = int(pos)
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv(p, cfg, x, torch.full((1,), pos, device=x.device))
    ckv, kpe = cache["ckv"], cache["kpe"]
    ckv[:, pos:pos + 1] = ckv_new.to(ckv.dtype)
    kpe[:, pos:pos + 1] = kpe_new.to(kpe.dtype)
    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, h, dn + dv).float()
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]                     # (r, h, dn), (r, h, dv)
    ckv_f = ckv.float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)      # (B, 1, h, r)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv_f)
              + torch.einsum("bqhd,bsd->bhqs", q_pe.float(), kpe.float())) / math.sqrt(dn + dr)
    mask = (torch.arange(ckv.shape[1], device=x.device) <= pos)[None, None, None, :]
    w = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv_f)                  # (B, 1, h, r)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv).to(x.dtype)
    return o.reshape(B, 1, h * dv) @ p["wo"], cache


# =============================================================================
# dense FFN
# =============================================================================


def ffn_init(generator: torch.Generator, cfg: ArchConfig, lead: Sequence[int] = (),
             device=None):
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def w(shape):
        return _normal(generator, lead + shape, cfg.dtype, device)

    p = {"up": w((d, f)).mul_(s),
         "down": w((f, d)).div_(math.sqrt(f)).div_(math.sqrt(2 * cfg.num_layers))}
    if cfg.ffn == "swiglu":
        p["gate"] = w((d, f)).mul_(s)
    return p


def ffn_apply(p, cfg: ArchConfig, x):
    if cfg.ffn == "swiglu":
        h = nn.silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = nn.gelu(x @ p["up"])
    return h @ p["down"]


# =============================================================================
# MoE FFN
# =============================================================================


def moe_init(generator: torch.Generator, cfg: ArchConfig, lead: Sequence[int] = (),
             device=None):
    """The reference's ``moe_init`` scales and dtypes: ``router`` is float32
    in a model of any dtype, the experts ``(E, d, f)`` / ``(E, f, d)`` in
    ``cfg.dtype``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def w(shape, dtype=cfg.dtype):
        return _normal(generator, lead + shape, dtype, device)

    p = {"router": w((d, E), torch.float32).mul_(s),
         "e_up": w((E, d, f)).mul_(s),
         "e_down": w((E, f, d)).div_(math.sqrt(f)).div_(math.sqrt(2 * cfg.num_layers))}
    if cfg.ffn == "swiglu":
        p["e_gate"] = w((E, d, f)).mul_(s)
    return p


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Slots per expert and batch row: ``C = max(1, int(cf·S·k/E))``."""
    return max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.num_experts))


def moe_topk(logits: torch.Tensor, k: int):
    """The reference's router choice: the top ``k`` softmax probabilities
    of logits ``(B, S, E)`` and their experts, ties to the lower expert (as
    ``jax.lax.top_k``), the weights normalised by their sum clipped at
    1e-9 -> ``(w (B, S, k) float32, idx (B, S, k))``."""
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def moe_slots(idx: torch.Tensor, E: int, C: int):
    """The reference's ``route_one``, batched over the rows: each choice's
    position within its expert ``(B, S·k)``, counted over the token-major,
    k-minor flattening of idx ``(B, S, k)``; whether it is within the
    capacity ``C``; and ``buf (B, E·C)``, the token each expert slot reads
    (``S``, the zero pad row, for an empty slot)."""
    B, S, k = idx.shape
    flat_e = idx.reshape(B, S * k)
    oh = torch.nn.functional.one_hot(flat_e, E)
    pos = (oh.cumsum(1) - oh).gather(-1, flat_e[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)            # E·C: dropped
    tok = torch.arange(S, device=idx.device).repeat_interleave(k).expand(B, S * k)
    buf = torch.full((B, E * C + 1), S, dtype=torch.int64, device=idx.device)
    buf = buf.scatter_(1, slot, tok)[:, :E * C]     # a kept slot is written once
    return pos, keep, buf


def moe_apply(p, cfg: ArchConfig, x):
    """Top-k token-choice MoE with per-row capacity (the reference's
    ``moe_apply``).  x: ``(B, S, D)`` -> ``(y (B, S, D), router logits (B,
    S, E) float32)``.

    The router product is ``x.float() @ router`` (TF32 stays off on the
    card, PyTorch's default).  The weights are cast to x's dtype before the
    combine.  Every expert computes all its ``C`` capacity rows (the empty
    ones read the zero pad row), in decode too, as a batched product over
    the experts.  The combine adds each token's kept slots in ascending
    expert order into zero, rounding to x's dtype after each add: the order
    of the reference's sequential scatter-add, with no atomics, so two runs
    give the same bits on the card.  Its backward (and the dispatch
    gather's) is plain autograd."""
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, x.shape[1])
    logits = x.float() @ p["router"]
    w, idx = moe_topk(logits, K)
    pos, keep, buf = moe_slots(idx, E, C)
    ye = moe_experts(p, cfg, moe_dispatch(x, buf, E, C))
    return moe_combine(ye, w.to(x.dtype), idx, pos, keep, C), logits


def moe_dispatch(x, buf, E: int, C: int):
    """The rows each expert computes: ``xe (E, B·C, D)``, row ``b·C + p`` of
    expert e the token ``buf[b, e·C + p]`` of batch row b (the zero pad
    row for an empty slot)."""
    B, S, D = x.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], 1)
    rows = torch.arange(B, device=x.device)[None, :, None]
    return x_pad[rows, buf.view(B, E, C).transpose(0, 1)].reshape(E, B * C, D)


def moe_experts(p, cfg: ArchConfig, xe):
    """Each expert's FFN on its rows, one batched product over the experts
    (the reference's ``becd,edf->becf`` and back): ``(E, R, D) -> (E, R, D)``."""
    if cfg.ffn == "swiglu":
        h = nn.silu(torch.bmm(xe, p["e_gate"])) * torch.bmm(xe, p["e_up"])
    else:
        h = nn.gelu(torch.bmm(xe, p["e_up"]))
    return torch.bmm(h, p["e_down"])


def moe_combine(ye, w, idx, pos, keep, C: int):
    """The experts' rows back to their tokens: ``y[b, t] = Σ_k w[b, t, k]·
    ye[slot of (b, t, k)]`` over the kept slots.  ye: ``(E, B·C, D)``, row
    ``b·C + p`` of expert e holding slot p of batch row b; w ``(B, S, k)``
    in ye's dtype; idx as :func:`moe_topk`, pos and keep as
    :func:`moe_slots` give them.

    Each token's kept slots are added in ascending expert order into zero,
    each product and each sum rounded to ye's dtype: the order of the
    reference's sequential scatter-add over the slots.  A gather and a
    fixed loop over k, no atomics."""
    E, BC, D = ye.shape
    B, S, K = idx.shape
    # slot (b, e, p) is row e·B·C + b·C + p; row E·B·C is a zero row
    ye_pad = torch.cat([ye.reshape(E * BC, D), ye.new_zeros(1, D)])
    b_off = torch.arange(B, device=ye.device)[:, None] * C
    row = torch.where(keep, idx.reshape(B, S * K) * BC + b_off + pos, E * BC).view(B, S, K)
    order = torch.argsort(idx, dim=-1)                                # ascending expert
    row, kept, w = (t.gather(-1, order) for t in (row, keep.view(B, S, K), w))
    y = ye.new_zeros(B, S, D)
    for j in range(K):
        y = torch.where(kept[..., j, None], y + ye_pad[row[..., j]] * w[..., j, None], y)
    return y


def moe_aux_loss(logits):
    """Load-balancing auxiliary loss (Switch-style), float32: E·Σ_e (mean
    router probability of e)·(share of tokens whose top expert is e);
    ``argmax`` ties go to the first expert."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    frac_prob = probs.mean(dim=(0, 1))
    top1 = probs.argmax(dim=-1)
    frac_tok = torch.nn.functional.one_hot(top1, E).float().mean(dim=(0, 1))
    return E * torch.sum(frac_prob * frac_tok)


# =============================================================================
# Mamba2 mixer (SSD)
# =============================================================================


def mamba2_init(generator: torch.Generator, cfg: ArchConfig, lead: Sequence[int] = (),
                device=None):
    """The reference's ``mamba2_init`` scales and dtypes: ``A_log``,
    ``dt_bias`` and ``Dskip`` are float32 in a model of any dtype."""
    d = cfg.d_model
    di, N, H, k = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * N
    lead = tuple(lead)

    def w(shape):
        return _normal(generator, lead + shape, cfg.dtype, device)

    def per_head(v):
        return v.to(device).expand(lead + v.shape).clone()

    return {
        "in_proj": w((d, 2 * di + 2 * N + H)).mul_(1.0 / math.sqrt(d)),
        "conv_w": w((k, conv_dim)).div_(math.sqrt(k)),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=cfg.dtype, device=device),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))),
        "dt_bias": per_head(torch.log(torch.expm1(torch.full((H,), 0.01)))),  # softplus⁻¹
        "Dskip": per_head(torch.ones((H,), dtype=torch.float32)),
        "norm_g": torch.ones(lead + (di,), dtype=cfg.dtype, device=device),
        "out_proj": w((di, d)).div_(math.sqrt(di)).div_(math.sqrt(2 * cfg.num_layers)),
    }


def _causal_conv(xbc, w, b):
    """xbc: ``(B, S, Cdim)``; depthwise causal conv, kernel ``(k, Cdim)``."""
    k = w.shape[0]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i] for i in range(k))
    return out + b


def _split_zxbcdt(cfg: ArchConfig, zxbcdt):
    di, N = cfg.ssm_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di, N, N, cfg.ssm_heads], -1)


def _ssd_dispatch(x, a, b, c):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors
    (:func:`repro_torch.kernels.ops.ssd_chunk`)."""
    return ops.ssd_chunk(x, a, b, c)


def mamba2_apply(p, cfg: ArchConfig, x):
    """Train/prefill path (chunked SSD).  x: ``(B, S, D)``.

    Returns ``(out, cache)``; the cache is the terminal conv window (the
    last ``k − 1`` pre-activation conv inputs) and SSM state, so a prefill
    seeds the recurrent decode.  The rounding order is the reference's:
    x·dt is rounded to x's dtype before the scan, the skip term and the
    gate in x's dtype.  b and c go to the scan as views expanded over the
    heads (the reference broadcasts them)."""
    B, S, _ = x.shape
    di, N, H, P_ = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    k = cfg.ssm_conv
    z, xin, Bc, Cc, dt = _split_zxbcdt(cfg, x @ p["in_proj"])
    conv_in = torch.cat([xin, Bc, Cc], -1)                                # (B,S,conv_dim)
    xbc = nn.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xin, Bc, Cc = torch.split(xbc, [di, N, N], -1)
    dt = nn.softplus(dt.float() + p["dt_bias"])                           # (B,S,H)
    a = -torch.exp(p["A_log"]) * dt                                       # log-decay
    xh = xin.reshape(B, S, H, P_)
    xs = (xh * dt[..., None].to(xh.dtype)).transpose(1, 2)                # (B,H,S,P)
    y, h_final = _ssd_dispatch(xs, a.transpose(1, 2), Bc[:, None].expand(B, H, S, N),
                               Cc[:, None].expand(B, H, S, N))
    y = y + p["Dskip"][None, :, None, None].to(y.dtype) * xh.transpose(1, 2)
    y = y.transpose(1, 2).reshape(B, S, di)
    y = y * nn.silu(z)
    y = nn.rmsnorm({"g": p["norm_g"]}, y)
    cache = {"conv": conv_in[:, S - (k - 1):, :], "ssm": h_final}
    return y @ p["out_proj"], cache


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype, lead: Sequence[int] = (),
                      device=None):
    di, N, H, P_, k = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_conv
    lead = tuple(lead)
    return {"conv": torch.zeros(lead + (batch, k - 1, di + 2 * N), dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, H, N, P_), dtype=torch.float32, device=device)}


def mamba2_decode(p, cfg: ArchConfig, x, cache, pos):
    """Single-token recurrent step.  x: ``(B, 1, D)``.

    As in the reference, the decay is ``exp(a)`` itself and x·dt stays in
    float32 (the prefill rounds it to x's dtype).  The new conv window and
    SSM state are written into ``cache`` in place — where the reference
    returns them — and ``cache`` is returned; ``pos`` is unused."""
    B = x.shape[0]
    di, N, H, P_ = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xin, Bc, Cc, dt = _split_zxbcdt(cfg, x[:, 0] @ p["in_proj"])
    xbc_new = torch.cat([xin, Bc, Cc], -1)                                # (B, conv_dim)
    conv_win = torch.cat([cache["conv"], xbc_new[:, None]], 1)            # (B, k, conv)
    out = (conv_win * p["conv_w"][None]).sum(1) + p["conv_b"]
    xin, Bc, Cc = torch.split(nn.silu(out), [di, N, N], -1)
    dt = nn.softplus(dt.float() + p["dt_bias"])                           # (B,H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                            # (B,H) decay
    xh = xin.reshape(B, H, P_).float() * dt[..., None]
    h = cache["ssm"] * a[..., None, None] + Bc[:, None, :, None].float() * xh[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cc.float(), h)
    y = y + p["Dskip"][None, :, None] * xin.reshape(B, H, P_).float()
    y = y.reshape(B, di).to(x.dtype) * nn.silu(z)
    y = nn.rmsnorm({"g": p["norm_g"]}, y)
    cache["conv"].copy_(conv_win[:, 1:])
    cache["ssm"].copy_(h)
    return (y @ p["out_proj"])[:, None], cache
