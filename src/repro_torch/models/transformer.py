"""The LM zoo: init, forward, prefill and decode (port of
:mod:`repro.models.transformer`, every family: dense with GQA or MLA
attention, MoE, pure SSM, hybrid, the VLM's prefix of embeddings and the
encoder-decoder).

Parameters keep the reference's pytree: ``{"embed", "final_norm", "head"
(untied only), "units": [block]}``, where ``units`` holds one block per
entry of :func:`unit_pattern` (one for the homogeneous families, jamba's
8-layer unit for the hybrid) and every block leaf carries a leading unit
axis; unit ``i`` is the view ``leaf[i]``, as the reference's unrolled
path slices it.  The encoder-decoder adds ``enc_units`` (its encoder's
blocks, ``encoder_layers`` deep), ``enc_final_norm`` and ``cross`` (``{"ln",
"attn"}``, one cross-attention per decoder layer, stacked alike).  So
:func:`repro_torch.checkpoint.params_from_jax` carries a JAX LM's weights
across as they are.  Caches are the same: a list of per-block dicts with a
leading unit axis, ``{"k", "v": (U, B, S, Hkv, hd)}`` for GQA attention,
``{"ckv": (U, B, S, kv_lora_rank), "kpe": (U, B, S, qk_rope_head_dim)}``
for MLA (the latent cache), ``{"conv": (U, B, k − 1, inner + 2N), "ssm":
(U, B, H, N, P) float32}`` for the Mamba2 mixer, and ``{"self": {"k", "v"},
"cross": {"k", "v"}}`` for the encoder-decoder's decoder (the cross cache
is the encoder's length and never padded).

The layer stack is a Python loop (``scan_layers`` is an XLA compile hint).
``remat`` is honoured as the reference's ``jax.checkpoint`` per unit is:
with grad enabled each unit (each decoder unit of the encoder-decoder)
runs under :func:`torch.utils.checkpoint.checkpoint`, so only a unit's
input is kept and its activations are recomputed in the backward; the
checkpointed unit returns its MoE aux loss beside ``x``.  That changes
memory and never a number.  ``reversible_residual`` runs the training
forward (no cache, causal) as the reference's two-track reversible-Heun
stack (:mod:`repro_torch.models.reversible`), a different architecture
than the vanilla stack, with O(1) activations in depth; a prefill keeps
the vanilla stack, as the reference's does.  Decode writes each layer's
new K/V row (latent row, conv window and SSM state) into the stacked cache
in place, where the reference donates the buffer; :func:`lm_decode` and
:func:`encdec_decode` return the same cache object.

The training loss :func:`lm_loss` is the reference's: the mean next-token
cross entropy over the text region (a VLM's prefix rows are sliced off)
plus 0.01 times the MoE aux loss (the sum over the MoE blocks of
:func:`repro_torch.models.layers.moe_aux_loss`, 0 without one).  On the
card its per-token losses come from ``fused_xent`` (a forward and a
backward kernel launch) through the module-level hook
:func:`_xent_dispatch`; on the CPU it is the plain :func:`softmax_xent`.
The route is chosen by the logits' device only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import nn, tree
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L

Params = Dict[str, Any]


class NotPortedError(NotImplementedError):
    """An execution option of the reference that the port lacks."""


# =============================================================================
# unit pattern
# =============================================================================


def unit_pattern(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) per layer in the smallest repeating unit of the stack."""
    if cfg.ssm:
        return [("mamba", "none")]
    if cfg.family == "hybrid":
        size = math.lcm(cfg.attn_every, cfg.moe_every if cfg.moe else 1)
        return [("attn" if l % cfg.attn_every == 0 else "mamba",
                 "moe" if cfg.moe and l % cfg.moe_every == 1 else "dense")
                for l in range(size)]
    if cfg.moe:
        return [("attn", "moe")]
    return [("attn", "dense")]


def num_units(cfg: ArchConfig) -> int:
    size = len(unit_pattern(cfg))
    if cfg.num_layers % size:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers is not a multiple of the "
                         f"unit size {size}")
    return cfg.num_layers // size


# =============================================================================
# norms and blocks
# =============================================================================


def _norm_init(cfg: ArchConfig, lead=(), device=None):
    init = nn.layernorm_init if cfg.norm == "layernorm" else nn.rmsnorm_init
    p = init(cfg.d_model, cfg.dtype, device)
    return {k: v.expand(tuple(lead) + v.shape).clone() for k, v in p.items()}


def _norm(cfg: ArchConfig, p, x):
    return nn.layernorm(p, x) if cfg.norm == "layernorm" else nn.rmsnorm(p, x)


def _mixer_init(generator, cfg: ArchConfig, mixer: str, lead, device):
    if mixer == "mamba":
        return L.mamba2_init(generator, cfg, lead, device)
    init = L.mla_init if cfg.attention == "mla" else L.gqa_init
    return init(generator, cfg, lead, device)


def block_init(generator: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
               lead=(), device=None) -> Params:
    p: Params = {"ln1": _norm_init(cfg, lead, device),
                 "mixer": _mixer_init(generator, cfg, mixer, lead, device)}
    if ffn != "none":
        p["ln2"] = _norm_init(cfg, lead, device)
        p["ffn"] = (L.moe_init if ffn == "moe" else L.ffn_init)(generator, cfg, lead, device)
    return p


def _aux_zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p: Params, cfg: ArchConfig, mixer: str, ffn: str, x, causal: bool = True):
    """Full-sequence block (``causal=False``: the encoder's).  Returns ``(x,
    cache_entry, aux_loss)``: the MoE block's load-balancing loss, a
    float32 0 for the others."""
    h = _norm(cfg, p["ln1"], x)
    if mixer == "mamba":
        o, cache = L.mamba2_apply(p["mixer"], cfg, h)
    elif cfg.attention == "mla":
        o, (ckv, kpe) = L.mla_attend(p["mixer"], cfg, h, causal=causal)
        cache = {"ckv": ckv, "kpe": kpe}
    else:
        o, (k, v) = L.gqa_attend(p["mixer"], cfg, h, causal=causal)
        cache = {"k": k, "v": v}
    x = x + o
    aux = _aux_zero(x)
    if ffn == "moe":
        f, router_logits = L.moe_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
        aux = L.moe_aux_loss(router_logits)
        x = x + f
    elif ffn != "none":
        x = x + L.ffn_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
    return x, cache, aux


def block_decode(p: Params, cfg: ArchConfig, mixer: str, ffn: str, x, cache, pos):
    """Single-token block step against ``cache`` (updated in place).  x: ``(B, 1, D)``."""
    h = _norm(cfg, p["ln1"], x)
    if mixer == "mamba":
        decode = L.mamba2_decode
    else:
        decode = L.mla_decode if cfg.attention == "mla" else L.gqa_decode
    o, cache = decode(p["mixer"], cfg, h, cache, pos)
    x = x + o
    if ffn == "moe":
        x = x + L.moe_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))[0]
    elif ffn != "none":
        x = x + L.ffn_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
    return x, cache


# =============================================================================
# the unit stack (decoder-only LMs and the encoder)
# =============================================================================


def init_lm(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Fresh weights at the reference's scales, drawn on the generator's
    device (a CUDA generator draws the full-size model on the card) and
    moved to ``device``: embed N(0, 1)·0.02, head N(0, 1)/sqrt(d_model),
    the stacked blocks as :func:`block_init`, and for the encoder-decoder
    its encoder and cross-attention (:func:`_init_encoder`)."""
    n = num_units(cfg)
    params: Params = {
        "embed": L._normal(generator, (cfg.vocab, cfg.d_model), cfg.dtype, device).mul_(0.02),
        "final_norm": _norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(generator, (cfg.d_model, cfg.vocab), cfg.dtype,
                                   device).div_(math.sqrt(cfg.d_model))
    params["units"] = [block_init(generator, cfg, m, f, lead=(n,), device=device)
                       for m, f in unit_pattern(cfg)]
    if cfg.family == "encdec":
        params.update(_init_encoder(generator, cfg, device))
    return params


def _layer(units, i: int):
    """Layer ``i``'s blocks: views ``leaf[i]`` of the stacked leaves."""
    return tree.map(lambda a: a[i], units)


def _unit_apply(uparams, cfg: ArchConfig, x, causal: bool = True):
    """One unit's blocks (``uparams``, sliced from the stack) -> ``(x, its
    blocks' caches, aux)``; aux sums the blocks' aux losses in order from
    0, as the reference's ``_unit_apply``."""
    caches, aux = [], _aux_zero(x)
    for bp, (m, f) in zip(uparams, unit_pattern(cfg)):
        x, c, a = block_apply(bp, cfg, m, f, x, causal=causal)
        aux = aux + a
        caches.append(c)
    return x, caches, aux


def _unit_residual(uparams, cfg: ArchConfig, x):
    """Residual delta of one unit, ``F(θ, x) = unit(x) − x``: the vector
    field of the reversible stack (σ = 0 reversible Heun over depth)."""
    return _unit_apply(uparams, cfg, x)[0] - x


def _stack_forward(params_units, cfg: ArchConfig, x, want_cache: bool = False,
                   causal: bool = True, n_units: Optional[int] = None):
    """Run the unit stack (``n_units`` deep, default :func:`num_units`;
    ``causal=False``: the encoder).  Returns ``(x, stacked caches | None,
    aux)``, aux the units' aux losses summed in order from 0.

    With ``cfg.reversible_residual``, no cache wanted and causal, the stack
    is the reference's reversible-Heun stack (its MoE aux loss is not
    threaded through: 0).  Otherwise, with ``cfg.remat``, grad enabled and
    no cache wanted (training), each unit runs under a non-reentrant
    checkpoint, as the reference wraps each unit in ``jax.checkpoint``, and
    returns ``(x, aux)``; the units draw no random numbers, so the RNG
    state is not saved."""
    if cfg.reversible_residual and not want_cache and causal:
        from .reversible import reversible_stack

        return reversible_stack(cfg, params_units, x, _unit_residual), None, _aux_zero(x)
    remat = _remat(cfg, want_cache)
    per_unit, aux = [], _aux_zero(x)
    for i in range(n_units or num_units(cfg)):
        if remat:
            x, a = checkpoint(
                lambda xi, i=i: _unit_apply(_layer(params_units, i), cfg, xi, causal)[::2], x,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, caches, a = _unit_apply(_layer(params_units, i), cfg, x, causal)
            if want_cache:
                per_unit.append(caches)
        aux = aux + a
    if not want_cache:
        return x, None, aux
    return x, _stack_caches(per_unit), aux


def _remat(cfg: ArchConfig, want_cache: bool) -> bool:
    """Whether training units run under a checkpoint (``cfg.remat`` with
    grad enabled and no cache wanted); the reference's 'collectives'
    policy is refused."""
    remat = cfg.remat and torch.is_grad_enabled() and not want_cache
    if remat and cfg.remat_policy == "collectives":
        raise NotPortedError(
            "remat_policy='collectives' (save only the post-all-reduce activations) "
            "belongs to the LM's sharded execution, not ported yet — "
            "ROADMAP.md Queue 1, 'Sharded LM execution'")
    return remat


def _stack_caches(per_unit):
    """Per-unit lists of per-block cache dicts (nested for the
    encoder-decoder) -> one list of per-block dicts, every leaf stacked
    over the units."""
    return [tree.map(lambda *xs: torch.stack(xs), *(u[j] for u in per_unit))
            for j in range(len(per_unit[0]))]


def _embed(params, cfg: ArchConfig, tokens, embeds=None):
    """Token embeddings, behind the ``embeds`` prefix ``(B, P, d_model)``
    (the VLM's patch embeddings) where one is given."""
    x = params["embed"][tokens.long()]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], 1)
    return x


def _lm_head(params, cfg: ArchConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w


def lm_forward(params, cfg: ArchConfig, tokens, embeds=None):
    """Train-mode forward: logits over the full sequence (the ``embeds``
    prefix included) + the MoE aux loss (float32; 0 for a stack without a
    MoE block)."""
    x = _embed(params, cfg, tokens, embeds)
    x, _, aux = _stack_forward(params["units"], cfg, x)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), aux


def lm_prefill(params, cfg: ArchConfig, tokens, embeds=None, max_len: Optional[int] = None):
    """Prefill: last-position logits ``(B, 1, vocab)`` + the populated cache,
    sized to the prompt (the ``embeds`` prefix included), or padded to
    ``max_len`` slots.

    A Mamba2 stack needs a prompt of at least ``ssm_conv − 1`` tokens to
    fill its conv window: the reference's cache comes out short below that
    and its first decode step fails on the shapes, so the port refuses it
    here by name."""
    k = cfg.ssm_conv
    if tokens.shape[1] < k - 1 and any(m == "mamba" for m, _ in unit_pattern(cfg)):
        raise ValueError(f"{cfg.name}: a prompt of {tokens.shape[1]} tokens is shorter than "
                         f"the conv window's ssm_conv - 1 = {k - 1}; the Mamba2 decode "
                         f"cache needs that many (ROADMAP.md Queue 3)")
    x = _embed(params, cfg, tokens, embeds)
    x, caches, _ = _stack_forward(params["units"], cfg, x, want_cache=True)
    x = _norm(cfg, params["final_norm"], x)
    logits = _lm_head(params, cfg, x[:, -1:, :])
    if max_len is not None:
        caches = _pad_caches(caches, max_len)
    return logits, caches


def _pad_caches(caches, max_len: int):
    """Zero-pad the sequence axis (2 of ``(U, B, S, ...)``) of the attention
    caches (GQA's ``k``, ``v``, MLA's ``ckv``, ``kpe``) to ``max_len``; the
    Mamba2 ``conv`` and ``ssm`` leaves have no sequence axis and stay as
    they are."""
    def pad(leaf):
        if leaf.dim() >= 3 and leaf.shape[2] < max_len:
            out = leaf.new_zeros(leaf.shape[:2] + (max_len,) + leaf.shape[3:])
            out[:, :, :leaf.shape[2]] = leaf
            return out
        return leaf

    return [{k: pad(v) if k in ("k", "v", "ckv", "kpe") else v for k, v in c.items()}
            for c in caches]


def lm_decode(params, cfg: ArchConfig, token, caches, pos):
    """One decode step.  token: ``(B, 1)`` int32; pos: the position (int).
    ``caches``: the stacked cache, updated in place.  Returns ``(logits
    (B, 1, vocab), caches)``."""
    x = _embed(params, cfg, token)
    pat = unit_pattern(cfg)
    for i in range(num_units(cfg)):
        for bp, c, (m, f) in zip(_layer(params["units"], i), _layer(caches, i), pat):
            x, _ = block_decode(bp, cfg, m, f, x, c, pos)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), caches


def init_cache_zeros(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """The stacked cache of zeros, one dict per block of the unit:
    ``{"k", "v": (U, B, max_len, Hkv, hd)}`` (GQA) or ``{"ckv", "kpe"}``
    (MLA) in ``cfg.dtype`` for attention, ``{"conv": (U, B, k − 1, inner +
    2N)}`` in ``cfg.dtype`` and ``{"ssm": (U, B, H, N, P)}`` in float32 for
    the Mamba2 mixer (the reference's ``block_cache_spec``)."""
    lead = (num_units(cfg),)
    attn = L.mla_init_cache if cfg.attention == "mla" else L.gqa_init_cache
    return [L.mamba2_init_cache(cfg, batch, cfg.dtype, lead, device) if m == "mamba"
            else attn(cfg, batch, max_len, cfg.dtype, lead, device)
            for m, _ in unit_pattern(cfg)]


# =============================================================================
# encoder-decoder (seamless-m4t)
# =============================================================================


def _init_encoder(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """The encoder's blocks (self-attention + FFN, ``encoder_layers``
    deep), its final norm, and one cross-attention (norm + GQA) per
    decoder layer."""
    n = cfg.num_layers
    return {
        "enc_units": [block_init(generator, cfg, "attn", "dense", lead=(cfg.encoder_layers,),
                                 device=device)],
        "enc_final_norm": _norm_init(cfg, device=device),
        "cross": {"ln": _norm_init(cfg, (n,), device),
                  "attn": L.gqa_init(generator, cfg, (n,), device)},
    }


def encode(params, cfg: ArchConfig, src_embeds):
    """The bidirectional encoder over the stub frame embeddings ``(B, Ss,
    D)``, in ``cfg.dtype``."""
    x = src_embeds.to(cfg.dtype)
    x, _, _ = _stack_forward(params["enc_units"], cfg, x, causal=False,
                             n_units=cfg.encoder_layers)
    return _norm(cfg, params["enc_final_norm"], x)


def _dec_unit(uparams, cross_p, cfg: ArchConfig, x, enc_out):
    """One decoder unit: causal self-attention, cross-attention over the
    encoder's output, FFN -> ``(x, [{"self": {"k", "v"}, "cross": {"k",
    "v"}}])``, one cache dict a block."""
    caches = []
    for bp in uparams:
        o, (k, v) = L.gqa_attend(bp["mixer"], cfg, _norm(cfg, bp["ln1"], x), causal=True)
        x = x + o
        oc, (ck, cv) = L.gqa_attend(cross_p["attn"], cfg, _norm(cfg, cross_p["ln"], x),
                                    causal=False, kv_source=enc_out)
        x = x + oc
        x = x + L.ffn_apply(bp["ffn"], cfg, _norm(cfg, bp["ln2"], x))
        caches.append({"self": {"k": k, "v": v}, "cross": {"k": ck, "v": cv}})
    return x, caches


def _decoder(params, cfg: ArchConfig, x, enc_out, want_cache: bool):
    """The decoder stack -> ``(x, per-unit caches)``; in training
    (``cfg.remat``, grad enabled, no cache) each unit runs under a
    checkpoint, as the reference's ``jax.checkpoint`` of its decoder unit."""
    remat = _remat(cfg, want_cache)
    per_unit = []
    for i in range(num_units(cfg)):
        uparams, cross_p = _layer(params["units"], i), _layer(params["cross"], i)
        if remat:
            x = checkpoint(lambda xi, e, u=uparams, c=cross_p: _dec_unit(u, c, cfg, xi, e)[0],
                           x, enc_out, use_reentrant=False, preserve_rng_state=False)
        else:
            x, caches = _dec_unit(uparams, cross_p, cfg, x, enc_out)
            if want_cache:
                per_unit.append(caches)
    return x, per_unit


def encdec_forward(params, cfg: ArchConfig, tokens, src_embeds):
    """Full encoder-decoder training forward -> ``(logits, aux = 0)``."""
    enc_out = encode(params, cfg, src_embeds)
    x, _ = _decoder(params, cfg, _embed(params, cfg, tokens), enc_out, want_cache=False)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), _aux_zero(x)


def encdec_prefill(params, cfg: ArchConfig, tokens, src_embeds, max_len: Optional[int] = None):
    """Encode the source and prefill the decoder -> ``(last-position logits,
    caches)``.  With ``max_len`` only the self-attention cache is padded:
    the cross cache keeps the (fixed) source length, and its attention is
    unmasked, so padding it would corrupt the softmax."""
    enc_out = encode(params, cfg, src_embeds)
    x, per_unit = _decoder(params, cfg, _embed(params, cfg, tokens), enc_out, want_cache=True)
    x = _norm(cfg, params["final_norm"], x)
    logits = _lm_head(params, cfg, x[:, -1:, :])
    caches = _stack_caches(per_unit)
    if max_len is not None:
        caches = [{"self": _pad_caches([c["self"]], max_len)[0], "cross": c["cross"]}
                  for c in caches]
    return logits, caches


def encdec_decode(params, cfg: ArchConfig, token, caches, pos):
    """One decoder step: causal self-attention against the self cache
    (written in place at ``pos``) and cross-attention against the fixed
    encoder cache.  Returns ``(logits (B, 1, vocab), caches)``."""
    x = _embed(params, cfg, token)
    for i in range(num_units(cfg)):
        cross_p = _layer(params["cross"], i)
        for bp, c in zip(_layer(params["units"], i), _layer(caches, i)):
            x = x + L.gqa_decode(bp["mixer"], cfg, _norm(cfg, bp["ln1"], x), c["self"], pos)[0]
            x = x + L.gqa_cross_decode(cross_p["attn"], cfg, _norm(cfg, cross_p["ln"], x),
                                       c["cross"]["k"], c["cross"]["v"])
            x = x + L.ffn_apply(bp["ffn"], cfg, _norm(cfg, bp["ln2"], x))
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), caches


def encdec_cache_zeros(cfg: ArchConfig, batch: int, max_len: int, src_len: int, device=None):
    """The decoder's stacked cache of zeros (the reference's
    ``encdec_cache``): ``{"self": {"k", "v": (U, B, max_len, Hkv, hd)},
    "cross": {"k", "v": (U, B, src_len, Hkv, hd)}}`` per block."""
    lead = (num_units(cfg),)
    return [{"self": L.gqa_init_cache(cfg, batch, max_len, cfg.dtype, lead, device),
             "cross": L.gqa_init_cache(cfg, batch, src_len, cfg.dtype, lead, device)}
            for _ in unit_pattern(cfg)]


# =============================================================================
# loss
# =============================================================================


def softmax_xent(logits, labels):
    """Mean next-token cross entropy; logsumexp in float32 (the reference's
    ``softmax_xent``, the plain route of :func:`lm_loss`)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def _xent_dispatch(logits, labels):
    """Per-token losses on the card: :func:`repro_torch.kernels.ops.fused_xent`
    (one forward and one backward kernel launch)."""
    return ops.fused_xent(logits, labels)


def lm_loss(params, cfg: ArchConfig, batch, aux_weight: float = 0.01):
    """Unified training loss.  ``batch`` keys: ``tokens``, ``labels`` (+
    ``embeds``, the VLM's prefix, whose rows the loss skips; +
    ``src_embeds`` for the encoder-decoder).  Returns ``(loss, {"xent",
    "moe_aux"})``."""
    if cfg.family == "encdec":
        logits, aux = encdec_forward(params, cfg, batch["tokens"], batch["src_embeds"])
    else:
        logits, aux = lm_forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
        if "embeds" in batch:                      # the loss on the text region only
            logits = logits[:, batch["embeds"].shape[1]:, :]
    labels = batch["labels"]
    if logits.is_cuda:
        loss = torch.mean(_xent_dispatch(logits.contiguous(), labels))
    else:
        loss = softmax_xent(logits, labels)
    return loss + aux_weight * aux, {"xent": loss, "moe_aux": aux}
