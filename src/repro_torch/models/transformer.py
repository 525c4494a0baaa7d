"""Decoder-only LM: init, forward, prefill and decode (port of
:mod:`repro.models.transformer`, the dense, MoE, pure-SSM and hybrid
families).

Parameters keep the reference's pytree: ``{"embed", "final_norm", "head"
(untied only), "units": [block]}``, where ``units`` holds one block per
entry of :func:`unit_pattern` (one for the homogeneous families, jamba's
8-layer unit for the hybrid) and every block leaf carries a leading unit
axis; unit ``i`` is the view ``leaf[i]``, as the reference's unrolled
path slices it.  So
:func:`repro_torch.checkpoint.params_from_jax` carries a JAX LM's weights
across as they are.  Caches are the same: a list of per-block dicts with a
leading unit axis, ``{"k", "v": (U, B, S, Hkv, hd)}`` for attention and
``{"conv": (U, B, k − 1, inner + 2N), "ssm": (U, B, H, N, P) float32}`` for
the Mamba2 mixer.

The layer stack is a Python loop (``scan_layers`` is an XLA compile hint;
``reversible_residual`` is not ported).  ``remat`` is honoured as the
reference's ``jax.checkpoint`` per unit is: with grad enabled each unit
runs under :func:`torch.utils.checkpoint.checkpoint`, so only a unit's
input is kept and its activations are recomputed in the backward; the
checkpointed unit returns its MoE aux loss beside ``x``.  That changes
memory and never a number.  Decode writes each
layer's new K/V row, or its new conv window and SSM state, into the
stacked cache in place, where the reference donates the buffer;
:func:`lm_decode` returns the same cache object.  MLA, encoder-decoder and
prefix ``embeds`` raise :class:`ModelNotPortedError` (ROADMAP.md Queue 1,
'The rest of the LM zoo').

The training loss :func:`lm_loss` is the reference's: the mean next-token
cross entropy plus 0.01 times the MoE aux loss (the sum over the MoE
blocks of :func:`repro_torch.models.layers.moe_aux_loss`, 0 without one).
On the card its per-token losses come from ``fused_xent`` (a forward and a
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


class ModelNotPortedError(NotImplementedError):
    """A model family or mode of the reference that the port lacks."""


class NotPortedError(NotImplementedError):
    """An execution option of the reference that the port lacks."""


def _not_ported(what: str):
    return ModelNotPortedError(f"{what} is not ported yet: the port has the dense, "
                               f"MoE, SSM and hybrid families — "
                               f"ROADMAP.md Queue 1, 'The rest of the LM zoo'")


# =============================================================================
# unit pattern
# =============================================================================


def unit_pattern(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) per layer in the smallest repeating unit of the stack."""
    if cfg.ssm:
        return [("mamba", "none")]
    if cfg.family == "encdec" or cfg.attention != "gqa":
        raise _not_ported(f"the {cfg.family} family ({cfg.name})")
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


def block_init(generator: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
               lead=(), device=None) -> Params:
    mix = (L.mamba2_init if mixer == "mamba" else L.gqa_init)(generator, cfg, lead, device)
    p: Params = {"ln1": _norm_init(cfg, lead, device), "mixer": mix}
    if ffn != "none":
        p["ln2"] = _norm_init(cfg, lead, device)
        p["ffn"] = (L.moe_init if ffn == "moe" else L.ffn_init)(generator, cfg, lead, device)
    return p


def _aux_zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p: Params, cfg: ArchConfig, mixer: str, ffn: str, x):
    """Full-sequence causal block.  Returns ``(x, cache_entry, aux_loss)``:
    the MoE block's load-balancing loss, a float32 0 for the others."""
    h = _norm(cfg, p["ln1"], x)
    if mixer == "mamba":
        o, cache = L.mamba2_apply(p["mixer"], cfg, h)
    else:
        o, (k, v) = L.gqa_attend(p["mixer"], cfg, h)
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
    decode = L.mamba2_decode if mixer == "mamba" else L.gqa_decode
    o, cache = decode(p["mixer"], cfg, h, cache, pos)
    x = x + o
    if ffn == "moe":
        x = x + L.moe_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))[0]
    elif ffn != "none":
        x = x + L.ffn_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
    return x, cache


# =============================================================================
# decoder-only LM
# =============================================================================


def init_lm(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Fresh weights at the reference's scales, drawn on the generator's
    device (a CUDA generator draws the full-size model on the card) and
    moved to ``device``: embed N(0, 1)·0.02, head N(0, 1)/sqrt(d_model),
    the stacked blocks as :func:`block_init`."""
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
    return params


def _layer(units, i: int):
    """Layer ``i``'s blocks: views ``leaf[i]`` of the stacked leaves."""
    return tree.map(lambda a: a[i], units)


def _unit_forward(params_units, cfg: ArchConfig, i: int, x):
    """Unit ``i`` of the stack -> ``(x, its blocks' caches, aux)``; aux sums
    the blocks' aux losses in order from 0, as the reference's
    ``_unit_apply``."""
    caches, aux = [], _aux_zero(x)
    for bp, (m, f) in zip(_layer(params_units, i), unit_pattern(cfg)):
        x, c, a = block_apply(bp, cfg, m, f, x)
        aux = aux + a
        caches.append(c)
    return x, caches, aux


def _stack_forward(params_units, cfg: ArchConfig, x, want_cache: bool = False):
    """Run the unit stack.  Returns ``(x, stacked caches | None, aux)``,
    aux the units' aux losses summed in order from 0.

    With ``cfg.remat``, grad enabled and no cache wanted (training), each
    unit runs under a non-reentrant checkpoint, as the reference wraps each
    unit in ``jax.checkpoint``, and returns ``(x, aux)``; the units draw no
    random numbers, so the RNG state is not saved."""
    remat = cfg.remat and torch.is_grad_enabled() and not want_cache
    if remat and cfg.remat_policy == "collectives":
        raise NotPortedError(
            "remat_policy='collectives' (save only the post-all-reduce activations) "
            "belongs to the LM's sharded execution, not ported yet — "
            "ROADMAP.md Queue 1, 'Sharded LM execution'")
    per_unit, aux = [], _aux_zero(x)
    for i in range(num_units(cfg)):
        if remat:
            x, a = checkpoint(lambda xi, i=i: _unit_forward(params_units, cfg, i, xi)[::2], x,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, caches, a = _unit_forward(params_units, cfg, i, x)
            if want_cache:
                per_unit.append(caches)
        aux = aux + a
    if not want_cache:
        return x, None, aux
    stacked = [{k: torch.stack([u[j][k] for u in per_unit]) for k in per_unit[0][j]}
               for j in range(len(unit_pattern(cfg)))]
    return x, stacked, aux


def _embed(params, cfg: ArchConfig, tokens, embeds=None):
    if embeds is not None:
        raise _not_ported("a prefix of embeddings (the vlm/audio frontends)")
    return params["embed"][tokens.long()]


def _lm_head(params, cfg: ArchConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w


def lm_forward(params, cfg: ArchConfig, tokens, embeds=None):
    """Train-mode forward: logits over the full sequence + the MoE aux loss
    (float32; 0 for a stack without a MoE block)."""
    x = _embed(params, cfg, tokens, embeds)
    x, _, aux = _stack_forward(params["units"], cfg, x)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), aux


def lm_prefill(params, cfg: ArchConfig, tokens, embeds=None, max_len: Optional[int] = None):
    """Prefill: last-position logits ``(B, 1, vocab)`` + the populated cache,
    sized to the prompt, or padded to ``max_len`` slots.

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
    caches to ``max_len``; the Mamba2 ``conv`` and ``ssm`` leaves have no
    sequence axis and stay as they are."""
    def pad(leaf):
        if leaf.dim() >= 3 and leaf.shape[2] < max_len:
            out = leaf.new_zeros(leaf.shape[:2] + (max_len,) + leaf.shape[3:])
            out[:, :, :leaf.shape[2]] = leaf
            return out
        return leaf

    return [{k: pad(v) if k in ("k", "v") else v for k, v in c.items()} for c in caches]


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
    ``{"k", "v": (U, B, max_len, Hkv, hd)}`` in ``cfg.dtype`` for attention,
    ``{"conv": (U, B, k − 1, inner + 2N)}`` in ``cfg.dtype`` and ``{"ssm":
    (U, B, H, N, P)}`` in float32 for the Mamba2 mixer (the reference's
    ``block_cache_spec``)."""
    lead = (num_units(cfg),)
    return [L.mamba2_init_cache(cfg, batch, cfg.dtype, lead, device) if m == "mamba"
            else L.gqa_init_cache(cfg, batch, max_len, cfg.dtype, lead, device)
            for m, _ in unit_pattern(cfg)]


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
    ``embeds``/``src_embeds`` for the vlm, audio and encdec families, which
    raise :class:`ModelNotPortedError`).  Returns ``(loss, {"xent",
    "moe_aux"})``."""
    if cfg.family == "encdec":
        raise _not_ported(f"the {cfg.family} family ({cfg.name})")
    logits, aux = lm_forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"))
    labels = batch["labels"]
    if logits.is_cuda:
        loss = torch.mean(_xent_dispatch(logits, labels))
    else:
        loss = softmax_xent(logits, labels)
    return loss + aux_weight * aux, {"xent": loss, "moe_aux": aux}
