"""Sequence-mixing and FFN layers of the transformer zoo (port of
:mod:`repro.models.layers`), the dense family's: RoPE, GQA self-attention
(full sequence and single-token decode against a cache) and the dense FFN.

Parameters are dicts of tensors in the reference's layout (``x @ w``).
``*_init`` draw fresh weights from an explicit ``torch.Generator`` at the
reference's scales; ``lead`` prepends a leading shape to every leaf, which
is how :func:`repro_torch.models.transformer.init_lm` stacks the layers.

Not ported: ``distributed.sharding.hint``, ``checkpoint_name`` and the
``attn_mha_tp`` K/V repeat are layout hints for XLA's partitioner with no
counterpart on one card (they return with ``distributed/``, ROADMAP.md
Queue 1, item 13); ``blockwise_attention`` is the XLA path of the
reference — on the card the attention runs in the CUDA kernel, on the CPU
in its plain version.  MLA, MoE, mamba2 and cross-attention raise
:class:`LayerNotPortedError`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import nn
from ..configs.base import ArchConfig
from ..kernels import ops


class LayerNotPortedError(NotImplementedError):
    """A layer of the reference that the port lacks."""


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


def _attend_dispatch(cfg: ArchConfig, q, k, v, causal: bool):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors
    (:func:`repro_torch.kernels.ops.flash_attention`).  The kernel takes
    contiguous ``(B, H, S, D)`` operands: the copies the reference's
    ``swapaxes`` materialise."""
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)


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


def _project_qkv(p, cfg: ArchConfig, x, positions, kv_source=None):
    if kv_source is not None:
        raise LayerNotPortedError(
            "cross-attention (kv_source) is the encoder-decoder family's; not ported "
            "yet — ROADMAP.md Queue 1, item 14")
    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions, x.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attend(p, cfg: ArchConfig, x, causal: bool = True, kv_source=None):
    """Full-sequence self-attention (train/prefill).  x: ``(B, S, D)``.
    Returns ``(out, (k, v))``, k and v ``(B, S, Hkv, hd)`` for the cache."""
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
