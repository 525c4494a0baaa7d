"""Plain PyTorch versions of the ported kernels (port of
:mod:`repro.kernels.ref`).

Each function but :func:`fused_mlp`, :func:`flash_attention`,
:func:`ssd_chunk` and the cross entropy's is the definition the CUDA kernel in ``csrc/rev_heun.cu``
computes, with the same op order, so the two agree bitwise on the card
(chip_smoke.py checks it).  The MLP, attention and SSD kernels
(``csrc/fused_mlp.cu``, ``csrc/flash_attention.cu``, ``csrc/ssd_chunk.cu``)
sum in another order and are held to a tolerance; the MLP's backward kernel
is held to :func:`fused_mlp_bwd` the same way, and the attention's and the
SSD scan's backward passes are the autograd of the versions here
(:mod:`repro_torch.kernels.vjp`).  The
cross-entropy kernels (``csrc/fused_xent.cu``) are held to a tolerance
too, against :func:`fused_xent_fwd` and :func:`fused_xent_bwd`.  On
the CPU, :mod:`repro_torch.kernels.ops` runs these instead of the kernels;
with a card they run only when a caller asks for them with
``use_kernel=False``.

Scalars (``dt``, ``sign``) may be Python floats or 0-d tensors; a Python
float enters the arithmetic rounded to the tensor's dtype, exactly as the
kernels receive it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng
from ..nn import core as nn_core


def rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign: float = 1.0):
    """ẑ_{n+1} = 2 z_n − ẑ_n + μ_n (sign·Δt) + (sign·σ_n) ΔW_n."""
    return 2.0 * z - zh + mu * (sign * dt) + (sign * sigma) * dw


def rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign: float = 1.0):
    """z_{n+1} = z_n + (sign·½Δt)(μ_n+μ_{n+1}) + (sign·½)(σ_n+σ_{n+1}) ΔW_n."""
    return z + (sign * 0.5 * dt) * (mu + mu1) + (sign * 0.5) * (sigma + sigma1) * dw


def rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt):
    """Seeds of the field VJP: ``c_mu1 = ḡ_mu1 + ½(ḡ_z1·Δt)``,
    ``c_sig1 = ḡ_sig1 + ½(ḡ_z1·ΔW)``.

    The grouping is the transpose's own (power-of-two scalings commute with
    rounding; two-term sums are order-free), so each output is bitwise what
    autograd of the unfused step gives."""
    c_mu1 = g_mu1 + 0.5 * (g_z1 * dt)
    c_sig1 = g_sig1 + 0.5 * (g_z1 * dw)
    return c_mu1, c_sig1


def rev_heun_bwd_phase2(g_z1, ghat, dw, dt):
    """Distribute ``ĝ`` (the total ẑ₁ cotangent) onto the step-``n`` state:
    ``(d_z, d_zh, d_mu, d_sigma)``."""
    d_z = g_z1 + 2.0 * ghat
    d_zh = -ghat
    d_mu = 0.5 * (g_z1 * dt) + ghat * dt
    d_sigma = 0.5 * (g_z1 * dw) + ghat * dw
    return d_z, d_zh, d_mu, d_sigma


def brownian_increment(k1, k2, n, shape, dtype, dt, window=None):
    """Step-``n`` increment of a uniform grid with spacing ``dt``:
    ``normal(fold_in(key, n), shape)·sqrt(dt)``.

    ``k1, k2``: key word tensors of any batch shape ``K``; the result has
    shape ``(*K, *shape)``, one independent draw per key.  ``window = (e0,
    size)``: ``shape`` is a block of elements ``[e0, e0 + prod(shape))`` of
    the ``size``-element draw (a data-parallel rank's rows of a one-key
    increment), bitwise that slice of it.
    """
    f1, f2 = prng.fold_in(k1, k2, n)
    z = prng.normal_like(f1, f2, tuple(shape), dtype, window)
    return z * torch.sqrt(torch.as_tensor(dt, dtype=dtype, device=z.device))



def bridge_descent(k1, k2, t, t0: float, t1: float, depth: int):
    """The scalar walk of :func:`brownian_value` (the reference's
    ``scal_body``) -> ``(stds, go_lefts, km1, km2, a, b)``: per level (a
    leading ``depth`` axis over ``t.shape``) the bridge std, the go-left
    bit and the midpoint key words, then the last interval ``[a, b]``."""
    a = torch.full_like(t, t0)
    b = torch.full_like(t, t1)
    c1, c2 = prng.fold_in(k1, k2, 0xB0B)
    stds, gos, chain1, chain2 = [], [], [], []
    for _ in range(depth):
        m = 0.5 * (a + b)
        stds.append(torch.sqrt((b - m) * (m - a) / (b - a)))
        go_left = t <= m
        gos.append(go_left)
        chain1.append(c1)
        chain2.append(c2)
        c1, c2 = prng.fold_in(c1, c2, torch.where(go_left, 2, 3))
        a, b = torch.where(go_left, a, m), torch.where(go_left, m, b)
    if not depth:
        empty = t.new_empty((0,) + t.shape)
        return empty, empty.bool(), empty.long(), empty.long(), a, b
    # every level's midpoint key fold_in(c, 1), in one call
    km1, km2 = prng.fold_in(torch.stack(chain1), torch.stack(chain2), 1)
    return torch.stack(stds), torch.stack(gos), km1, km2, a, b


def brownian_value(k1, k2, t, t0: float, t1: float, shape, dtype, depth: int = 24):
    """``W(t) − W(t0)`` by Lévy-bridge descent to ``depth`` levels
    (``repro.kernels.ref.brownian_value``, step for step).

    ``k1, k2``: key words of shape ``(R,)``; ``t``: the rows' query times,
    an ``(R,)`` tensor (under the reference's ``vmap`` each row has its
    own).  Returns ``(R, *shape)``.  The root key ``fold_in(key, 0xB0B)``
    draws ``W(t1) = normal·sqrt(t1 − t0)``; each level halves the row's
    interval at ``m = ½(a+b)``, draws the midpoint from ``fold_in(c, 1)``
    with the bridge std ``sqrt((b−m)(m−a)/(b−a))`` and descends into the
    half holding ``t`` with the child key ``fold_in(c, 2 | 3)``
    (:func:`bridge_descent`); all levels' midpoints are drawn in one call,
    combined level by level, and the tail interpolates linearly inside the
    last interval.
    """
    shape = tuple(shape)
    t = t.to(dtype)
    lead = t.shape + (1,) * len(shape)
    r1, r2 = prng.fold_in(k1, k2, 0xB0B)
    sqrt_span = torch.sqrt(torch.as_tensor(t1 - t0, dtype=dtype, device=t.device))
    wb = prng.normal_like(r1, r2, shape, dtype) * sqrt_span
    wa = torch.zeros_like(wb)
    stds, gos, km1, km2, a, b = bridge_descent(k1, k2, t, t0, t1, depth)
    zms = prng.normal_like(km1, km2, shape, dtype)
    for i in range(depth):
        wm = 0.5 * (wa + wb) + stds[i].reshape(lead) * zms[i]
        left = gos[i].reshape(lead)
        wa, wb = torch.where(left, wa, wm), torch.where(left, wm, wb)
    frac = torch.clamp((t - a) / torch.clamp(b - a, min=torch.finfo(dtype).tiny), 0.0, 1.0)
    return wa + frac.reshape(lead) * (wb - wa)


def _split2(k1, k2):
    """``jax.random.split(key)``'s two keys as word tensors: ``(a1, a2),
    (b1, b2)`` (:func:`prng.split`, one hash per counter pair)."""
    bits = prng.random_bits(k1, k2, 32, 4)
    return (bits[..., 0], bits[..., 1]), (bits[..., 2], bits[..., 3])


def true_divide(x, c: float):
    """``x / c`` by a true division: on the card ``tensor / python_scalar``
    multiplies by the scalar's reciprocal, which is not the kernels' (nor
    numpy's, nor the reference's) division for a ``c`` that is not a power
    of two."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def space_time_scales(dt: float, dtype):
    """``(sqrt(dt), sqrt(dt/12))`` with ``dt`` rounded to ``dtype`` and each
    op rounded once in it (IEEE, on the host): the scales of a ``(W, H)``
    draw over an interval of length ``dt``, as
    ``repro.core.brownian.space_time_levy_area`` forms them."""
    np_dtype = prng._NP_DTYPES[dtype]
    d = np_dtype(dt)
    return float(np.sqrt(d)), float(np.sqrt(d / np_dtype(12.0)))


def levy_pair(k1, k2, shape, dtype, dt, window=None):
    """``(W, H)`` over an interval of length ``dt`` from the key words:
    ``kw, kh = split(key)``, ``W = normal(kw)·sqrt(dt)``, ``H =
    normal(kh)·sqrt(dt/12)`` (the reference's ``space_time_levy_area``).
    ``k1, k2``: any batch shape ``K``; both results ``(*K, *shape)``
    (``window`` as :func:`brownian_increment`'s)."""
    (a1, a2), (b1, b2) = _split2(k1, k2)
    s_w, s_h = space_time_scales(dt, dtype)
    return (prng.normal_like(a1, a2, tuple(shape), dtype, window) * s_w,
            prng.normal_like(b1, b2, tuple(shape), dtype, window) * s_h)


def space_time_increment(k1, k2, n, shape, dtype, dt, window=None):
    """``(W, H)`` of step ``n`` of a uniform grid with spacing ``dt``: the
    pair of ``fold_in(key, n)`` (:func:`levy_pair`)."""
    return levy_pair(*prng.fold_in(k1, k2, n), shape, dtype, dt, window)


def wh_descent(k1, k2, t, t0: float, t1: float, depth: int):
    """The scalar walk of :func:`space_time_value`: per level (a leading
    ``depth`` axis over ``t.shape``) the interval's length ``h``, ``half =
    ½h``, the go-left bit, the two conditional scales ``sqrt(half/8)`` and
    ``sqrt(half³/24)`` and the words of the level's two normal keys
    ``split(fold_in(c, 1))``; then the last interval ``[a, b]``.  The chain
    starts at the root key ``c = fold_in(key, 0xB0BA)`` and moves to
    ``fold_in(c, 2 | 3)``."""
    a = torch.full_like(t, t0)
    b = torch.full_like(t, t1)
    c1, c2 = prng.fold_in(k1, k2, 0xB0BA)
    hs, halves, gos, chain1, chain2 = [], [], [], [], []
    for _ in range(depth):
        h = b - a
        half = 0.5 * h
        m = a + half
        go_left = t <= m
        hs.append(h)
        halves.append(half)
        gos.append(go_left)
        chain1.append(c1)
        chain2.append(c2)
        c1, c2 = prng.fold_in(c1, c2, torch.where(go_left, 2, 3))
        a, b = torch.where(go_left, a, m), torch.where(go_left, m, b)
    if not depth:
        empty = t.new_empty((0,) + t.shape)
        keys = (empty.long(), empty.long())
        return empty, empty, empty.bool(), empty, empty, keys, keys, a, b
    f1, f2 = prng.fold_in(torch.stack(chain1), torch.stack(chain2), 1)
    k0, k1_ = _split2(f1, f2)
    h, half = torch.stack(hs), torch.stack(halves)
    s0 = torch.sqrt(half / 8.0)
    s1 = torch.sqrt(true_divide(half * (half * half), 24.0))
    return h, half, torch.stack(gos), s0, s1, k0, k1_, a, b


def space_time_value(k1, k2, t, t0: float, t1: float, shape, dtype, depth: int = 24):
    """``(W(t) − W(t0), I(t))``, ``I(t) = ∫_{t0}^t (W_r − W_{t0}) dr``, by
    the joint ``(W, ∫W)`` Lévy-bridge descent of the reference's
    ``BrownianPath._wh`` (src/repro/core/brownian.py:238-312), op for op
    but without its FMAs.

    ``k1, k2``: key words ``(R,)``; ``t``: the rows' times ``(R,)``.  The
    root draws ``(w, A)`` over ``[t0, t1]`` from ``split(fold_in(key,
    0xB0BA))``; each level draws the midpoint's conditional pair from
    ``split(fold_in(c, 1))`` (:func:`wh_descent`)::

        w_l = 1.5·A/h − 0.25·w + sqrt(half/8)·ξ0
        a_l = (−0.25·half)·w + 0.5·A + sqrt(half³/24)·ξ1

    keeps the left half or the right (``w − w_l``, ``A − a_l − half·w_l``,
    the prefix ``(pw, pi)`` advanced), and the depth bound closes with the
    conditional mean inside the last interval.  Returns two ``(R,
    *shape)`` tensors."""
    shape = tuple(shape)
    t = t.to(dtype)
    lead = t.shape + (1,) * len(shape)
    span = float(prng._NP_DTYPES[dtype](t1 - t0))
    w, h_root = levy_pair(*prng.fold_in(k1, k2, 0xB0BA), shape, dtype, t1 - t0)
    area = span * (h_root + 0.5 * w)
    pw = torch.zeros_like(w)
    pi = torch.zeros_like(w)
    h, half, gos, s0, s1, k0, kk1, a, b = wh_descent(k1, k2, t, t0, t1, depth)
    xi0 = prng.normal_like(k0[0], k0[1], shape, dtype)
    xi1 = prng.normal_like(kk1[0], kk1[1], shape, dtype)
    for i in range(depth):
        hl, hf = h[i].reshape(lead), half[i].reshape(lead)
        w_l = (1.5 * area / hl - 0.25 * w) + s0[i].reshape(lead) * xi0[i]
        a_l = ((-0.25 * hf) * w + 0.5 * area) + s1[i].reshape(lead) * xi1[i]
        w_r = w - w_l
        a_r = (area - a_l) - hf * w_l
        left = gos[i].reshape(lead)
        pi = torch.where(left, pi, (pi + hf * pw) + a_l)
        pw = torch.where(left, pw, pw + w_l)
        w, area = torch.where(left, w_l, w_r), torch.where(left, a_l, a_r)
    hh = b - a
    th = torch.clamp((t - a) / torch.clamp(hh, min=torch.finfo(dtype).tiny), 0.0, 1.0)
    th2 = th * th
    th3 = th * th2
    c1 = 3.0 * th2 - 2.0 * th
    c2 = (6.0 * th) * (1.0 - th)
    w_t = (pw + c1.reshape(lead) * w) + (c2.reshape(lead) * area) / hh.reshape(lead)
    i_t = (((pi + (th * hh).reshape(lead) * pw) + (hh * (th3 - th2)).reshape(lead) * w)
           + (3.0 * th2 - 2.0 * th3).reshape(lead) * area)
    return w_t, i_t


def fused_mlp(x, w1, b1, w2, b2):
    """Linear → LipSwish → Linear (``repro.kernels.ref.fused_mlp``): x
    ``(..., Din)``, w1 ``(Din, H)``, w2 ``(H, Dout)`` -> ``(..., Dout)``,
    with the port's written-out :func:`repro_torch.nn.lipswish`.  Every op
    rounds to x's dtype; the CUDA kernel (``csrc/fused_mlp.cu``) accumulates
    bfloat16 in float32 and sums in its own fixed order, so the two agree to
    a tolerance (f32 2e-5, bf16 6e-2, f64 1e-12), not bitwise."""
    return nn_core.lipswish(x @ w1 + b1) @ w2 + b2


def fused_mlp_bwd(x, w1, b1, w2, b2, g):
    """The VJP of :func:`fused_mlp` at cotangent ``g`` ``(..., Dout)`` ->
    ``(dx, dW1, db1, dW2, db2)`` in the inputs' shapes and dtype (``b2``
    is not read: ``db2 = Σ g``).  With ``pre = x·W1 + b1``, ``s = σ(pre)``::

        a    = 0.909·pre·s              (rounded to x's dtype)
        da   = g·W2ᵀ
        dpre = da ⊙ 0.909·(s + pre·s·(1 − s))
        dW2 = aᵀg,  db2 = Σ_rows g,  dW1 = xᵀ·dpre,  db1 = Σ_rows dpre,
        dx  = dpre·W1ᵀ

    float32 and float64 operands compute in their dtype; bfloat16 ones in
    float32, with ``a`` rounded to bfloat16 and the gradients to bfloat16 at
    the end: the arithmetic of the JAX package's Pallas kernel
    (``preferred_element_type=float32``) and of ``csrc/fused_mlp.cu``.  The
    backward kernel sums in its own order, so the two agree to a tolerance
    (f32 2e-5, bf16 6e-2, f64 1e-12)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    din, dout = w1.shape[0], w2.shape[1]
    xa = x.reshape(-1, din).to(acc)
    ga = g.reshape(-1, dout).to(acc)
    w1a = w1.to(acc)
    pre = xa @ w1a + b1.to(acc)
    s = 1.0 / (1.0 + torch.exp(-pre))
    ps = pre * s
    a = (0.909 * ps).to(x.dtype).to(acc)
    dpre = (ga @ w2.to(acc).T) * (0.909 * (s + ps * (1.0 - s)))
    grads = ((dpre @ w1a.T).reshape(x.shape), xa.T @ dpre, dpre.sum(0), a.T @ ga, ga.sum(0))
    return tuple(t.to(x.dtype) for t in grads)


def check_causal_keys(S: int, Sk: int, causal: bool) -> None:
    """Refuse causal attention with a key length of its own: its mask is
    ``tril(S, S)``, and no caller needs another (the cross-attention is
    full)."""
    if causal and Sk != S:
        raise ValueError(f"flash_attention: causal attention needs the key length equal to the "
                         f"query length, got Sk {Sk} against S {S} (cross-attention is "
                         f"causal=False)")


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """GQA attention, the reference's definition (``repro.kernels.ref.
    flash_attention``) op for op: q ``(B, Hq, S, D)``; k, v ``(B, Hkv, Sk,
    D)``, Hq % Hkv == 0.  Sk is S for self-attention; a key length of its
    own (the encoder-decoder's cross-attention, what the reference's
    ``blockwise_attention`` takes) only when not ``causal``: the causal
    mask is ``tril(S, S)``, and causal with Sk != S raises.

    K and V are repeated to the query heads; scores in the input dtype, then
    ``.float() * scale``; a ``-inf`` causal mask; softmax; P cast back to the
    input dtype; then P·V.  The default scale is ``1/sqrt(D)`` rounded to the
    input dtype, as ``ref.py`` rounds it (0.08837890625 in bf16 at D = 128);
    the CUDA kernel, like the Pallas kernel, takes the float ``1/sqrt(D)``.
    """
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    check_causal_keys(q.shape[2], k.shape[2], causal)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(D))).to(q.dtype)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if causal:
        S = q.shape[2]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)


def ssd_chunk(x, a, b, c):
    """The Mamba2 SSD recurrence, the reference's sequential definition
    (``repro.kernels.ref.ssd_scan``): x ``(B, H, S, P)``, a ``(B, H, S)``
    log-decays (<= 0), b and c ``(B, H, S, N)`` (any strides; the mixer
    passes them expanded over heads with stride 0)::

        h_t = exp(a_t)·h_{t-1} + b_t ⊗ x_t,   y_t = c_tᵀ h_t,   h_0 = 0

    in float32, one position at a time (each slice is cast as it is read,
    so no float32 copy of an expanded b or c is made).  Returns ``y`` in
    x's dtype and the terminal state ``h_S`` ``(B, H, N, P)`` in float32 —
    the second output of ``ssd_chunked_dense``, which seeds the decode.
    The CUDA kernel (``csrc/ssd_chunk.cu``) computes the same function in
    the chunked matrix form and agrees to a tolerance, not bitwise.
    """
    Bb, H, S, P = x.shape
    N = b.shape[-1]
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bb, H, S, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        xt = x[:, :, t].float()
        bt = b[:, :, t].float()
        h = torch.exp(a[:, :, t].float())[..., None, None] * h + bt[..., :, None] * xt[..., None, :]
        ys[:, :, t] = torch.einsum("bhn,bhnp->bhp", c[:, :, t].float(), h)
    return ys.to(x.dtype), h


def _label_index(labels, vocab: int):
    """``take_along_axis``'s indexing: a label in ``[-V, 0)`` counts from
    the end; ``(index clamped into range, valid)`` for the rest."""
    lab = labels.long()
    lab = torch.where(lab < 0, lab + vocab, lab)
    valid = (lab >= 0) & (lab < vocab)
    return lab.clamp(0, vocab - 1), valid


def _xent_acc(logits):
    """The logits in the arithmetic type: float32 for float32 and bfloat16
    (the reference's), float64 kept (gradcheck)."""
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def fused_xent_fwd(logits, labels):
    """Per-token cross entropy and its log-sum-exp: logits ``(..., V)`` in
    float32 or bfloat16, int labels ``(...)`` -> ``(loss, lse)``, both
    ``(...)`` float32.  ``loss = lse − logit[label]``, in float32 (the
    reference's :func:`fused_xent`); a label outside ``[-V, V)`` gives NaN,
    as the reference's gather fills it."""
    lf = _xent_acc(logits)
    lse = torch.logsumexp(lf, dim=-1)
    idx, valid = _label_index(labels, logits.shape[-1])
    ll = torch.gather(lf, -1, idx[..., None])[..., 0]
    loss = torch.where(valid, lse - ll, torch.full_like(lse, math.nan))
    return loss, lse


def fused_xent(logits, labels):
    """Per-token next-token cross entropy, logsumexp in float32
    (``repro.kernels.ref.fused_xent``): logits ``(..., V)``, labels
    ``(...)`` -> ``(...)`` float32."""
    return fused_xent_fwd(logits, labels)[0]


def fused_xent_bwd(logits, labels, lse, g):
    """The cross entropy's VJP: ``g[..., None]·(exp(x − lse) −
    onehot(label))`` in float32, returned in the logits' dtype.  ``lse``
    and ``g`` are ``(...)`` float32."""
    idx, valid = _label_index(labels, logits.shape[-1])
    p = torch.exp(_xent_acc(logits) - lse[..., None])
    hit = torch.zeros_like(p).scatter_(-1, idx[..., None], valid[..., None].to(p.dtype))
    return (g[..., None] * (p - hit)).to(logits.dtype)
