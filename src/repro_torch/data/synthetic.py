"""Deterministic synthetic data (port of :mod:`repro.data.synthetic`:
``ou_process``, ``air_quality_like``, ``_normalise_initial`` and the LM's
``token_batches``; ``air_quality_rows`` draws one ``air_quality_like``
profile per key).

The paper's Beijing air-quality set (Appendix F: PM2.5 and O₃, 24 hourly
steps, 12 location labels) is offline, so the reference generates a
distribution-matched stand-in from a PRNG key; this is the same generator on
the port's Threefry (:mod:`repro_torch.kernels.prng`).  Bits — keys,
labels, uniforms — are the reference's exactly; the floats differ by the
ulps of ``sin``/``exp`` and the normal transform (tests/test_torch_training.py
states the tolerance).  Everything is drawn on the key's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import prng

#: Label dtype per state dtype: JAX's default ``int`` is int32 without x64
#: (the float32 runs) and int64 with it (the float64 runs).
LABEL_DTYPES = {torch.float32: torch.int32, torch.float64: torch.int64}


def _linspace(start: float, stop: float, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace``'s formula: ``start·(1−s) + stop·s`` with
    ``s = iota/div``, endpoint appended exactly (torch.linspace rounds the
    second half from the end)."""
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def _normal(key, shape, dtype):
    return prng.normal_like(key[0], key[1], tuple(shape), dtype)


def ou_process(key: torch.Tensor, batch: int, length: int = 32, rho: float = 0.02,
               kappa: float = 0.1, chi: float = 0.4, dtype=torch.float32):
    """Paper F.7's time-dependent Ornstein–Uhlenbeck process, the SDE-GAN's
    data: ``dY = (ρt − κY) dt + χ dW`` on ``t ∈ [0, length−1]`` with ``dt =
    1``, stepped by Euler–Maruyama.  ``key``: a ``(2,)`` int64 key; ``k0,
    key = split(key)`` draw the ``(batch, 1)`` start and the ``(length−1,
    batch, 1)`` increments.  Returns ``(length, batch, 1)``, normalised to a
    zero-mean, unit-variance initial value."""
    k0, k1 = prng.split(key)
    y = _normal(k0, (batch, 1), dtype)  # stationary-ish start
    eps = _normal(k1, (length - 1, batch, 1), dtype)
    f = np.float32 if dtype == torch.float32 else np.float64
    ys = [y]
    for n in range(length - 1):  # dt = 1, sqrt(dt) = 1; ρt in the data's dtype
        y = y + (float(f(rho) * f(n)) - kappa * y) + chi * eps[n]
        ys.append(y)
    return _normalise_initial(torch.stack(ys))


def air_quality_like(key: torch.Tensor, batch: int, length: int = 24,
                     num_labels: int = 12, dtype=torch.float32):
    """Bivariate (PM2.5-like, O₃-like) daily profiles with a class label.

    ``key``: a ``(2,)`` int64 key.  Returns ``(ys (length, batch, 2),
    labels (batch,))``, normalised to a zero-mean, unit-variance initial
    value."""
    kl, kp, ko, _ = prng.split(key, 4)
    labels = prng.randint(kl, batch, 0, num_labels, LABEL_DTYPES[dtype])
    ts = _linspace(0.0, 1.0, length, dtype, key.device)[:, None, None]
    base = (labels.to(dtype) / num_labels)[None, :, None]
    pm = base + 0.3 * torch.sin(2 * math.pi * (ts + 0.2 * base)) \
        + 0.15 * _normal(kp, (length, batch, 1), dtype)
    peak_t = 0.55 + 0.25 * base
    o3 = 0.8 * torch.exp(-((ts - peak_t) ** 2) / 0.02) + base * 0.2 \
        + 0.1 * _normal(ko, (length, batch, 1), dtype)
    ys = torch.cat([pm, o3], -1)
    return _normalise_initial(ys), labels


def air_quality_rows(keys: torch.Tensor, length: int = 24, num_labels: int = 12,
                     dtype=torch.float32) -> torch.Tensor:
    """One profile per key, ``(length, B, 2)``: column ``i`` is
    ``air_quality_like(keys[i], 1, length)[0][:, 0]``, each normalised on its
    own initial value (the posterior decode's stand-in observations, drawn
    for every row in one batched pass)."""
    kk = prng.split(keys, 4)
    kl, kp, ko = kk[:, 0], kk[:, 1], kk[:, 2]
    labels = prng.randint(kl, 1, 0, num_labels, LABEL_DTYPES[dtype])[:, 0]
    ts = _linspace(0.0, 1.0, length, dtype, keys.device)[:, None]
    base = (labels.to(dtype) / num_labels)[None, :]
    pm = base + 0.3 * torch.sin(2 * math.pi * (ts + 0.2 * base)) \
        + 0.15 * prng.normal(kp[:, 0], kp[:, 1], length, dtype).T
    peak_t = 0.55 + 0.25 * base
    o3 = 0.8 * torch.exp(-((ts - peak_t) ** 2) / 0.02) + base * 0.2 \
        + 0.1 * prng.normal(ko[:, 0], ko[:, 1], length, dtype).T
    ys = torch.stack([pm, o3], -1)
    # each row's mean and population std over its two channels, the sums
    # written out: torch.std's CPU kernel rounds a lone row differently from
    # a row among others, and a row's bits must not depend on its batch
    m = ((ys[0, :, 0] + ys[0, :, 1]) / 2)[:, None]
    d = ys[0] - m
    s = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) / 2)[:, None] + 1e-6
    return (ys - m) / s


def _normalise_initial(ys):
    """Paper Appendix F normalisation: zero-mean/unit-variance initial value
    (population std, as ``jnp.std``)."""
    m = torch.mean(ys[0])
    s = torch.std(ys[0], correction=0) + 1e-6
    return (ys - m) / s


def token_batches(key: torch.Tensor, step: int, batch: int, seq_len: int, vocab: int):
    """Deterministic LM token pipeline: the batch of global step ``step`` is
    a pure function of ``(key, step)``, so a restart replays the same data.
    Zipf-like ranks ``floor(V^u)`` with ``u ~ U[1e-6, 1)``, then with
    probability 0.3 a copy of the previous token.  ``key``: a ``(2,)`` int64
    key.  Returns ``{"tokens", "labels"}``, each ``(batch, seq_len)`` int32,
    bitwise the reference's.  ``V^u`` is taken in float64 and rounded to
    float32: XLA's float32 ``pow`` is nearly correctly rounded, and the
    floor of the rounded float64 power matched it on 2M draws at every
    vocab of the port, where float32 ``torch.pow`` (7 mismatched floors
    per 2M at V = 32000) and ``exp(u·log V)`` did not."""
    k1, k2 = prng.split(prng.fold_in_key(key, step))
    n = batch * (seq_len + 1)
    # jax.random.uniform(k1, minval=1e-6): XLA contracts floats·scale + lo
    # into one FMA; the float64 product of two float32 values is exact, so
    # rounding the float64 sum once to float32 gives the FMA's bits.
    lo = np.float32(1e-6)
    floats = prng.uniform(k1[0], k1[1], n, torch.float32)
    u = torch.clamp((floats.double() * float(np.float32(1) - lo) + float(lo)).float(),
                    min=float(lo))
    ranks = torch.floor(torch.pow(float(vocab), u.double()).float()).reshape(batch, seq_len + 1)
    toks = torch.clamp(ranks.to(torch.int32) - 1, 0, vocab - 1)
    rep = prng.uniform(k2[0], k2[1], n, torch.float32).reshape(batch, seq_len + 1) \
        < float(np.float32(0.3))
    toks = torch.where(rep, torch.roll(toks, 1, dims=1), toks)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
