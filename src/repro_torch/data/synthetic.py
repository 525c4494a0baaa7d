"""Deterministic synthetic air-quality data (port of
:mod:`repro.data.synthetic`: ``air_quality_like`` and
``_normalise_initial``).

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


def _normalise_initial(ys):
    """Paper Appendix F normalisation: zero-mean/unit-variance initial value
    (population std, as ``jnp.std``)."""
    m = torch.mean(ys[0])
    s = torch.std(ys[0], correction=0) + 1e-6
    return (ys - m) / s
