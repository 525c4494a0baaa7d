"""Adam as an ``(init, update)`` pair over parameter trees (port of
:mod:`repro.optim.optimizers`: ``OptState``, ``adam``, ``apply_updates``).

Paper Appendix F trains Latent SDEs with Adam.  As in the reference, the
moments live in the parameter dtype but the update itself is computed in
float32 — ``m / (1 − b1^step)`` over ``sqrt(v / (1 − b2^step)) + eps`` — and
cast back, so float64 parameters get float32-rounded updates exactly as
there.  The step counter is a host integer: the bias corrections are
float32 scalars computed on the host, which costs no device launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tree


class OptState(NamedTuple):
    step: int
    m: object
    v: object


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam (``lr`` a float or a ``step -> lr`` callable)."""

    def init(params):
        zeros = tree.map(torch.zeros_like, params)
        return OptState(0, zeros, tree.map(torch.zeros_like, params))

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype), state.m, grads)
        v = tree.map(lambda v_, g: b2 * v_ + (1 - b2) * (g * g).to(v_.dtype), state.v,
                     grads)
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        lr_t = lr(step) if callable(lr) else lr
        upd = tree.map(
            lambda m_, v_, g: (-lr_t * (m_.float() / bc1)
                               / (torch.sqrt(v_.float() / bc2) + eps)).to(g.dtype),
            m, v, grads)
        return upd, OptState(step, m, v)

    return init, update


def apply_updates(params, updates):
    return tree.map(torch.add, params, updates)
