"""Optimizers as ``(init, update)`` pairs over parameter trees (port of
:mod:`repro.optim.optimizers`: ``OptState``, ``adam``, ``adamw``,
``adadelta``, ``apply_updates``, ``chain``, ``lipschitz_projection``,
``clip_by_global_norm``, ``cosine_schedule``, ``swa_update``).

Paper Appendix F trains Latent SDEs with Adam and SDE-GANs with Adadelta
(careful clipping at the end of the discriminator's chain, stochastic
weight averaging of the generator); AdamW with a cosine schedule serves
the LM training path.  Every optimiser is an ``(init, update)`` pair with
``update(updates, state, params) -> (updates, state)``, and :func:`chain`
composes them left to right.  The rounding points are the reference's:

* the moments live in ``moment_dtype`` (default: the parameter dtype);
  ``g·g`` is taken in the gradient's dtype and then cast;
* the update is computed in float32 — ``m / (1 − b1^step)`` over
  ``sqrt(v / (1 − b2^step)) + eps`` — and cast to the gradient's dtype, so
  float64 parameters get float32-rounded updates exactly as there;
* the step counter is a host integer: the bias corrections and the
  learning rate are float32 scalars computed on the host (numpy float32,
  ``cos`` of a float32 argument), which costs no device launch;
* AdamW's decay ``u − lr_t·wd·p`` takes the dtype JAX gives it: ``lr_t`` is
  a float32 array there, so a bfloat16 update and parameter come out
  float32, and :func:`apply_updates` then promotes the parameters.  A
  bfloat16 model therefore trains in float32 from its second step on, as
  the reference's does (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tree

_F32 = np.float32


class OptState(NamedTuple):
    step: int
    m: object
    v: object


def _moment_dtype(name: Optional[str]):
    return None if name is None else getattr(torch, str(name).removeprefix("torch."))


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         moment_dtype: Optional[str] = None):
    """Adam (``lr`` a float or a ``step -> lr`` callable).  ``moment_dtype``
    (e.g. ``"float32"``) sets the moments' dtype; None keeps the
    parameters'."""
    mdt = _moment_dtype(moment_dtype)

    def _moments(params):
        if mdt is None:
            return tree.map(torch.zeros_like, params)
        return tree.map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params)

    def init(params):
        return OptState(0, _moments(params), _moments(params))

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype), state.m, grads)
        v = tree.map(lambda v_, g: b2 * v_ + (1 - b2) * (g * g).to(v_.dtype), state.v,
                     grads)
        bc1 = float(_F32(1) - _F32(b1) ** _F32(step))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(step))
        lr_t = lr(step) if callable(lr) else lr
        upd = tree.map(
            lambda m_, v_, g: (-lr_t * (m_.float() / bc1)
                               / (torch.sqrt(v_.float() / bc2) + eps)).to(g.dtype),
            m, v, grads)
        return upd, OptState(step, m, v)

    return init, update


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: Optional[str] = None):
    """AdamW: Adam's update minus ``lr_t·weight_decay·p``, in the dtype the
    reference's promotion gives (float32 for bfloat16 parameters)."""
    ai, au = adam(lr, b1, b2, eps, moment_dtype=moment_dtype)

    def update(grads, state, params):
        upd, state = au(grads, state, params)
        lr_t = lr(state.step) if callable(lr) else lr
        lr_wd = float(_F32(lr_t) * _F32(weight_decay))

        def decay(u, p):
            dt = torch.promote_types(torch.float32, p.dtype)
            return u.to(torch.promote_types(dt, u.dtype)) - lr_wd * p.to(dt)

        return tree.map(decay, upd, params), state

    return ai, update


def adadelta(lr: float = 1.0, rho: float = 0.9, eps: float = 1e-6):
    """Adadelta, the paper's SDE-GAN optimiser: ``acc_g ← ρ·acc_g +
    (1−ρ)·g·g``, ``u = −lr·g·sqrt(acc_d + eps) / sqrt(acc_g + eps)`` (in
    that order), ``acc_d ← ρ·acc_d + (1−ρ)·u·u``, all in the gradient's
    dtype."""

    def init(params):
        return OptState(0, tree.map(torch.zeros_like, params),
                        tree.map(torch.zeros_like, params))

    def update(grads, state: OptState, params=None):
        acc_g = tree.map(lambda a, g: rho * a + (1 - rho) * g * g, state.m, grads)
        upd = tree.map(lambda g, ag, ad: -lr * g * torch.sqrt(ad + eps) / torch.sqrt(ag + eps),
                       grads, acc_g, state.v)
        acc_d = tree.map(lambda a, u: rho * a + (1 - rho) * u * u, state.v, upd)
        return upd, OptState(state.step + 1, acc_g, acc_d)

    return init, update


def apply_updates(params, updates):
    return tree.map(torch.add, params, updates)


def chain(*transforms):
    """Compose ``(init, update)`` transforms left to right; the states are
    carried as a tuple."""
    inits, updates = zip(*transforms)

    def init(params):
        return tuple(i(params) for i in inits)

    def update(grads, state, params=None):
        new_state = []
        for u, s in zip(updates, state):
            grads, s = u(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return init, update


def lipschitz_projection(clip_fn=None):
    """Careful clipping (paper §5) as the last transform of a chain.

    The paper clips the parameters after the optimiser's update; on updates
    that is ``u ← clip(params + u) − params``, so applying the returned
    update lands on the projected parameters (to the rounding of that
    subtraction and addition, as in the reference).  Stateless.  ``clip_fn``
    defaults to :func:`repro_torch.core.clipping.clip_pytree`; pass
    ``clip_lipschitz`` to clip only a discriminator's named MLPs."""
    from ..core.clipping import clip_pytree

    project = clip_fn if clip_fn is not None else clip_pytree

    def init(params):
        return ()

    def update(upd, state, params):
        if params is None:
            raise ValueError("lipschitz_projection needs params: the clip is a "
                             "projection of params + update, not of the update alone")
        clipped = project(apply_updates(params, upd))
        return tree.map(torch.sub, clipped, params), state

    return init, update


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / (‖g‖ + 1e-9))`` -> ``(grads,
    ‖g‖)``; the squares summed in float32 per leaf, the leaves added in the
    reference's tree order."""
    leaves = tree.leaves(grads)
    total = None
    for g in leaves:
        s = torch.sum(g.float() ** 2)
        total = s if total is None else total + s
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), grads), gnorm


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor·peak_lr``
    at ``total``: ``step -> lr`` as a float32 value (a Python float)."""
    peak, warm_n = _F32(peak_lr), _F32(max(warmup, 1))
    span = _F32(max(total - warmup, 1))

    def lr(step):
        s = _F32(step)
        if s < _F32(warmup):
            return float(peak * s / warm_n)
        frac = min(max((s - _F32(warmup)) / span, _F32(0)), _F32(1))
        cos = peak * (_F32(floor) + _F32((1 - floor) * 0.5)
                      * (_F32(1) + np.cos(_F32(math.pi) * frac)))
        return float(cos)

    return lr


def swa_update(avg_params, params, num_avged: int):
    """Cesàro (Polyak) averaging, the paper's generator average over the
    latter half of the GAN steps: ``a + (p − a)/(n + 1)``."""
    w = 1.0 / (num_avged + 1)
    return tree.map(lambda a, p: a + w * (p - a), avg_params, params)
