"""Dispatch: the hand CUDA kernel for CUDA tensors, the plain version for
CPU tensors (port of :mod:`repro.kernels.ops`).

Policy, by the device of the operands and nothing else:

* CUDA tensors run the kernel.  A build or launch failure raises; nothing
  gives way to the plain version.
* CPU tensors run the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
  — the port has no kernel interpreter, so this is the only CPU path.
* ``use_kernel=False`` runs the plain version on any device: chip_smoke.py
  and the tests compare the two this way.  ``use_kernel=True`` insists on
  the kernel and raises for CPU tensors.

"""

from __future__ import annotations

from typing import Optional

import torch

from . import brownian as _bk
from . import flash_attention as _fa
from . import fused_mlp as _fm
from . import ref
from . import reversible_heun_step as _rh
from . import ssd_chunk as _ssd
from . import xent as _xent


def _decide(name: str, tensor: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is False:
        return False
    if tensor.is_cuda:
        return True
    if use_kernel:
        raise ValueError(f"{name}: use_kernel=True needs CUDA tensors; the CUDA "
                         f"kernels have no CPU mode (got {tensor.device})")
    return False


def rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign: float = 1.0,
                    use_kernel: Optional[bool] = None):
    if _decide("rev_heun_phase1", z, use_kernel):
        return _rh.rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign)
    return ref.rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign)


def rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign: float = 1.0,
                    use_kernel: Optional[bool] = None):
    if _decide("rev_heun_phase2", z, use_kernel):
        return _rh.rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign)
    return ref.rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign)


def rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt, use_kernel: Optional[bool] = None):
    """Field-VJP seeds ``(c_mu1, c_sig1)`` of the fused exact adjoint."""
    if _decide("rev_heun_bwd_phase1", g_z1, use_kernel):
        return _rh.rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt)
    return ref.rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt)


def rev_heun_bwd_phase2(g_z1, ghat, dw, dt, use_kernel: Optional[bool] = None):
    """Step-``n`` cotangents ``(d_z, d_zh, d_mu, d_sigma)`` from ``ĝ``."""
    if _decide("rev_heun_bwd_phase2", g_z1, use_kernel):
        return _rh.rev_heun_bwd_phase2(g_z1, ghat, dw, dt)
    return ref.rev_heun_bwd_phase2(g_z1, ghat, dw, dt)


def rev_heun_phase1_gen(z, zh, mu, sigma, key, n, dt_grid, dt, sign: float = 1.0,
                        use_kernel: Optional[bool] = None, window=None):
    """Phase 1 with ΔW drawn from ``key`` (shape ``(*K, 2)``) — ``(ẑ₁, ΔW)``.
    ``window = (e0, size)``: one key, ``z`` the block of elements ``[e0, e0
    + z.numel())`` of the ``size``-element draw (a data-parallel rank's
    rows)."""
    if _decide("rev_heun_phase1_gen", z, use_kernel):
        return _bk.rev_heun_phase1_gen(z, zh, mu, sigma, key, n, dt_grid, dt, sign, window)
    k1, k2 = key[..., 0], key[..., 1]
    dw = ref.brownian_increment(k1, k2, n, z.shape[key.dim() - 1:], z.dtype, dt_grid,
                                window)
    return ref.rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign), dw


def brownian_increment(key, n, shape, dtype, dt, use_kernel: Optional[bool] = None,
                       window=None):
    """Step-``n`` uniform-grid increment per key: ``(*K, *shape)``; with
    ``window = (e0, size)`` (one key) the block ``shape`` of elements
    ``[e0, e0 + prod(shape))`` of the ``size``-element draw."""
    if _decide("brownian_increment", key, use_kernel):
        return _bk.brownian_increment(key, n, tuple(shape), dtype, dt, window)
    return ref.brownian_increment(key[..., 0], key[..., 1], n, tuple(shape), dtype, dt,
                                  window)


def brownian_value(key, t, t0, t1, shape, dtype, depth: int = 24,
                   use_kernel: Optional[bool] = None):
    """``W(t) − W(t0)`` by Lévy-bridge descent, one path per key row:
    ``key`` ``(R, 2)``, ``t`` ``(R,)`` in ``dtype`` -> ``(R, *shape)``."""
    if _decide("brownian_value", key, use_kernel):
        return _bk.brownian_value(key, t, t0, t1, tuple(shape), dtype, depth)
    return ref.brownian_value(key[..., 0], key[..., 1], t, t0, t1, tuple(shape), dtype,
                              depth)


def space_time_increment(key, n, shape, dtype, dt, use_kernel: Optional[bool] = None,
                         window=None):
    """``(W, H)`` of uniform-grid step ``n`` per key, each ``(*K, *shape)``:
    ``space_time_levy_area(fold_in(key, n), dt)`` (``window`` as
    :func:`brownian_increment`'s)."""
    if _decide("space_time_increment", key, use_kernel):
        return _bk.space_time_increment(key, n, tuple(shape), dtype, dt, window)
    return ref.space_time_increment(key[..., 0], key[..., 1], n, tuple(shape), dtype, dt,
                                    window)


def space_time_value(key, t, t0, t1, shape, dtype, depth: int = 24,
                     use_kernel: Optional[bool] = None):
    """``(W(t) − W(t0), I(t))`` by the joint ``(W, ∫W)`` bridge descent, one
    path per key row: ``key`` ``(R, 2)``, ``t`` ``(R,)`` in ``dtype`` -> two
    ``(R, *shape)`` tensors."""
    if _decide("space_time_value", key, use_kernel):
        return _bk.space_time_value(key, t, t0, t1, tuple(shape), dtype, depth)
    return ref.space_time_value(key[..., 0], key[..., 1], t, t0, t1, tuple(shape), dtype,
                                depth)


def fused_mlp(x, w1, b1, w2, b2, use_kernel: Optional[bool] = None):
    """Linear → LipSwish → Linear: x ``(..., Din)``, w1 ``(Din, H)``, w2
    ``(H, Dout)`` -> ``(..., Dout)`` (a depth-1 SDE field's MLP)."""
    if _decide("fused_mlp", x, use_kernel):
        return _fm.fused_mlp(x, w1, b1, w2, b2)
    return ref.fused_mlp(x, w1, b1, w2, b2)


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None):
    """GQA attention: q ``(B, Hq, S, D)``, k and v ``(B, Hkv, S, D)``.  The
    default scale differs between the two versions exactly as between the
    Pallas kernel and ``ref.py`` (see :func:`ref.flash_attention`)."""
    if _decide("flash_attention", q, use_kernel):
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


def ssd_chunk(x, a, b, c, use_kernel: Optional[bool] = None):
    """The Mamba2 SSD scan: x ``(B, H, S, P)``, a ``(B, H, S)`` log-decays,
    b and c ``(B, H, S, N)`` -> ``(y in x's dtype, h_final (B, H, N, P)
    float32)``.  The JAX package's dispatcher returns y alone; the port also
    returns the terminal state, which seeds the decode cache."""
    if _decide("ssd_chunk", x, use_kernel):
        return _ssd.ssd_chunk(x, a, b, c)
    return ref.ssd_chunk(x, a, b, c)


def fused_xent(logits, labels, use_kernel: Optional[bool] = None):
    """Per-token cross entropy ``lse − logit[label]``: logits ``(..., V)``
    in float32 or bfloat16, int labels ``(...)`` -> ``(...)`` float32; on
    the card the forward and the backward are one kernel launch each."""
    if _decide("fused_xent", logits, use_kernel):
        return _xent.fused_xent(logits, labels)
    return ref.fused_xent(logits, labels)


# -----------------------------------------------------------------------------
# Precision-policy casts (the solve stack's bf16-compute / state-dtype policy)
# -----------------------------------------------------------------------------


def cast_to_compute(params, compute_dtype):
    """Every floating-point tensor leaf of ``params`` in ``compute_dtype``;
    integer leaves (keys, counters) and non-tensors pass through.  The cast
    is differentiable: a leaf's cotangent comes back in its own dtype."""
    from .. import tree

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(compute_dtype)
        return x

    return tree.map(cast, params)


def wrap_vector_field(field, compute_dtype):
    """``(params, t, z) -> f`` evaluated in ``compute_dtype``, the output cast
    back to the state's dtype.  Under autograd the cotangents of the
    parameters and of the state come back up-cast, so accumulation (adjoint
    sums, the loop's carries, the optimiser) stays in the state dtype; only
    the field's arithmetic runs low.  ``t`` keeps its own dtype: time
    resolution does not degrade with the policy."""

    def wrapped(params, t, z):
        out = field(cast_to_compute(params, compute_dtype), t, z.to(compute_dtype))
        return out.to(z.dtype)

    return wrapped


def _launch_tables() -> tuple:
    return (_rh.LAUNCHES, _bk.LAUNCHES, _fa.LAUNCHES, _ssd.LAUNCHES, _fm.LAUNCHES,
            _xent.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches by name since the last :func:`reset_launch_counts`."""
    return {k: v for table in _launch_tables() for k, v in table.items()}


def reset_launch_counts() -> None:
    for table in _launch_tables():
        for name in table:
            table[name] = 0


def uncount_launches(counts: dict) -> None:
    """Take ``counts`` back off the launch counters: the wrapper calls made
    while a CUDA graph was captured, which record their kernels and launch
    nothing (whoever replays the graph counts its launches)."""
    for table in _launch_tables():
        for name in table:
            table[name] -= counts.get(name, 0)
