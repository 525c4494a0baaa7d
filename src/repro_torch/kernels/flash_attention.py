"""Launcher of the GQA attention CUDA kernel (port of
:mod:`repro.kernels.flash_attention`).

:func:`flash_attention` replaces the Pallas kernel at
src/repro/kernels/flash_attention.py:67: causal or full attention with an
online softmax, q ``(B, Hq, S, D)``, k and v ``(B, Hkv, S, D)``, Hq % Hkv
== 0, float32 or bfloat16, D in {16, 64, 128}.  The kernel is in
``csrc/flash_attention.cu``; its plain version is
:func:`repro_torch.kernels.ref.flash_attention`.  The two sum in different
orders, so they agree to a tolerance (f32 2e-5, bf16 6e-2), not bitwise.

Gradients: the launch is one :class:`~repro_torch.kernels.vjp.PlainVJP`
node, whose backward is the VJP of the plain version at the saved q, k, v
and the float scale.  That backward materialises the ``(B, Hq, S, S)``
scores, as the plain version does; the JAX package has no backward kernel
either, and the LM training slice decides what replaces it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from .vjp import PlainVJP

#: Kernel launches made by this module's wrapper (one per launch).
LAUNCHES = {"flash_attention": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k, v are what the kernel takes."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: float32 or bfloat16, got {q.dtype}")
    if not q.is_cuda:
        raise ValueError(f"flash_attention: operands must be CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D (B, H, S, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: want q (B, Hq, S, D) and k, v (B, Hkv, S, D) "
                         f"with Hq % Hkv == 0, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be one of {HEAD_DIMS}, got {D}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: q, k, v must share dtype and device, got "
                             f"{t.dtype} on {t.device} against {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: operands must be contiguous and 16-byte "
                             "aligned")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention: batch {B} or heads {Hq} exceed the grid's 65535")


def _launch(q, k, v, causal: bool, scale: float):
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    B, Hq, S, D = q.shape
    lib = build.load()
    with build.device_guard(q.device):
        err = lib.rt_flash_attention(
            DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, k.shape[1], S, int(bool(causal)), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """GQA attention in one launch -> ``(B, Hq, S, D)`` in q's dtype,
    differentiable through the plain version.

    ``scale`` defaults to the float ``1/sqrt(D)``, as the Pallas kernel's
    wrapper has it (the plain version rounds it to the dtype first)."""
    check_operands(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return PlainVJP.apply(_launch, ref.flash_attention,
                          {"causal": bool(causal), "scale": float(scale)}, q, k, v)
