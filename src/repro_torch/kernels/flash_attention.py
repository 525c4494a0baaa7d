"""Launcher of the GQA attention CUDA kernel (port of
:mod:`repro.kernels.flash_attention`).

:func:`flash_attention` replaces the Pallas kernel at
src/repro/kernels/flash_attention.py:67: causal or full attention with an
online softmax, q ``(B, Hq, S, D)``, k and v ``(B, Hkv, Sk, D)``, Hq % Hkv
== 0, float32 or bfloat16, D in {16, 64, 96, 128} (96: MLA's concatenated
64 + 32 head).  Sk is S for self-attention and the encoder's length for
the encoder-decoder's cross-attention, which is never causal: causal with
Sk != S is refused, here and in the plain version.  The kernel is in
``csrc/flash_attention.cu``: bfloat16 through warpgroup MMA (wgmma) on
tiles that TMA loads into shared memory, float32 as split TF32 on
``mma.sync`` tensor cores.  Operands
are read through their strides (:func:`kernel_strides` says which views it
takes), so the LM's ``(B, S, H, D)`` projections go in as transposed views
with no copy, and the output is the ``(B, Hq, S, D)`` view of a ``(B, S,
Hq, D)`` buffer, so the LM's ``transpose(1, 2).reshape`` after it is free.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention`.  The
two sum in different orders, so they agree to a tolerance (f32 2e-5, bf16
6e-2), not bitwise; two launches on the same inputs give the same bits.

Gradients: the launch is one :class:`~repro_torch.kernels.vjp.PlainVJP`
node, whose backward is the VJP of the plain version at the saved q, k, v
and the float scale.  That backward materialises the ``(B, Hq, S, S)``
scores, as the plain version does; the JAX package has no backward kernel
either.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, ref
from .vjp import PlainVJP

#: Kernel launches made by this module's wrapper (one per launch).
LAUNCHES = {"flash_attention": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 96, 128)
#: A non-unit stride must be a multiple of this many elements, and the base
#: a multiple of ALIGN_BYTES (TMA's 16-byte rows and base).
STRIDE_MULTIPLE = 8
ALIGN_BYTES = 16


def kernel_strides(shapes, strides, dtypes, addresses, causal: bool = True) -> tuple:
    """The kernel's view of q, k, v, or a named error: the shapes, strides
    (in elements), dtypes and data addresses of q, k, v, in that order ->
    ``((sB, sH, sS) of q, of k, of v)``.  k and v may have their own length
    Sk unless ``causal``.

    The kernel takes any 4-D view whose last stride is 1, whose other
    strides are positive multiples of 8 elements (16 bytes of bf16: a TMA
    row) and whose base is 16-byte aligned, so the LM's ``(B, S, H, D)``
    projections go in as their ``(B, H, S, D)`` transposed views.  A
    size-1 axis is never stepped over; its stride is returned as a
    contiguous tensor's would be."""
    dtype = dtypes[0]
    if dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: float32 or bfloat16, got {dtype}")
    if any(d != dtype for d in dtypes):
        raise ValueError(f"flash_attention: q, k, v must share one dtype, got mixed dtypes "
                         f"{tuple(dtypes)}")
    shapes = [tuple(sh) for sh in shapes]
    if len(shapes[0]) != 4 or len(shapes[1]) != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D (B, H, S, D), got "
                         f"{shapes[0]} and {shapes[1]}")
    B, Hq, S, D = shapes[0]
    Hkv, Sk = shapes[1][1], shapes[1][2]
    if shapes[1] != (B, Hkv, Sk, D) or shapes[2] != shapes[1] or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: want q (B, Hq, S, D) and k, v (B, Hkv, Sk, D) "
                         f"with Hq % Hkv == 0, got q {shapes[0]}, k {shapes[1]}, v {shapes[2]}")
    ref.check_causal_keys(S, Sk, causal)
    if S and not Sk:
        raise ValueError(f"flash_attention: {S} query rows against no keys")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be one of {HEAD_DIMS}, got {D}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention: batch {B} or heads {Hq} exceed the grid's 65535")
    out = []
    for name, (_, H, S, _), stride, address in zip("qkv", shapes, strides, addresses):
        if stride[-1] != 1:
            raise ValueError(f"flash_attention: {name}'s last stride must be 1, got strides "
                             f"{tuple(stride)}")
        if address % ALIGN_BYTES:
            raise ValueError(f"flash_attention: {name}'s base address {address:#x} is not "
                             f"{ALIGN_BYTES}-byte aligned")
        contiguous = (H * max(S, 1) * D, max(S, 1) * D, D)
        st = tuple(c if n == 1 else int(s)
                   for n, s, c in zip((B, H, S), stride[:3], contiguous))
        if any(s <= 0 or s % STRIDE_MULTIPLE for s in st):
            raise ValueError(f"flash_attention: {name}'s batch, head and row strides must be "
                             f"positive multiples of {STRIDE_MULTIPLE} elements, got strides "
                             f"{tuple(stride)}")
        out.append(st)
    return tuple(out)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> tuple:
    """Raise unless q, k, v are what the kernel takes (the device last, so
    layouts are checked on any device); -> :func:`kernel_strides`."""
    strides = kernel_strides([t.shape for t in (q, k, v)], [t.stride() for t in (q, k, v)],
                             [t.dtype for t in (q, k, v)], [t.data_ptr() for t in (q, k, v)],
                             causal)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: q, k, v must share one device, got "
                             f"{t.device} against {q.device}")
    if not q.is_cuda:
        raise ValueError(f"flash_attention: operands must be CUDA tensors, got {q.device}")
    return strides


def _launch(q, k, v, causal: bool, scale: float, out: Optional[torch.Tensor] = None):
    """One launch -> o, by default a ``(B, S, Hq, D)`` buffer's ``(B, Hq, S,
    D)`` view; ``out``, of q's shape and any layout the kernel takes for q,
    is written in its place."""
    strides = check_operands(q, k, v, causal)
    B, Hq, S, D = q.shape
    if out is None:
        out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        check_operands(out, k, v, causal)
        if out.shape != q.shape:
            raise ValueError(f"flash_attention: out must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(out.shape)}")
    if out.numel() == 0:
        return out
    args = (ctypes.c_int64 * 12)(*(s for st in (*strides, out.stride()[:3]) for s in st))
    lib = build.load()
    with build.device_guard(q.device):
        err = lib.rt_flash_attention(
            DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, k.shape[1], S, k.shape[2], int(bool(causal)), float(scale),
            args,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """GQA attention in one launch -> ``(B, Hq, S, D)`` in q's dtype (a
    transposed view of a ``(B, S, Hq, D)`` buffer), differentiable through
    the plain version.

    ``scale`` defaults to the float ``1/sqrt(D)``, as the Pallas kernel's
    wrapper has it (the plain version rounds it to the dtype first)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return PlainVJP.apply(_launch, ref.flash_attention,
                          {"causal": bool(causal), "scale": float(scale)}, q, k, v)
