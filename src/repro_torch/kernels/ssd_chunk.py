"""Launcher of the Mamba2 SSD chunk-scan CUDA kernel (port of
:mod:`repro.kernels.ssd_chunk`).

:func:`ssd_chunk` replaces the Pallas kernel at
src/repro/kernels/ssd_chunk.py:59: x ``(B, H, S, P)`` in float32 or
bfloat16, a ``(B, H, S)`` float32 log-decays, b and c ``(B, H, S, N)`` in
x's dtype, N in {16, 128}, P in {16, 64}; it returns y ``(B, H, S, P)`` in
x's dtype and the terminal state ``(B, H, N, P)`` in float32.  Operands are
read through their strides (the last axis contiguous), so the mixer's
transposed x and a and its head-broadcast b and c (stride 0) go in as
views; y is allocated with x's strides.  The kernel is in
``csrc/ssd_chunk.cu`` (chunks of CHUNK positions, products on tensor
cores: bf16 MMAs, or split TF32 for float32); its plain version is
:func:`repro_torch.kernels.ref.ssd_chunk`.  The kernel sums in the chunked
matrix form, the plain version position by position, so they agree to a
tolerance (y: f32 2e-4, bf16 6e-2; the state: 2e-4 of its largest
magnitude), not bitwise.  A block owns one (batch, head, slice of P); the
launcher picks the slices (:func:`slices`) so that a small batch still
gives every SM a block, and every slice count gives the same bits.

Gradients: the launch is one :class:`~repro_torch.kernels.vjp.PlainVJP`
node, whose backward is the VJP of the plain recurrence at the saved x, a,
b, c, with cotangents on both outputs (y and the terminal state).  The
strided views go in as they are: the gradients come back in the view
shapes, and autograd's ``expand`` backward sums a head-broadcast b's or
c's over the heads.  The JAX package has no backward kernel; the LM
training slice decides whether one replaces this.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .vjp import PlainVJP

#: Kernel launches made by this module's wrapper (one per launch).
LAUNCHES = {"ssd_chunk": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (16, 128)
HEAD_DIMS = (16, 64)
#: Positions per chunk in the kernel (``kL`` in csrc/ssd_chunk.cu).
CHUNK = 64


def check_operands(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> None:
    """Raise unless x, a, b, c are what the kernel takes (the device last,
    so shapes and layouts are checked on any device)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_chunk: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"ssd_chunk: x and b must be 4-D (B, H, S, P) and (B, H, S, N), "
                         f"got {tuple(x.shape)} and {tuple(b.shape)}")
    B, H, S, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, H, S) or b.shape != (B, H, S, N) or c.shape != b.shape:
        raise ValueError(f"ssd_chunk: want x (B, H, S, P), a (B, H, S), b and c "
                         f"(B, H, S, N), got x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    if N not in STATE_SIZES or P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk: state size N must be one of {STATE_SIZES} and head "
                         f"dim P one of {HEAD_DIMS}, got N = {N}, P = {P}")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: a must be float32, got {a.dtype}")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: {name} on {t.device}, x on {x.device}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_chunk: {name} must share x's dtype {x.dtype}, got "
                             f"{t.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: the last axis of {name} must be contiguous "
                             f"(strides {t.stride()})")
    if not x.is_cuda:
        raise ValueError(f"ssd_chunk: operands must be CUDA tensors, got {x.device}")


def slices(dtype: torch.dtype, N: int, P: int, BH: int) -> int:
    """The P slices the launcher cuts each (batch, head) into for ``BH``
    (batch, head) pairs on the current card: a block owns one (batch, head,
    slice), so the grid is ``BH · slices`` blocks (csrc/ssd_chunk.cu)."""
    return int(build.load().rt_ssd_chunk_slices(DTYPE_CODES[dtype], N, P, BH))


def _launch(x, a, b, c, slices: int = 0):
    """One launch; ``slices`` 0 is the launcher's choice (:func:`slices`),
    else the P slices to cut (a power of two leaving 16 columns or more)."""
    B, H, S, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, h
    strides = (ctypes.c_int64 * 15)(*(s for t in (x, a, b, c, y) for s in t.stride()[:3]))
    lib = build.load()
    with build.device_guard(x.device):
        err = lib.rt_ssd_chunk(
            DTYPE_CODES[x.dtype], N, P, x.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h.data_ptr(), B, H, S, strides, slices,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("ssd_chunk", err)
    LAUNCHES["ssd_chunk"] += 1
    return y, h


def ssd_chunk(x, a, b, c):
    """The SSD scan in one launch -> ``(y (B, H, S, P) in x's dtype,
    h_final (B, H, N, P) float32)``, differentiable through the plain
    version."""
    check_operands(x, a, b, c)
    return PlainVJP.apply(_launch, ref.ssd_chunk, {}, x, a, b, c)
