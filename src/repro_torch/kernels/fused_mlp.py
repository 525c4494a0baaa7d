"""Launcher of the SDE field MLP CUDA kernel (port of
:mod:`repro.kernels.fused_mlp`).

:func:`fused_mlp` replaces the Pallas kernel at
src/repro/kernels/fused_mlp.py:43: Linear → LipSwish → Linear in one
launch, x ``(..., Din)``, w1 ``(Din, H)``, b1 ``(H,)``, w2 ``(H, Dout)``,
b2 ``(Dout,)`` in float32, float64 or bfloat16 -> ``(..., Dout)`` in x's
dtype.  The kernel is in ``csrc/fused_mlp.cu``; its plain version is
:func:`repro_torch.kernels.ref.fused_mlp`.  The kernel sums each row in one
fixed order (so a row's bits do not depend on how many rows share the
launch), the plain version in the BLAS's order, so the two agree to a
tolerance (f32 2e-5, bf16 6e-2, f64 1e-12), not bitwise.

Gradients: the launch is one :class:`~repro_torch.kernels.vjp.PlainVJP`
node.  Its forward launches the kernel whatever the grad mode (the exact
adjoint re-evaluates the fields under ``enable_grad`` and needs the
forward's bits); its backward is the VJP of the plain version at the saved
inputs, so second derivatives are the plain version's.  The JAX package has
no backward kernel for this one either.
"""

from __future__ import annotations

import torch

from . import build, ref
from .vjp import PlainVJP

#: Kernel launches made by this module's wrapper (one per launch).
LAUNCHES = {"fused_mlp": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
#: Shared memory a block may use for one row of x and of the hidden
#: activation (``kSmemBytes`` in csrc/fused_mlp.cu): Din + H is bounded by it.
ROW_BYTES = 48 * 1024


def check_operands(x, w1, b1, w2, b2) -> None:
    """Raise unless the operands are what the kernel takes (the device last,
    so shapes and layouts are checked on any device)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_mlp: float32, float64 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"fused_mlp: want x (..., Din), w1 (Din, H), w2 (H, Dout), got "
                         f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    din, hidden = w1.shape
    dout = w2.shape[1]
    if (x.shape[-1] != din or w2.shape[0] != hidden or b1.shape != (hidden,)
            or b2.shape != (dout,) or 0 in (din, hidden, dout)):
        raise ValueError(f"fused_mlp: want x (..., Din), w1 (Din, H), b1 (H,), w2 (H, Dout), "
                         f"b2 (Dout,), got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    acc = 8 if x.dtype == torch.float64 else 4
    if (din + hidden) * acc > ROW_BYTES:
        raise ValueError(f"fused_mlp: Din + H = {din + hidden} exceeds the "
                         f"{ROW_BYTES // acc} a row may take in shared memory")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous (strides {t.stride()})")
    if not x.is_cuda:
        raise ValueError(f"fused_mlp: operands must be CUDA tensors, got {x.device}")


def _launch(x, w1, b1, w2, b2):
    din, dout = w1.shape[0], w2.shape[1]
    out = torch.empty(x.shape[:-1] + (dout,), dtype=x.dtype, device=x.device)
    rows = out.numel() // dout
    if rows == 0:
        return out
    lib = build.load()
    with build.device_guard(x.device):
        err = lib.rt_fused_mlp(
            DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), rows, din, w1.shape[1], dout,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("fused_mlp", err)
    LAUNCHES["fused_mlp"] += 1
    return out


def fused_mlp(x, w1, b1, w2, b2):
    """``lipswish(x @ w1 + b1) @ w2 + b2`` in one launch, differentiable
    through the plain version."""
    check_operands(x, w1, b1, w2, b2)
    return PlainVJP.apply(_launch, ref.fused_mlp, {}, x, w1, b1, w2, b2)
