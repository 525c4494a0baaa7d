"""Launcher of the reversible-Heun phase-2 CUDA kernel (port of
:mod:`repro.kernels.reversible_heun_step`).

``rev_heun_phase2`` replaces the Pallas kernel of the same name
(src/repro/kernels/reversible_heun_step.py:161): one elementwise pass
``z₁ = z + (sign·½Δt)(μ+μ′) + (sign·½)(σ+σ′)ΔW`` over the state, with
``dt`` and ``sign`` as scalar kernel arguments so one compiled kernel
serves every step size and both directions.  The kernel is in
``csrc/rev_heun.cu``; the plain version is :func:`repro_torch.kernels.ref.
rev_heun_phase2`.

The other three kernels of the reference module (``rev_heun_phase1`` and
the backward pair) belong to the training slice (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import torch

from . import build

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"rev_heun_phase2": 0}

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def check_operands(name: str, ref: torch.Tensor, others) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of ``ref``'s
    shape, dtype and device, in a dtype the kernels take."""
    if ref.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {ref.dtype}")
    if not ref.is_cuda:
        raise ValueError(f"{name}: operands must be CUDA tensors, got {ref.device}")
    shape, dtype, device = ref.shape, ref.dtype, ref.device
    for t in (ref, *others):
        if t.shape != shape or t.dtype != dtype or t.device != device:
            kind = "CUDA tensors" if t.is_cuda else f"CUDA tensors, got {t.device}"
            raise ValueError(
                f"{name}: operands must be {kind} matching {tuple(shape)} {dtype} "
                f"{device}; got {tuple(t.shape)} {t.dtype} {t.device} (does not match)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def scalar(x) -> float:
    """A step-size or sign operand as the double the C interface takes."""
    return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


def rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign: float = 1.0):
    """z_{n+1} = z + sign·(½(μ+μ′)Δt + ½(σ+σ′)ΔW) — one launch."""
    check_operands("rev_heun_phase2", z, (mu, mu1, sigma, sigma1, dw))
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    lib = build.load()
    with build.device_guard(z.device):
        err = lib.rt_rev_heun_phase2(
            DTYPE_CODES[z.dtype], z.data_ptr(), mu.data_ptr(), mu1.data_ptr(),
            sigma.data_ptr(), sigma1.data_ptr(), dw.data_ptr(), scalar(dt),
            scalar(sign), out.data_ptr(), z.numel(),
            torch.cuda.current_stream(z.device).cuda_stream)
    build.check("rev_heun_phase2", err)
    LAUNCHES["rev_heun_phase2"] += 1
    return out
