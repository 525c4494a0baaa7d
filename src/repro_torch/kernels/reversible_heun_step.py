"""Launchers of the reversible-Heun CUDA kernels (port of
:mod:`repro.kernels.reversible_heun_step`), one per Pallas kernel there:

* :func:`rev_heun_phase1` (reference :152): ``ẑ₁ = 2z − ẑ + sign·(μΔt +
  σΔW)`` — the forward ẑ₁ recompute (+1) and Algorithm 2's reconstruction
  (−1).
* :func:`rev_heun_phase2` (:161): ``z₁ = z + sign·(½(μ+μ′)Δt + ½(σ+σ′)ΔW)``.
* :func:`rev_heun_bwd_phase1` (:170) and :func:`rev_heun_bwd_phase2` (:180):
  the hand-derived transpose of one step around its single field VJP.

Each is one elementwise pass over the state with ``dt`` and ``sign`` as
scalar kernel arguments, so one compiled kernel serves every step size and
both directions.  The kernels are in ``csrc/rev_heun.cu``; the plain
versions in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from . import build

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"rev_heun_phase1": 0, "rev_heun_phase2": 0, "rev_heun_bwd_phase1": 0,
            "rev_heun_bwd_phase2": 0}

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


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device (without the
    ``torch.cuda.Stream`` object that ``current_stream`` builds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign: float = 1.0):
    """ẑ₁ = 2z − ẑ + μ(sign·Δt) + (sign·σ)ΔW — one launch."""
    check_operands("rev_heun_phase1", z, (zh, mu, sigma, dw))
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    lib = build.load()
    with build.device_guard(z.device):
        err = lib.rt_rev_heun_phase1(
            DTYPE_CODES[z.dtype], z.data_ptr(), zh.data_ptr(), mu.data_ptr(),
            sigma.data_ptr(), dw.data_ptr(), scalar(dt), scalar(sign), out.data_ptr(),
            z.numel(), _stream(z))
    build.check("rev_heun_phase1", err)
    LAUNCHES["rev_heun_phase1"] += 1
    return out


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
            scalar(sign), out.data_ptr(), z.numel(), _stream(z))
    build.check("rev_heun_phase2", err)
    LAUNCHES["rev_heun_phase2"] += 1
    return out


def rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt):
    """``(c_mu1, c_sig1)`` field-VJP seeds — one launch, two outputs."""
    check_operands("rev_heun_bwd_phase1", g_z1, (g_mu1, g_sig1, dw))
    c_mu1, c_sig1 = torch.empty_like(g_z1), torch.empty_like(g_z1)
    if g_z1.numel() == 0:
        return c_mu1, c_sig1
    lib = build.load()
    with build.device_guard(g_z1.device):
        err = lib.rt_rev_heun_bwd_phase1(
            DTYPE_CODES[g_z1.dtype], g_z1.data_ptr(), g_mu1.data_ptr(), g_sig1.data_ptr(),
            dw.data_ptr(), scalar(dt), c_mu1.data_ptr(), c_sig1.data_ptr(),
            g_z1.numel(), _stream(g_z1))
    build.check("rev_heun_bwd_phase1", err)
    LAUNCHES["rev_heun_bwd_phase1"] += 1
    return c_mu1, c_sig1


def rev_heun_bwd_phase2(g_z1, ghat, dw, dt):
    """``(d_z, d_zh, d_mu, d_sigma)`` step-``n`` cotangents — one launch."""
    check_operands("rev_heun_bwd_phase2", g_z1, (ghat, dw))
    outs = tuple(torch.empty_like(g_z1) for _ in range(4))
    if g_z1.numel() == 0:
        return outs
    lib = build.load()
    with build.device_guard(g_z1.device):
        err = lib.rt_rev_heun_bwd_phase2(
            DTYPE_CODES[g_z1.dtype], g_z1.data_ptr(), ghat.data_ptr(), dw.data_ptr(),
            scalar(dt), *(o.data_ptr() for o in outs), g_z1.numel(), _stream(g_z1))
    build.check("rev_heun_bwd_phase2", err)
    LAUNCHES["rev_heun_bwd_phase2"] += 1
    return outs
