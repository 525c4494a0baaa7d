"""Plain PyTorch versions of the ported kernels (port of
:mod:`repro.kernels.ref`).

Each function is the definition the CUDA kernel in ``csrc/rev_heun.cu``
computes, with the same op order, so the two agree bitwise on the card
(chip_smoke.py checks it).  On the CPU, :mod:`repro_torch.kernels.ops`
runs these instead of the kernels; with a card they run only when a caller
asks for them with ``use_kernel=False``.

Scalars (``dt``, ``sign``) may be Python floats or 0-d tensors; a Python
float enters the arithmetic rounded to the tensor's dtype, exactly as the
kernels receive it.
"""

from __future__ import annotations

import torch

from . import prng


def rev_heun_phase1(z, zh, mu, sigma, dw, dt, sign: float = 1.0):
    """ẑ_{n+1} = 2 z_n − ẑ_n + μ_n (sign·Δt) + (sign·σ_n) ΔW_n."""
    return 2.0 * z - zh + mu * (sign * dt) + (sign * sigma) * dw


def rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt, sign: float = 1.0):
    """z_{n+1} = z_n + (sign·½Δt)(μ_n+μ_{n+1}) + (sign·½)(σ_n+σ_{n+1}) ΔW_n."""
    return z + (sign * 0.5 * dt) * (mu + mu1) + (sign * 0.5) * (sigma + sigma1) * dw


def rev_heun_bwd_phase1(g_z1, g_mu1, g_sig1, dw, dt):
    """Seeds of the field VJP: ``c_mu1 = ḡ_mu1 + ½(ḡ_z1·Δt)``,
    ``c_sig1 = ḡ_sig1 + ½(ḡ_z1·ΔW)``.

    The grouping is the transpose's own (power-of-two scalings commute with
    rounding; two-term sums are order-free), so each output is bitwise what
    autograd of the unfused step gives."""
    c_mu1 = g_mu1 + 0.5 * (g_z1 * dt)
    c_sig1 = g_sig1 + 0.5 * (g_z1 * dw)
    return c_mu1, c_sig1


def rev_heun_bwd_phase2(g_z1, ghat, dw, dt):
    """Distribute ``ĝ`` (the total ẑ₁ cotangent) onto the step-``n`` state:
    ``(d_z, d_zh, d_mu, d_sigma)``."""
    d_z = g_z1 + 2.0 * ghat
    d_zh = -ghat
    d_mu = 0.5 * (g_z1 * dt) + ghat * dt
    d_sigma = 0.5 * (g_z1 * dw) + ghat * dw
    return d_z, d_zh, d_mu, d_sigma


def brownian_increment(k1, k2, n, shape, dtype, dt):
    """Step-``n`` increment of a uniform grid with spacing ``dt``:
    ``normal(fold_in(key, n), shape)·sqrt(dt)``.

    ``k1, k2``: key word tensors of any batch shape ``K``; the result has
    shape ``(*K, *shape)``, one independent draw per key.
    """
    f1, f2 = prng.fold_in(k1, k2, n)
    z = prng.normal_like(f1, f2, tuple(shape), dtype)
    return z * torch.sqrt(torch.as_tensor(dt, dtype=dtype, device=z.device))
