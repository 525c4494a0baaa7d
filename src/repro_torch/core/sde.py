"""The Latent SDE's prior decode (port of :mod:`repro.core.sde`:
``LatentSDEConfig``, ``_lsde_sigma``, ``latent_prior_drift``,
``latent_prior_diffusion``, ``latent_sde_init``, ``_cfg_solve``,
``latent_sde_sample_paths``).

Serving contract, as in the reference: **every trajectory row is a pure
function of ``(params, keys[i])``**, so padding a request batch up to a
bucket never changes a client's rows.  The reference gets this from
``jax.vmap`` over keys; here the batch is a tensor dimension, the PRNG and
the Brownian kernels are per-row by construction, and :func:`repro_torch.
nn.linear` keeps the matmuls row-invariant.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from .. import nn
from ..kernels import prng
from .brownian import BrownianPath
from .solve import solve


@dataclasses.dataclass(frozen=True)
class LatentSDEConfig:
    data_dim: int = 1
    hidden_dim: int = 16
    context_dim: int = 16
    initial_noise_dim: int = 8
    width: int = 32
    depth: int = 1
    num_steps: int = 32
    t1: float = 1.0
    solver: str = "reversible_heun"
    exact_adjoint: bool = True
    gradient_mode: Optional[str] = None  # explicit backend; None = derive
    precision: str = "highest"
    kl_weight: float = 1.0
    use_pallas_kernels: bool = False  # fused diagonal-noise hot loop
    dtype: torch.dtype = torch.float32


def _cfg_solve(cfg, drift, diffusion, params, z0, bm, num_steps, noise,
               gradient_mode=None, solver=None, save_trajectory=True):
    """Every Latent-SDE solve goes through the front-end, with the gradient
    mode derived from the config as the reference does (exact reversible
    adjoint when configured, discretise otherwise)."""
    solver = cfg.solver if solver is None else solver
    if gradient_mode is None:
        gradient_mode = cfg.gradient_mode
    if gradient_mode is None:
        exact = cfg.exact_adjoint and solver == "reversible_heun"
        gradient_mode = "reversible_adjoint" if exact else "discretise"
    fuse = (cfg.use_pallas_kernels and noise == "diagonal"
            and gradient_mode == "reversible_adjoint")
    if cfg.use_pallas_kernels and not fuse:
        warnings.warn(
            f"use_pallas_kernels requested but this solve cannot fuse "
            f"(noise={noise!r}, gradient_mode={gradient_mode!r}) — running unfused",
            stacklevel=3)
    return solve(drift, diffusion, params, z0, bm, 0.0, cfg.t1, num_steps,
                 solver=solver, gradient_mode=gradient_mode, noise=noise,
                 save_trajectory=save_trajectory, use_pallas_kernels=fuse,
                 precision=cfg.precision)


def latent_sde_init(generator: torch.Generator, cfg: LatentSDEConfig, device=None):
    """Fresh parameters in the reference's tree: ζ (initial map), μ (prior
    drift), σ (diagonal diffusion), ℓ (readout), and the posterior's
    encoder nets (``enc``, ``nu``, ``qz0``), which the prior decode does not
    use but which keep a port-written bundle readable by the JAX package."""
    hid = [cfg.width] * cfg.depth
    kw = dict(dtype=cfg.dtype, device=device)
    h, c, v = cfg.hidden_dim, cfg.context_dim, cfg.initial_noise_dim
    return {
        "zeta": nn.mlp_init(generator, [v] + hid + [h], **kw),
        "mu": nn.mlp_init(generator, [1 + h] + hid + [h], **kw),
        "sigma": nn.mlp_init(generator, [1 + h] + hid + [h], **kw),
        "ell": nn.linear_init(generator, h, cfg.data_dim, **kw),
        "enc": nn.gru_init(generator, cfg.data_dim, c, **kw),
        "nu": nn.mlp_init(generator, [1 + h + c] + hid + [h], **kw),
        "qz0": nn.mlp_init(generator, [c] + hid + [2 * v], **kw),
    }


def _lsde_sigma(params, t, x):
    raw = nn.mlp(params["sigma"], nn.tcat(t, x), nn.lipswish)
    return nn.sigmoid(raw) * 0.5 + 0.05  # bounded positive diagonal


def latent_prior_drift(p, t, x):
    """Prior drift μ_θ."""
    return nn.mlp(p["mu"], nn.tcat(t, x), nn.lipswish, torch.tanh)


def latent_prior_diffusion(p, t, x):
    """Diagonal prior diffusion (bounded positive)."""
    return _lsde_sigma(p, t, x)


def latent_sde_sample_paths(params, cfg: LatentSDEConfig, keys: torch.Tensor):
    """Latent-SDE prior decode for serving, one trajectory per key.

    ``keys``: ``(B, 2)`` int64 key words on the decode's device.  Per row,
    as the reference: ``kv, kw = split(key)``, ``x0 = ζ(normal(kv))``, then
    solve the prior SDE on ``kw``'s Brownian path.  With
    ``cfg.use_pallas_kernels`` the solve runs the fused forward (ΔW drawn in
    the phase-1 kernel).  Returns ``(num_steps+1, B, data_dim)``.
    """
    kk = prng.split(keys)
    kv, kw = kk[:, 0], kk[:, 1]
    v = prng.normal(kv[:, 0], kv[:, 1], cfg.initial_noise_dim, cfg.dtype)
    x0 = nn.mlp(params["zeta"], v, nn.lipswish)
    bm = BrownianPath(kw.contiguous(), 0.0, cfg.t1, (cfg.hidden_dim,), cfg.dtype)
    traj = _cfg_solve(cfg, latent_prior_drift, latent_prior_diffusion, params, x0,
                      bm, cfg.num_steps, "diagonal")
    return nn.linear(params["ell"], traj)
