"""The SDE-GAN (generator, Lipschitz CDE discriminator, the joint solve and
the Wasserstein losses) and the Latent SDE (the ELBO for training, the
prior decode for serving) — port of :mod:`repro.core.sde`:
``NeuralSDEConfig``, ``generator_init``, ``gen_drift``, ``gen_diffusion``,
``generator_sample``, ``generator_sample_paths``,
``generator_sample_terminal``, ``_disc_spec``, ``discriminator_init``,
``disc_f``, ``disc_g``, ``discriminate_path``, ``joint_drift``,
``joint_diffusion``, ``gan_score_fake``, ``gan_losses``,
``gradient_penalty``, ``LatentSDEConfig``, ``_cfg_solve``,
``latent_sde_init``, ``validate_latent_grid``, ``_lsde_sigma``,
``_latent_encode``, ``_step_index_lookup``, ``_latent_posterior_fields``,
``latent_sde_loss``, ``latent_sde_loss_terminal``, ``latent_prior_drift``,
``latent_prior_diffusion``, ``latent_sde_sample_paths``; and for streamed
serving ``generator_initial_state`` and ``generator_rollout_chunk``, and
``latent_sde_posterior_decode``.

The generator (paper eq. (1)): ``X_0 = ζ(V)``, ``dX = μ(t, X) dt + σ(t,
X) ∘ dW`` with general (matrix) noise, ``Y = ℓ(X)``.  Trained as an
SDE-GAN (paper §5) against the Neural CDE discriminator of eq. (2):
generator and discriminator are solved as one joint SDE, so the fake
score is a function of one terminal state and the exact adjoint runs end
to end; the real path drives the CDE alone.  Served two ways: the
fixed-grid trajectory and the adaptive terminal sample, solved to a
requested tolerance with one step-size controller per row.

Latent SDE training (paper eq. (4), Appendix B): a backward GRU encodes the
observed path into a context path, the posterior SDE runs over the
augmented state ``[x, kl]`` — the KL path integrand rides as a state
channel — and the exact adjoint differentiates the whole trajectory.
Keys are ``(2,)`` int64 tensors; every draw is the reference's
``jax.random`` draw on the port's Threefry.

Serving contract, as in the reference: **every trajectory row is a pure
function of ``(params, keys[i])``**, so padding a request batch up to a
bucket never changes a client's rows.  The reference gets this from
``jax.vmap`` over keys; here the batch is a tensor dimension, the PRNG and
the Brownian kernels are per-row by construction, and :func:`repro_torch.
nn.linear` keeps the matmuls row-invariant.  The training paths draw one
key per tensor, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .. import nn
from ..kernels import prng
from ..data.synthetic import _linspace
from .brownian import BrownianPath
from .losses import wasserstein_losses
from .paths import LinearPathControl
from .solve import get_solver, solve, solve_adaptive
from .solvers import NP_DTYPES, ProductTime32, ProductTime64, apply_diffusion


@dataclasses.dataclass(frozen=True)
class NeuralSDEConfig:
    """The SDE-GAN's config, field for field the reference's (the
    discriminator's fields ride along so bundles read both ways)."""

    data_dim: int = 1
    hidden_dim: int = 16
    noise_dim: int = 4
    initial_noise_dim: int = 4
    width: int = 32
    depth: int = 1
    disc_hidden_dim: int = 16
    disc_width: int = 32
    disc_depth: int = 1
    num_steps: int = 32
    t1: float = 1.0
    solver: str = "reversible_heun"
    exact_adjoint: bool = True
    gradient_mode: Optional[str] = None
    precision: str = "highest"
    use_pallas_kernels: bool = False
    dtype: torch.dtype = torch.float32


def generator_init(generator: torch.Generator, cfg: NeuralSDEConfig, device=None):
    """Fresh generator parameters in the reference's tree: ζ (initial map),
    μ (drift), σ (diffusion, ``hidden × noise`` outputs), ℓ (readout)."""
    hid = [cfg.width] * cfg.depth
    kw = dict(dtype=cfg.dtype, device=device)
    h = cfg.hidden_dim
    return {
        "zeta": nn.mlp_init(generator, [cfg.initial_noise_dim] + hid + [h], **kw),
        "mu": nn.mlp_init(generator, [1 + h] + hid + [h], **kw),
        "sigma": nn.mlp_init(generator, [1 + h] + hid + [h * cfg.noise_dim], **kw),
        "ell": nn.linear_init(generator, h, cfg.data_dim, **kw),
    }


def gen_drift(cfg: NeuralSDEConfig):
    def mu(params, t, x):
        return nn.mlp(params["mu"], nn.tcat(t, x), nn.lipswish, torch.tanh)
    return mu


def gen_diffusion(cfg: NeuralSDEConfig):
    def sigma(params, t, x):
        out = nn.mlp(params["sigma"], nn.tcat(t, x), nn.lipswish, torch.tanh)
        return out.reshape(x.shape[:-1] + (cfg.hidden_dim, cfg.noise_dim))
    return sigma


def _generator_start(params, cfg: NeuralSDEConfig, keys: torch.Tensor):
    """Per row, as the reference: ``kv, kw = split(key)``, ``x0 =
    ζ(normal(kv, (initial_noise,)))``, and ``kw``'s Brownian path over the
    noise channels -> ``(x0, bm)``."""
    kw = prng.split(keys)[:, 1]
    return (generator_initial_state(params, cfg, keys),
            BrownianPath(kw.contiguous(), 0.0, cfg.t1, (cfg.noise_dim,), cfg.dtype))


def generator_initial_state(params, cfg: NeuralSDEConfig, keys: torch.Tensor):
    """``x₀ = ζ(V)`` per key, ``V = normal(split(key)[0])`` — the entry state
    of the streamed (time-chunked) rollout: ``(B, 2)`` keys -> ``(B,
    hidden_dim)``."""
    kv = prng.split(keys)[:, 0]
    v = prng.normal(kv[:, 0], kv[:, 1], cfg.initial_noise_dim, cfg.dtype)
    return nn.mlp(params["zeta"], v, nn.lipswish)


def generator_rollout_chunk(params, cfg: NeuralSDEConfig, keys: torch.Tensor, x0, t_start,
                            span: float, num_steps: int):
    """Continue generator trajectories over one time chunk ``[t_start,
    t_start + span]`` of a streamed horizon -> ``(ys, xT)``: ``ys``
    ``(num_steps+1, B, data_dim)`` with row 0 the chunk's entry state (the
    previous chunk's last row), ``xT`` ``(B, hidden_dim)`` to carry on.

    ``t_start`` is a scalar (a float or a 0-d tensor: every row at the same
    chunk, the stream loop) or a ``(B,)`` tensor, one horizon position per
    row (the continuous-batching scheduler, whose rows joined at different
    chunk boundaries).  Each row runs the reference's traced-time grid
    (:class:`~repro_torch.core.solvers.RowGrid`) on a Brownian path over
    ``[0, span]`` keyed by its own (pre-folded, per chunk) key, so a row is a
    pure function of ``(params, keys[i], x0[i], t_start[i])``.  Solved
    ``discretise`` and unfused, as the reference does (general noise, no
    gradient).  Nothing is read back to the host, so the step can be
    captured in a CUDA graph."""
    B = keys.shape[0]
    if isinstance(t_start, torch.Tensor):
        if t_start.ndim > 1:
            raise ValueError(f"t_start must be a scalar or a (B,) per-row vector, got "
                             f"shape {tuple(t_start.shape)}")
        t0 = t_start.to(device=x0.device, dtype=cfg.dtype).expand(B)
    else:
        t0 = torch.full((B,), float(t_start), dtype=cfg.dtype, device=x0.device)
    np_dtype = NP_DTYPES[cfg.dtype]
    if cfg.dtype == torch.float32:  # t0 + span in float32, one rounding
        t1 = (t0.double() + float(np_dtype(span))).float()
    else:
        t1 = t0 + float(span)
    bm = BrownianPath(keys.contiguous(), 0.0, span, (cfg.noise_dim,), cfg.dtype)
    traj = solve(gen_drift(cfg), gen_diffusion(cfg), params, x0, bm, t0, t1, num_steps,
                 solver=cfg.solver, gradient_mode="discretise", noise="general")
    return nn.linear(params["ell"], traj), traj[-1]


def generator_sample_paths(params, cfg: NeuralSDEConfig, keys: torch.Tensor):
    """SDE-GAN generator rollout for serving, one trajectory per key:
    ``(B, 2)`` keys -> ``(num_steps+1, B, data_dim)``, each row a pure
    function of ``(params, keys[i])``."""
    x0, bm = _generator_start(params, cfg, keys)
    traj = _cfg_solve(cfg, gen_drift(cfg), gen_diffusion(cfg), params, x0, bm,
                      cfg.num_steps, "general")
    return nn.linear(params["ell"], traj)


def generator_sample_terminal(params, cfg: NeuralSDEConfig, keys: torch.Tensor, rtol,
                              atol, max_steps: Optional[int] = None):
    """Adaptive terminal sampling for serving: one ``Y_T`` per key, solved
    to the requested tolerance (DESIGN.md §10) with one PI controller per
    row -> ``(samples (B, data_dim), converged (B,), stats)``.

    ``rtol``/``atol`` are scalars (floats or tensors).  Each row is a pure
    function of ``(params, keys[i], rtol, atol)``, padding rows included: a
    row's controller never sees another row.  A row with ``converged[i] ==
    False`` ran out of budget and holds the state at ``t_final < t1``.
    ``stats`` is the solve's :class:`~repro_torch.core.solve.AdaptiveStats`
    (the reference returns the first two only)."""
    if max_steps is None:
        max_steps = max(4 * cfg.num_steps, 256)
    x0, bm = _generator_start(params, cfg, keys)
    xT, stats = solve_adaptive(gen_drift(cfg), gen_diffusion(cfg), params, x0, bm, 0.0,
                               cfg.t1, solver=cfg.solver, rtol=rtol, atol=atol,
                               max_steps=max_steps, dt0=cfg.t1 / cfg.num_steps,
                               noise="general")
    return nn.linear(params["ell"], xT), stats.converged, stats


def generator_sample(params, cfg: NeuralSDEConfig, key: torch.Tensor, batch: int):
    """Sample ``Y`` paths from one ``(2,)`` key, as the training loop's
    metric does: ``kv, kw = split(key)``, ``(batch, initial_noise)``
    normals from ``kv`` and one Brownian path of shape ``(batch, noise)``
    from ``kw`` -> ``(num_steps+1, batch, data_dim)``."""
    kv, kw = prng.split(key)
    v = _normal(kv, (batch, cfg.initial_noise_dim), cfg.dtype)
    x0 = nn.mlp(params["zeta"], v, nn.lipswish)
    bm = BrownianPath(kw, 0.0, cfg.t1, (batch, cfg.noise_dim), cfg.dtype)
    traj = _cfg_solve(cfg, gen_drift(cfg), gen_diffusion(cfg), params, x0, bm,
                      cfg.num_steps, "general")
    return nn.linear(params["ell"], traj)


# =============================================================================
# Discriminator (Neural CDE, eq. (2))
# =============================================================================


def _disc_spec(cfg: NeuralSDEConfig) -> nn.CDEDiscriminatorSpec:
    return nn.CDEDiscriminatorSpec(data_dim=cfg.data_dim, hidden_dim=cfg.disc_hidden_dim,
                                   width=cfg.disc_width, depth=cfg.disc_depth,
                                   dtype=cfg.dtype)


def discriminator_init(generator: torch.Generator, cfg: NeuralSDEConfig, device=None):
    """Fresh discriminator parameters (:func:`repro_torch.nn.cde_discriminator_init`):
    xi, f and g inside the careful-clipping box, the readout m unconstrained."""
    return nn.cde_discriminator_init(generator, _disc_spec(cfg), device=device)


def disc_f(cfg: NeuralSDEConfig):
    return nn.cde_drift(_disc_spec(cfg))


def disc_g(cfg: NeuralSDEConfig):
    """g_φ maps h -> ``(h, 1+y)``: the CDE is driven by the time-augmented
    path (t, Y_t), so the field sees dt through the control as well."""
    return nn.cde_control_field(_disc_spec(cfg))


def discriminate_path(params, cfg: NeuralSDEConfig, ys: torch.Tensor,
                      exact_adjoint: Optional[bool] = None):
    """Score an observed path ``ys`` (T+1, batch, y): F_φ(Y) = m·H_T, the
    CDE driven by the piecewise-linear time-augmented control (t, Y).

    Gradients into the path: under the exact adjoint only ``ys[0]`` gets
    one, through ``H_0 = ξ(t_0, Y_0)``; none flows through the control
    (the reference returns zero cotangents for it, and the port's adjoint
    does not take the path as an input).  Under ``discretise``
    (``exact_adjoint=False``, the gradient penalty's mode) autograd reaches
    every ``ys[n]`` through the control's increments as well."""
    T = ys.shape[0] - 1
    ts = _linspace(0.0, cfg.t1, T + 1, ys.dtype, ys.device)
    tt = ts[:, None, None].expand(ys.shape[:-1] + (1,))
    control = LinearPathControl(torch.cat([tt, ys], -1))
    h0 = nn.cde_initial(params, ts[0], ys[0])
    exact = cfg.exact_adjoint if exact_adjoint is None else exact_adjoint
    mode = "reversible_adjoint" if exact else "discretise"
    solver = "reversible_heun" if exact else cfg.solver
    traj = solve(disc_f(cfg), disc_g(cfg), params, h0, control, 0.0, cfg.t1, T,
                 solver=solver, gradient_mode=mode, noise="general")
    return nn.cde_readout(params, traj[-1])


# =============================================================================
# Joint generator+discriminator SDE (fake-sample scoring, end to end)
# =============================================================================


def joint_drift(cfg: NeuralSDEConfig):
    """Drift of ``u = [x, h]``: the generator's μ, and the CDE's ``f + g·dY/dt``
    with ``dY/dt = (1, μ·W_ℓ)`` (the time channel and ℓ's linear map)."""
    mu_f, f_f, g_f = gen_drift(cfg), disc_f(cfg), disc_g(cfg)
    hd = cfg.hidden_dim

    def drift(params, t, u):
        x, h = u[..., :hd], u[..., hd:]
        mu = mu_f(params["gen"], t, x)
        f = f_f(params["disc"], t, h)
        g = g_f(params["disc"], t, h)           # (..., h, 1+y)
        wl = params["gen"]["ell"]["w"]          # (x, y)
        dy_dt = torch.cat([mu.new_ones(mu.shape[:-1] + (1,)), mu @ wl], -1)  # (..., 1+y)
        return torch.cat([mu, f + apply_diffusion(g, dy_dt, "general")], -1)

    return drift


def joint_diffusion(cfg: NeuralSDEConfig):
    """Diffusion of ``u = [x, h]``, ``(..., x+h, w)``: the generator's σ, and
    ``g[..., 1:]·(W_ℓᵀ σ)`` into h (``dY = ℓ'(X) dX``); the reference's
    ``einsum("...hy,xy,...xw->...hw")`` contracted over x first."""
    sig_f, g_f = gen_diffusion(cfg), disc_g(cfg)
    hd = cfg.hidden_dim

    def diffusion(params, t, u):
        x, h = u[..., :hd], u[..., hd:]
        sig = sig_f(params["gen"], t, x)        # (..., x, w)
        g = g_f(params["disc"], t, h)           # (..., h, 1+y)
        wl = params["gen"]["ell"]["w"]          # (x, y)
        gh = g[..., 1:] @ (wl.T @ sig)          # (..., h, w)
        return torch.cat([sig, gh], -2)

    return diffusion


def gan_score_fake(params, cfg: NeuralSDEConfig, key: torch.Tensor, batch: int,
                   paths: bool = True, rows=None):
    """F_φ(Y) for generated Y, through one joint SDE solve (the exact
    adjoint end to end) -> ``(score (batch,), ys (num_steps+1, batch, y))``.
    With ``paths=False`` the solve keeps only its terminal state, so the
    forward holds O(1) states in the number of steps, and ``ys`` is None.
    ``rows``: a data-parallel rank's row window ``(r0, r1)`` of the
    ``batch`` rows: the initial noise is drawn whole and the Brownian path
    windowed, and the rank solves and returns its rows."""
    kv, kw = prng.split(key)
    v = _normal(kv, (batch, cfg.initial_noise_dim), cfg.dtype, rows)
    x0 = nn.mlp(params["gen"]["zeta"], v, nn.lipswish)
    y0 = nn.linear(params["gen"]["ell"], x0)
    h0 = nn.cde_initial(params["disc"], 0.0, y0)
    u0 = torch.cat([x0, h0], -1)
    bm = BrownianPath(kw, 0.0, cfg.t1, (batch, cfg.noise_dim), cfg.dtype, rows=rows)
    traj = _cfg_solve(cfg, joint_drift(cfg), joint_diffusion(cfg), params, u0, bm,
                      cfg.num_steps, "general", save_trajectory=paths)
    score = nn.cde_readout(params["disc"], (traj[-1] if paths else traj)[..., cfg.hidden_dim:])
    if not paths:
        return score, None
    return score, nn.linear(params["gen"]["ell"], traj[..., :cfg.hidden_dim])


def gan_losses(params, cfg: NeuralSDEConfig, key: torch.Tensor, y_real: torch.Tensor,
               batch: int, paths: bool = True, rows=None):
    """Wasserstein losses (eq. (3)) -> ``(gen_loss, disc_loss, fake_ys)``,
    ``fake_ys`` None with ``paths=False`` (see :func:`gan_score_fake`, which
    takes ``rows``; ``y_real`` then holds the rank's rows)."""
    fake_score, fake_ys = gan_score_fake(params, cfg, key, batch, paths, rows)
    real_score = discriminate_path(params["disc"], cfg, y_real)
    gen_loss, disc_loss = wasserstein_losses(fake_score, real_score)
    return gen_loss, disc_loss, fake_ys


def gradient_penalty(params_disc, cfg: NeuralSDEConfig, key: torch.Tensor,
                     y_real: torch.Tensor, y_fake: torch.Tensor, batch=None, rows=None):
    """WGAN-GP baseline (Gulrajani et al.): ``E[(‖∂F/∂Y‖ − 1)²]`` at
    ``Y = ε·y_real + (1−ε)·y_fake``, ``ε ~ U(1, B, 1)`` from ``key`` — the
    double backward the paper's clipping removes.  The inner gradient is
    taken through the discretise CDE solve with ``create_graph``, so the
    penalty is differentiable in the discriminator's parameters (and in the
    paths, where they require a gradient).  ``batch`` and ``rows``: the
    whole batch and a data-parallel rank's row window of it, whose rows
    ``y_real`` and ``y_fake`` hold; ε is drawn whole."""
    batch = y_real.shape[1] if batch is None else batch
    eps = _keep_rows(prng.uniform(key[0], key[1], batch, y_real.dtype), rows)
    eps = eps.reshape(1, -1, 1)
    with torch.enable_grad():
        y_mix = eps * y_real + (1 - eps) * y_fake
        if not y_mix.requires_grad:
            y_mix.requires_grad_()
        score = torch.sum(discriminate_path(params_disc, cfg, y_mix, exact_adjoint=False))
        (g,) = torch.autograd.grad(score, y_mix, create_graph=True)
    gnorm = torch.sqrt(torch.sum(g * g, dim=(0, 2)) + 1e-12)
    return torch.mean((gnorm - 1.0) ** 2)


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
    """Every SDE-GAN and Latent-SDE solve goes through the front-end, with
    the gradient mode derived from the config as the reference does (exact reversible
    adjoint when configured, discretise otherwise).  A solver that consumes
    ``(W, H)`` pairs (srk) gets the diagonal-noise path rebuilt in
    space-time mode, as the reference rebuilds it, so ``cfg.solver="srk"``
    works on every diagonal-noise config path; a general-noise solve meets
    the registry's named noise error."""
    solver = cfg.solver if solver is None else solver
    if (get_solver(solver).needs_levy_area and isinstance(bm, BrownianPath)
            and bm.levy_area is None):
        bm = dataclasses.replace(bm, levy_area="space-time")
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


def validate_latent_grid(num_steps: int, T: int) -> int:
    """Check the solver grid aligns with the observation grid; return the
    stride.  The reconstruction term reads the trajectory at the ``T + 1``
    observation times, so ``num_steps`` must be a positive multiple of
    ``T`` (checked eagerly, with the reference's named error)."""
    if T < 1:
        raise ValueError(
            f"latent-SDE data must contain at least two observations; got "
            f"T = {T} observation intervals")
    if num_steps < T or num_steps % T != 0:
        reason = (f"num_steps < T" if num_steps < T
                  else f"num_steps % T == {num_steps % T} != 0")
        raise ValueError(
            f"latent-SDE solver grid is misaligned with the observation "
            f"grid: cfg.num_steps ({num_steps}) must be a positive multiple "
            f"of the data grid T ({T}, the number of observation intervals "
            f"= len(y) - 1) so every observation lands on a solver step "
            f"(valid: {T}, {2 * T}, {3 * T}, ...); got {reason}")
    return num_steps // T


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


def _keep_rows(x, rows):
    return x if rows is None else x[rows[0]:rows[1]]


def _normal(key, shape, dtype, rows=None):
    """One-key normals of ``shape``; with ``rows`` a data-parallel rank's row
    window, drawn whole (as the one-device run draws them) and kept."""
    return _keep_rows(prng.normal_like(key[0], key[1], tuple(shape), dtype), rows)


def _latent_encode(params, cfg: LatentSDEConfig, key, y_true, batch=None, rows=None):
    """Backward-GRU context + initial-latent sample -> ``(ctx, x0, kl_v)``:
    the ``(T+1, B, c)`` context path, ``ζ(V̂)`` with ``V̂ ~ N(m, s)`` from
    ``ξ(ctx_0)``, and the per-sample ``KL(N(m, s) ‖ N(0, 1))``.  ``key``: one
    ``(2,)`` key for the batch (training), or ``(B, 2)``, one per row (the
    posterior decode, as the reference's vmapped rows draw).  ``batch`` and
    ``rows``: the whole batch and the rank's row window under a
    data-parallel mesh (the one-key draw is made whole)."""
    ctx = nn.gru_scan(params["enc"], y_true, reverse=True)
    ms = nn.mlp(params["qz0"], ctx[0], nn.lipswish)
    m, log_s = ms.chunk(2, -1)
    s = torch.exp(torch.clamp(log_s, -8, 4))
    if key.ndim == 2:
        eps = prng.normal(key[:, 0], key[:, 1], m.shape[-1], cfg.dtype)
    else:
        eps = _normal(key, (m.shape[0] if batch is None else batch,) + m.shape[1:],
                      cfg.dtype, rows)
    v = m + s * eps
    kl_v = 0.5 * torch.sum(m ** 2 + s ** 2 - 2.0 * torch.log(s) - 1.0, -1)
    x0 = nn.mlp(params["zeta"], v, nn.lipswish)
    return ctx, x0, kl_v


def _step_index(t, t1: float, T: int, dtype) -> int:
    """``int(t / t1 * T)`` clipped to ``[0, T]``, computed on the host in the
    state dtype as the reference's ``jnp.asarray(t / t1 * T).astype(int32)``
    rounds; one ulp of ``t`` can move it, so the times must be the
    reference's (:func:`repro_torch.core.solvers.grid_time`).  At a time the
    reference forms as the product ``k·dt``
    (:func:`repro_torch.core.solvers.product_time`) with ``t1 = 1`` XLA
    drops the division and folds the constants, ``k·(dt·T)``, and so does
    this."""
    np_dtype = NP_DTYPES[dtype]
    if isinstance(t, (ProductTime32, ProductTime64)) and t1 == 1.0:
        x = np_dtype(t.k) * (np_dtype(t.dt) * np_dtype(T))
    elif isinstance(t, np.floating):
        x = t / np_dtype(t1) * np_dtype(T)
    else:  # a Python float is folded in double, then cast, as a constant
        x = np_dtype(t / t1 * T)
    return min(max(int(x), 0), T)


def _step_index_lookup(t1: float, T: int, dtype):
    """``(path, t) -> path[_step_index(t)]``: index a ``(T+1, ...)`` tensor
    (the encoder context, the observations) by solver time."""

    def at(p, t):
        return p[_step_index(t, t1, T, dtype)]

    return at


def _latent_posterior_fields(cfg: LatentSDEConfig, T: int, n_aux: int,
                             with_recon: bool = False):
    """Posterior drift/diffusion over the augmented state ``[x, kl(, recon)]``.

    The KL path integrand ½‖(μ−ν)/σ‖² rides as a state channel (eq. (4)).
    ``with_recon`` adds a channel integrating the squared reconstruction
    error against the step-indexed observations (the terminal-only form).
    Aux channels carry zero diffusion."""
    ctx_at = _step_index_lookup(cfg.t1, T, cfg.dtype)
    h = cfg.hidden_dim

    def post_drift(p, t, u):
        x = u[..., :h]
        nets = p["nets"]
        c = ctx_at(p["ctx"], t)
        nu = nn.mlp(nets["nu"], torch.cat([nn.tcat(t, x), c], -1), nn.lipswish,
                    torch.tanh)
        mu = nn.mlp(nets["mu"], nn.tcat(t, x), nn.lipswish, torch.tanh)
        sig = _lsde_sigma(nets, t, x)
        u_ratio = (mu - nu) / sig
        dkl = 0.5 * torch.sum(u_ratio * u_ratio, -1, keepdim=True)
        chans = [nu, dkl]
        if with_recon:
            y_hat = nn.linear(nets["ell"], x)
            chans.append(torch.mean((y_hat - ctx_at(p["y"], t)) ** 2, -1, keepdim=True))
        return torch.cat(chans, -1)

    def post_diffusion(p, t, u):
        sig = _lsde_sigma(p["nets"], t, u[..., :h])
        return torch.cat([sig, sig.new_zeros(sig.shape[:-1] + (n_aux,))], -1)

    return post_drift, post_diffusion


def _metrics(recon, kl_path, kl_v):
    return {"recon": recon, "kl_path": torch.mean(kl_path), "kl_v": torch.mean(kl_v)}


def latent_sde_loss(params, cfg: LatentSDEConfig, key, y_true, batch=None, rows=None):
    """Negative ELBO (paper eq. (4) / Appendix B) -> ``(loss, metrics)``.

    ``y_true``: ``(T+1, B, data_dim)`` on the training device; ``key`` a
    ``(2,)`` key there.  The KL path integral rides as a state channel, so
    the objective is a function of one solve's trajectory, which the
    reconstruction term reads at the observation times.  ``batch`` and
    ``rows``: the whole batch and a data-parallel rank's row window of it,
    whose rows ``y_true`` holds; the one-key draws are the whole batch's
    (windowed), and the loss is the rank's: the mean of the ranks' losses
    is the whole batch's."""
    T, B = y_true.shape[0] - 1, y_true.shape[1]
    stride = validate_latent_grid(cfg.num_steps, T)
    dt_data = cfg.t1 / T
    kz0, kw = prng.split(key)
    batch = B if batch is None else batch
    ctx, x0, kl_v = _latent_encode(params, cfg, kz0, y_true, batch, rows)
    post_drift, post_diffusion = _latent_posterior_fields(cfg, T, n_aux=1)
    u0 = torch.cat([x0, x0.new_zeros(B, 1)], -1)
    bm = BrownianPath(kw, 0.0, cfg.t1, (batch, cfg.hidden_dim + 1), cfg.dtype, rows=rows)
    traj = _cfg_solve(cfg, post_drift, post_diffusion, {"nets": params, "ctx": ctx},
                      u0, bm, cfg.num_steps, "diagonal")
    xs = traj[..., :cfg.hidden_dim]
    kl_path = traj[-1][..., -1]
    y_hat_obs = nn.linear(params["ell"], xs)[::stride]
    recon = torch.sum(torch.mean((y_hat_obs - y_true) ** 2, dim=(1, 2))) * dt_data
    recon0 = torch.mean(torch.sum((y_hat_obs[0] - y_true[0]) ** 2, -1))
    loss = recon + recon0 + cfg.kl_weight * torch.mean(kl_path + kl_v)
    return loss, _metrics(recon, kl_path, kl_v)


def latent_sde_loss_terminal(params, cfg: LatentSDEConfig, key, y_true,
                             gradient_mode=None, solver=None, batch=None, rows=None):
    """Negative ELBO as a function of the terminal augmented state only:
    both the KL path integral and the reconstruction error ride as state
    channels (the form a terminal-cotangent adjoint needs), solved with the
    exact adjoint's terminal form by default.  ``batch`` and ``rows`` as
    :func:`latent_sde_loss`'s."""
    T, B = y_true.shape[0] - 1, y_true.shape[1]
    validate_latent_grid(cfg.num_steps, T)
    kz0, kw = prng.split(key)
    batch = B if batch is None else batch
    ctx, x0, kl_v = _latent_encode(params, cfg, kz0, y_true, batch, rows)
    post_drift, post_diffusion = _latent_posterior_fields(cfg, T, n_aux=2, with_recon=True)
    u0 = torch.cat([x0, x0.new_zeros(B, 2)], -1)
    bm = BrownianPath(kw, 0.0, cfg.t1, (batch, cfg.hidden_dim + 2), cfg.dtype, rows=rows)
    uT = _cfg_solve(cfg, post_drift, post_diffusion,
                    {"nets": params, "ctx": ctx, "y": y_true}, u0, bm, cfg.num_steps,
                    "diagonal", gradient_mode=gradient_mode, solver=solver,
                    save_trajectory=False)
    kl_path = uT[..., cfg.hidden_dim]
    recon = torch.mean(uT[..., cfg.hidden_dim + 1])
    recon0 = torch.mean(torch.sum((nn.linear(params["ell"], x0) - y_true[0]) ** 2, -1))
    loss = recon + recon0 + cfg.kl_weight * torch.mean(kl_path + kl_v)
    return loss, _metrics(recon, kl_path, kl_v)


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


def latent_sde_posterior_decode(params, cfg: LatentSDEConfig, keys: torch.Tensor, y_obs):
    """Latent-SDE posterior decode for serving: encode the observed paths,
    solve the posterior SDE (no KL or reconstruction channels) and return
    ŷ on the solver grid, ``(num_steps+1, B, data_dim)``.

    ``keys``: ``(B, 2)``; ``y_obs``: ``(T+1, B, data_dim)``.  Per row, as
    the reference: the encoder's draw from ``fold_in(key, 0)``, the
    Brownian path from ``fold_in(key, 1)``.  Row ``i`` depends only on
    ``(params, keys[i], y_obs[:, i])`` — the bucket-padding contract.  With
    ``cfg.use_pallas_kernels`` the solve runs the fused forward (ΔW drawn in
    the phase-1 kernel)."""
    T = y_obs.shape[0] - 1
    validate_latent_grid(cfg.num_steps, T)
    ctx_at = _step_index_lookup(cfg.t1, T, cfg.dtype)

    def drift(p, t, x):
        c = ctx_at(p["ctx"], t)
        return nn.mlp(p["nets"]["nu"], torch.cat([nn.tcat(t, x), c], -1), nn.lipswish,
                      torch.tanh)

    def diffusion(p, t, x):
        return _lsde_sigma(p["nets"], t, x)

    ctx, x0, _ = _latent_encode(params, cfg, prng.fold_in_key(keys, 0), y_obs)
    bm = BrownianPath(prng.fold_in_key(keys, 1).contiguous(), 0.0, cfg.t1,
                      (cfg.hidden_dim,), cfg.dtype)
    traj = _cfg_solve(cfg, drift, diffusion, {"nets": params, "ctx": ctx}, x0, bm,
                      cfg.num_steps, "diagonal")
    return nn.linear(params["ell"], traj)
