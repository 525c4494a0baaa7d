"""Step factories (port of :mod:`repro.launch.steps`): the LM training step
(``make_optimizer``, ``make_train_step``), the SDE-GAN training step
(``make_gan_optimizers``, ``make_sde_gan_step``, and ``sde_gan_grads``
under it), the Latent-SDE ELBO training step
(``make_latent_sde_optimizer``, ``make_latent_sde_step``),
the serving samplers: ``make_sample_step`` (the Latent-SDE prior and
posterior decodes and the SDE-GAN generator's rollout),
``make_stream_chunk_step`` (one time chunk of a streamed or continuously
batched rollout) and ``make_adaptive_terminal_step`` (the SDE-GAN's
adaptive terminal samples), and the transformer LM's serving
steps ``make_prefill_step``, ``make_serve_step`` and ``greedy_sample``."""

from __future__ import annotations

from typing import Optional

import torch

from .. import tree
from ..device import resolve_device

SERVE_WORKLOADS = ("sde-gan", "latent-sde")


def make_optimizer(cfg, peak_lr: float = 3e-4, warmup: int = 100, total: int = 10_000,
                   weight_decay: float = 0.1):
    """AdamW on the cosine schedule, moments in ``cfg.adam_dtype`` ("param":
    the parameters' dtype): ``(init, update)``."""
    from .. import optim

    sched = optim.cosine_schedule(peak_lr, warmup, total)
    moment_dtype = None if cfg.adam_dtype == "param" else cfg.adam_dtype
    return optim.adamw(sched, weight_decay=weight_decay, moment_dtype=moment_dtype)


def make_train_step(cfg, opt_update=None, grad_clip: float = 1.0):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: one
    gradient of :func:`repro_torch.models.transformer.lm_loss`, clipped to
    ``grad_clip`` global norm, one optimizer update.  ``metrics`` holds
    ``loss``, ``grad_norm``, ``xent`` and ``moe_aux`` as 0-d tensors on the
    parameters' device (reading one waits for the step).  The step runs on
    the device its parameters and batch live on."""
    from .. import optim
    from ..models import transformer as T

    if opt_update is None:
        _, opt_update = make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, parts = T.lm_loss(tree.unflatten(spec, leaves), cfg, batch)
        grads = tree.unflatten(spec, torch.autograd.grad(loss, leaves))
        del leaves
        with torch.no_grad():
            grads, gnorm = optim.clip_by_global_norm(grads, grad_clip)
            updates, opt_state = opt_update(grads, opt_state, params)
            del grads
            params = optim.apply_updates(params, updates)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   **{k: v.detach() for k, v in parts.items()}}
        return params, opt_state, metrics

    return train_step


def make_sample_step(workload: str, cfg, latent_mode: str = "prior",
                     obs_len: Optional[int] = None, device=None):
    """Build the batched trajectory sampler of one serving bucket:
    ``(params, keys) -> (num_steps+1, len(keys), data_dim)`` — the SDE-GAN
    generator's rollout, or the Latent SDE's prior or posterior decode.

    ``latent_mode="posterior"`` encodes ``obs_len`` observations per row,
    drawn as the reference draws its stand-in observation channel:
    ``air_quality_like(fold_in(key, 2), 1, obs_len)`` per row
    (:func:`repro_torch.data.air_quality_rows`), then solves the posterior.
    Runs on the card unless ``device="cpu"`` (no card: a named error).
    ``keys`` are moved to that device; ``params`` must already live there.
    Every output row is a pure function of ``(params, keys[i])``, so padding
    ``keys`` up to a bucket cannot change the real rows.  Validation is
    eager: an unknown workload or mode, or a misaligned observation grid,
    raises here, at build time.
    """
    from ..core import sde as S

    if workload not in SERVE_WORKLOADS:
        raise ValueError(f"workload must be one of {SERVE_WORKLOADS}, got {workload!r}")
    if workload == "sde-gan":
        dev = resolve_device(device)

        def sample(params, keys):
            return S.generator_sample_paths(params, cfg, keys.to(dev))

        return sample
    if latent_mode not in ("prior", "posterior"):
        raise ValueError(f"latent_mode must be 'prior' or 'posterior', got {latent_mode!r}")
    if latent_mode == "prior":
        dev = resolve_device(device)

        def sample(params, keys):
            return S.latent_sde_sample_paths(params, cfg, keys.to(dev))

        return sample
    if obs_len is None or obs_len < 2:
        raise ValueError(f"latent_mode='posterior' needs obs_len >= 2 observation points "
                         f"per request, got {obs_len!r}")
    S.validate_latent_grid(cfg.num_steps, obs_len - 1)
    dev = resolve_device(device)

    def sample(params, keys):
        from ..data.synthetic import air_quality_rows
        from ..kernels import prng

        keys = keys.to(dev)
        y_obs = air_quality_rows(prng.fold_in_key(keys, 2), obs_len, dtype=cfg.dtype)
        return S.latent_sde_posterior_decode(params, cfg, keys, y_obs)

    return sample


def make_stream_chunk_step(cfg, span: float, num_steps: int, device=None):
    """Build the streamed-rollout chunk step: ``(params, keys, x0, t_start)
    -> (ys_chunk, xT)`` over ``[t_start, t_start + span]`` in ``num_steps``
    steps (:func:`repro_torch.core.sde.generator_rollout_chunk`).

    ``t_start`` is a scalar (the stream loop: every row at one chunk) or a
    ``(B,)`` per-row tensor (the continuous-batching scheduler).  ``keys``
    are pre-folded per chunk by the caller; the loop carries ``xT`` into the
    next chunk.  SDE-GAN generator only.  Runs on the card unless
    ``device="cpu"``."""
    from ..core import sde as S

    dev = resolve_device(device)

    def chunk_step(params, keys, x0, t_start):
        return S.generator_rollout_chunk(params, cfg, keys.to(dev), x0, t_start, span,
                                         num_steps)

    return chunk_step


def make_adaptive_terminal_step(cfg, atol: float = 1e-6, max_steps: int = 4096,
                                device=None):
    """Build the SDE-GAN's adaptive terminal sampler of one serving bucket:
    ``(params, keys, rtol) -> (samples (len(keys), data_dim), converged
    (len(keys),), AdaptiveStats)``.

    ``rtol`` is an argument, so one sampler serves every tolerance a batch
    is routed to.  Each row runs its own PI controller to ``t1`` within
    ``max_steps`` (forward only: no adjoint buffers ride along); a row that
    runs out comes back ``converged=False``.  Runs on the card unless
    ``device="cpu"``.  Validation is eager: a solver without an embedded
    error estimate raises here, at build time."""
    from ..core import sde as S
    from ..core.solve import SOLVERS, get_solver

    if get_solver(cfg.solver).embedded_stepper is None:
        raise ValueError(
            f"--adaptive needs a solver with an embedded error estimate; "
            f"{cfg.solver!r} has none (embedded pairs: "
            f"{sorted(s.name for s in SOLVERS.values() if s.embedded_stepper)})")
    dev = resolve_device(device)

    def sample(params, keys, rtol):
        return S.generator_sample_terminal(params, cfg, keys.to(dev), rtol, atol,
                                           max_steps=max_steps)

    return sample


# -----------------------------------------------------------------------------
# SDE-GAN (paper §5)
# -----------------------------------------------------------------------------

GAN_CONSTRAINTS = ("clip", "gp")


def make_gan_optimizers(lr: float = 1.0, constraint: str = "clip"):
    """Paper Appendix F: Adadelta for both players.  Under ``"clip"`` the
    discriminator's chain ends in the careful-clipping projection (the clip
    applied after the update, as a transform, so swapping the optimiser
    never drops the constraint); ``"gp"`` (the baseline) leaves the
    discriminator unconstrained — the penalty lives in its loss.

    Returns ``((g_init, g_update), (d_init, d_update))``."""
    from .. import optim
    from ..core.clipping import clip_lipschitz

    if constraint not in GAN_CONSTRAINTS:
        raise ValueError(f"constraint must be 'clip' or 'gp', got {constraint!r}")
    gen_opt = optim.adadelta(lr)
    if constraint == "clip":
        disc_opt = optim.chain(optim.adadelta(lr), optim.lipschitz_projection(clip_lipschitz))
    else:
        disc_opt = optim.adadelta(lr)
    return gen_opt, disc_opt


def _dp_mean(*trees):
    """The mean over the data-parallel ranks of every leaf of ``trees`` (the
    gradients and the logged metrics), through one flat all-reduce per
    dtype; the trees themselves without a mesh.  With equal shards the mean
    of the ranks' batch means is the whole batch's mean."""
    from ..distributed.sharding import allreduce_mean

    leaves, spec = tree.flatten(list(trees))
    return tuple(tree.unflatten(spec, allreduce_mean(leaves)))


def _grad_leaves(params):
    """``(leaves that require a gradient, spec, the tree over them)``."""
    leaves, spec = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    return leaves, spec, tree.unflatten(spec, leaves)


def sde_gan_grads(params, cfg, key, y_real, batch: int, rows=None):
    """Both players' losses and gradients from one forward (the generator
    solve inside the joint solve, and the real path's CDE solve) ->
    ``(gen_loss, disc_loss, gen_grads, disc_grads)``, the losses detached.

    The reference pulls two cotangents through one ``jax.vjp``, each a
    reversible backward sweep of the joint solve.  Here one
    ``torch.autograd.grad`` of ``disc_loss`` over both players' leaves gives
    both, the generator's part negated: ``gen_loss = −E[fake]``,
    ``disc_loss = E[fake] − E[real]`` and the real path does not depend on
    the generator, so every cotangent into the generator is exactly the
    negated one (rounding to nearest is symmetric, and the sums run in
    fixed orders).  The joint solve keeps only its terminal state.
    ``rows``: a data-parallel rank's row window of ``batch``, whose rows
    ``y_real`` holds (see :func:`repro_torch.core.sde.gan_score_fake`)."""
    from ..core.sde import gan_losses

    gen_leaves, gspec, gen = _grad_leaves(params["gen"])
    disc_leaves, dspec, disc = _grad_leaves(params["disc"])
    gl, dl, _ = gan_losses({"gen": gen, "disc": disc}, cfg, key, y_real, batch, paths=False,
                           rows=rows)
    grads = torch.autograd.grad(dl, gen_leaves + disc_leaves)
    gg = [-g for g in grads[:len(gen_leaves)]]
    return (gl.detach(), dl.detach(), tree.unflatten(gspec, gg),
            tree.unflatten(dspec, list(grads[len(gen_leaves):])))


def make_sde_gan_step(cfg, g_update, d_update, batch: int, seq_len: int,
                      constraint: str = "clip", gp_weight: float = 10.0, device=None):
    """Build the WGAN step ``(params, g_state, d_state, key) -> (params,
    g_state, d_state, metrics)``; ``params = {"gen": ..., "disc": ...}``.

    The real batch is ``ou_process(fold_in(key, 0), batch, seq_len)``, the
    fake one is keyed by ``fold_in(key, 1)``.  ``constraint="clip"`` (the
    paper's recipe) runs the three solves once and takes both players'
    gradients from one backward sweep (:func:`sde_gan_grads`); the Lipschitz
    constraint is the projection at the end of ``d_update``, no second
    backward anywhere.  ``constraint="gp"`` is the WGAN-GP baseline: the
    discriminator's loss adds ``gp_weight`` × the gradient penalty (a
    gradient of a gradient through the discretise CDE solve, keyed by
    ``fold_in(key, 3)``), then the generator's loss is solved again against
    the pre-update discriminator.  ``metrics`` holds ``gen_loss``,
    ``disc_loss`` and ``wasserstein`` (= −disc_loss, before the update) as
    0-d tensors.

    Runs on the card unless ``device="cpu"``; ``params`` and the states must
    live on that device, ``key`` is moved there.  Validation is eager: an
    unknown constraint, and ``"gp"`` with ``seq_len != num_steps + 1`` (the
    interpolates need the real and fake paths on one grid), raise here.
    Under a data-parallel mesh (:mod:`repro_torch.distributed.sharding`)
    every rank makes the real batch whole and keeps its rows
    (``shard_time_major``, the reference's batch-sharding constraint), the
    fake batch's draws are the whole batch's, windowed to the rank's rows
    (``row_window``, passed to the losses), and the gradients and metrics
    are the ranks' mean (one flat all-reduce), so every rank applies the
    same update; on one device it is the identity."""
    from .. import optim
    from ..core.sde import gan_losses, gan_score_fake, gradient_penalty
    from ..data.synthetic import ou_process
    from ..distributed.sharding import row_window, shard_time_major
    from ..kernels import prng

    if constraint not in GAN_CONSTRAINTS:
        raise ValueError(f"constraint must be 'clip' or 'gp', got {constraint!r}")
    if constraint == "gp" and seq_len != cfg.num_steps + 1:
        raise ValueError(
            f"gp constraint requires seq_len == num_steps + 1 so real and "
            f"fake paths share a grid; got seq_len={seq_len}, "
            f"num_steps={cfg.num_steps}")
    dev = resolve_device(device)

    def update(params, g_state, d_state, gg, dg):
        with torch.no_grad():
            upd, d_state = d_update(dg, d_state, params["disc"])
            disc = optim.apply_updates(params["disc"], upd)  # projection folded in
            upd, g_state = g_update(gg, g_state, params["gen"])
            gen = optim.apply_updates(params["gen"], upd)
        return {"gen": gen, "disc": disc}, g_state, d_state

    def real_batch(key):
        return shard_time_major(ou_process(prng.fold_in_key(key, 0), batch, seq_len,
                                           dtype=cfg.dtype))

    def clip_step(params, g_state, d_state, key):
        key = key.to(dev)
        y_real = real_batch(key)
        gl, dl, gg, dg = _dp_mean(*sde_gan_grads(params, cfg, prng.fold_in_key(key, 1),
                                                 y_real, batch, row_window(batch)))
        params, g_state, d_state = update(params, g_state, d_state, gg, dg)
        return params, g_state, d_state, {"gen_loss": gl, "disc_loss": dl, "wasserstein": -dl}

    def gp_step(params, g_state, d_state, key):
        key = key.to(dev)
        y_real, rows = real_batch(key), row_window(batch)
        disc_leaves, dspec, disc = _grad_leaves(params["disc"])
        _, dl, fake = gan_losses({"gen": params["gen"], "disc": disc}, cfg,
                                 prng.fold_in_key(key, 1), y_real, batch, rows=rows)
        # the fake paths the loss already solved for are constants w.r.t. φ
        loss = dl + gp_weight * gradient_penalty(disc, cfg, prng.fold_in_key(key, 3),
                                                 y_real, fake.detach(), batch, rows)
        dg = tree.unflatten(dspec, list(torch.autograd.grad(loss, disc_leaves)))
        del disc_leaves, disc, loss, fake
        # The generator's loss needs only the fake score: the reference's
        # compiled step drops the real path's solve from it as dead code.
        gen_leaves, gspec, gen = _grad_leaves(params["gen"])
        score, _ = gan_score_fake({"gen": gen, "disc": params["disc"]}, cfg,
                                  prng.fold_in_key(key, 1), batch, paths=False, rows=rows)
        gl = -torch.mean(score)
        gg = tree.unflatten(gspec, list(torch.autograd.grad(gl, gen_leaves)))
        gl, dl, gg, dg = _dp_mean(gl.detach(), dl.detach(), gg, dg)
        params, g_state, d_state = update(params, g_state, d_state, gg, dg)
        return params, g_state, d_state, {"gen_loss": gl, "disc_loss": dl,
                                          "wasserstein": -dl}

    return clip_step if constraint == "clip" else gp_step


def make_latent_sde_optimizer(lr: float = 1e-2):
    """Adam, per the paper's Latent-SDE recipe (Appendix F): ``(init, update)``."""
    from .. import optim

    return optim.adam(lr)


def make_latent_sde_step(cfg, opt_update, batch: int, seq_len: int,
                         adjoint: str = "exact", device=None):
    """Build the ELBO step ``(params, opt_state, key) -> (params, opt_state,
    metrics)``.

    One forward per step — the air-quality batch drawn from ``fold_in(key,
    0)``, the encoder GRU and the posterior solve keyed by ``fold_in(key,
    1)``, the KL path integral riding as a state channel — and one gradient
    pull through the solver's adjoint:

    * ``adjoint="exact"`` (the paper's recipe): the reversible-Heun exact
      O(1)-memory adjoint over the trajectory-form ELBO.  With
      ``cfg.use_pallas_kernels`` the posterior solve's forward, its backward
      reconstruction and the cotangent phases run in the CUDA kernels.
    * ``adjoint="backsolve"`` (the Li et al. baseline): the continuous
      adjoint of eq. (6), which takes a terminal cotangent only, so the step
      switches to :func:`repro_torch.core.sde.latent_sde_loss_terminal`
      (the reconstruction integral rides as a second state channel).  Its
      gradients carry the O(√h) error the paper removes.
    * ``adjoint="checkpoint"``: recursive checkpointing over the same
      terminal-form objective — exact gradients at O(log n) memory, for
      every registered solver.

    Runs on the card unless ``device="cpu"``; ``params`` must live on that
    device, ``key`` is moved there.  Validation is eager: a misaligned grid,
    a wrong data width or an illegal solver × adjoint × fusion cell raises a
    named error here, at build time.  Under a data-parallel mesh the batch
    is made whole and the rank keeps its rows (``shard_time_major``), the
    one-key draws are windowed, and the gradients and metrics are the
    ranks' mean, as :func:`make_sde_gan_step`'s.
    """
    from ..core.sde import latent_sde_loss, latent_sde_loss_terminal, validate_latent_grid
    from ..core.solve import get_solver
    from ..data.synthetic import air_quality_like
    from ..distributed.sharding import row_window, shard_time_major
    from ..kernels import prng
    from ..optim import apply_updates

    if adjoint not in ("exact", "backsolve", "checkpoint"):
        raise ValueError(
            f"adjoint must be 'exact', 'backsolve', or 'checkpoint', got {adjoint!r}")
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2 observations, got {seq_len}")
    validate_latent_grid(cfg.num_steps, seq_len - 1)
    if cfg.data_dim != 2:
        raise ValueError(
            f"the latent-SDE workload trains on the bivariate air-quality "
            f"dataset (PM2.5-like, O₃-like); cfg.data_dim must be 2, got "
            f"{cfg.data_dim}")
    if adjoint == "backsolve":
        spec = get_solver(cfg.solver)
        if "continuous_adjoint" not in spec.gradient_modes:
            raise ValueError(
                f"adjoint='backsolve' needs a solver with a continuous-adjoint "
                f"backward integrator; {cfg.solver!r} serves {spec.gradient_modes} — "
                f"use midpoint/heun/euler_maruyama (or adjoint='exact' for "
                f"reversible_heun)")
        if cfg.use_pallas_kernels:
            raise ValueError(
                "use_pallas_kernels requires the exact reversible-Heun adjoint (the "
                "fused kernels have no autograd rule and the backsolve path is "
                "autograd over eq. (6)); drop --pallas or use adjoint='exact'")
    elif adjoint == "checkpoint":
        if cfg.use_pallas_kernels:
            raise ValueError(
                "use_pallas_kernels requires the exact reversible-Heun adjoint "
                "(checkpointing differentiates the recomputed segments by autograd, "
                "which the fused state updates have no rule for); drop --pallas or "
                "use adjoint='exact'")
    elif cfg.use_pallas_kernels and not (cfg.solver == "reversible_heun" and cfg.exact_adjoint):
        raise ValueError(
            f"use_pallas_kernels requires solver='reversible_heun' with "
            f"exact_adjoint=True (got solver={cfg.solver!r}, "
            f"exact_adjoint={cfg.exact_adjoint}) — the fused kernels only "
            f"apply to the exact-adjoint hot loop")
    mode = "continuous_adjoint" if adjoint == "backsolve" else "checkpoint"
    dev = resolve_device(device)

    def step(params, opt_state, key):
        key = key.to(dev)
        ys, _ = air_quality_like(prng.fold_in_key(key, 0), batch, seq_len, dtype=cfg.dtype)
        ys, rows = shard_time_major(ys), row_window(batch)
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        if adjoint == "exact":
            loss, parts = latent_sde_loss(tree.unflatten(spec, leaves), cfg,
                                          prng.fold_in_key(key, 1), ys, batch, rows)
        else:
            loss, parts = latent_sde_loss_terminal(tree.unflatten(spec, leaves), cfg,
                                                   prng.fold_in_key(key, 1), ys,
                                                   gradient_mode=mode, batch=batch, rows=rows)
        grads = tree.unflatten(spec, torch.autograd.grad(loss, leaves))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        grads, metrics = _dp_mean(grads, metrics)
        with torch.no_grad():
            upd, opt_state = opt_update(grads, opt_state, params)
            params = apply_updates(params, upd)
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg, max_len=None):
    """``(params, batch) -> (last-token logits (B, 1, vocab), caches)``, the
    attention caches padded to ``max_len`` slots (a Mamba2 cache has no
    sequence axis, the encoder-decoder's cross cache keeps the source's
    length); ``batch["tokens"]`` is ``(B, S)``, plus ``embeds`` (a VLM's
    prefix) or ``src_embeds`` (the encoder-decoder's source)."""
    from ..models import transformer as T

    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.family == "encdec":
                return T.encdec_prefill(params, cfg, batch["tokens"], batch["src_embeds"],
                                        max_len=max_len)
            return T.lm_prefill(params, cfg, batch["tokens"], embeds=batch.get("embeds"),
                                max_len=max_len)

    return prefill_step


def make_serve_step(cfg):
    """``(params, caches, token, pos) -> (logits, caches)``: one new token
    against the cache (KV rows, or the conv window and SSM state), which is
    updated in place."""
    from ..models import transformer as T

    def serve_step(params, caches, token, pos):
        with torch.no_grad():
            if cfg.family == "encdec":
                return T.encdec_decode(params, cfg, token, caches, pos)
            return T.lm_decode(params, cfg, token, caches, pos)

    return serve_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The argmax of the last position's logits as an int32 ``(B, 1)`` token."""
    return logits[:, -1, :].argmax(-1).to(torch.int32)[:, None]
