"""Training CLI (port of :mod:`repro.launch.train`: the ``lm`` workload,
the default, ``sde-gan`` and ``latent-sde``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 50 --ckpt-dir D                   # the smoke config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \\
        --steps 3                                 # MoE (also grok-1-314b, jamba-v0.1-52b)
    PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-medium \\
        --steps 3                                 # also minicpm3-4b, pixtral-12b
    PYTHONPATH=src python -m repro_torch.launch.train --workload sde-gan \\
        --constraint clip --ckpt-dir D && python -m repro_torch.launch.serve \\
        --workload sde-gan --ckpt-dir D
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde --pallas
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde \
        --solver midpoint --adjoint backsolve        # the paper's baseline
    PYTHONPATH=src python -m repro_torch.launch.train --workload sde-gan \
        --constraint gp --solver midpoint            # the WGAN-GP baseline
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde \
        --solver srk [--adjoint checkpoint]          # strong order 1.5

``lm`` trains any of the ten LMs (``--arch``: dense with GQA or MLA, MoE,
SSM, hybrid, the VLM and the encoder-decoder; the reduced smoke config
unless ``--full``) with AdamW on the cosine schedule, the loss through the
``fused_xent`` kernels on the card plus 0.01 times the MoE load-balancing
loss (``moe_aux`` in the metrics).  The loop is the reference's: the batch
of step ``n`` is ``token_batches(fold_in(PRNGKey(seed), 1), n)``, bitwise
the reference's; a VLM trains on ``normal(fold_in(data_key, n + 10000),
(batch, frontend_len, d_model))`` prefix embeddings ahead of the batch's
last ``seq − frontend_len`` tokens, the encoder-decoder on ``(batch, seq,
d_model)`` source embeddings drawn the same way (:func:`lm_batch`);
``--fail-at-step`` raises at that step (the failure drill);
``--lose-devices`` re-plans the mesh it prints.

``sde-gan`` trains the SDE-GAN (paper §5) at the reference's widths — data
1, hidden 16, noise 4, width 32, depth 1, discriminator hidden 16 and
width 32, 32 observations of the OU process (``--seq-len``) against 31
solver steps (``--sde-steps``) — with Adadelta for both players and the
exact reversible adjoint; the discriminator is carefully clipped
(``--constraint clip``, the paper's recipe) or penalised (``gp``, the
WGAN-GP baseline).  ``latent-sde`` trains the Latent SDE (paper Appendix
B) at the widths the reference trains it at — data 2, hidden 16, context
16, initial noise 8, width 32, depth 1, 24 observations on a 23-step grid
— with Adam.  The paper's baselines take the reference's flags:
``--solver`` (any registered solver; a solver other than reversible Heun
trains by discretise-then-optimise; srk draws ``(W, H)`` space-time
Lévy-area pairs, its path rebuilt in that mode, and takes diagonal noise
only, so ``--workload sde-gan --solver srk`` stops with the registry's
named noise error), ``--adjoint exact | backsolve |
checkpoint`` for the Latent SDE (``--backsolve`` is ``--adjoint
backsolve`` and picks midpoint when the solver is left at reversible
Heun), and ``--precision bf16_compute`` (the fields in bfloat16, the state
and the gradients' accumulation in float32) for both.  For both the key
of step ``s`` is ``fold_in(fold_in(PRNGKey(seed), 2), s)``, the
reference's.

With ``--ckpt-dir`` every workload saves a resumable checkpoint every
``--ckpt-every`` steps and at the end, and a rerun resumes from the newest
one; the SDE workloads also write their servable parameters (the
generator, the VAE) as a ``repro-serving/v2`` bundle at every save, which
the serve CLI (either package's) restores.  Fresh weights come from a
``torch.Generator`` seeded with ``seed`` (the port cannot draw the
reference's ``jax.random`` init; the tests carry weights across instead).

``--host-devices N`` trains the SDE workloads data-parallel over ``N``
local ranks (spawned processes, :func:`repro_torch.distributed.compat.
launch`): gloo ranks on the CPU with ``--device cpu``, or on the card
(NCCL when each rank has a card of its own, gloo when they share one).  The
parameters are replicated, each rank steps its ``batch / N`` rows, and one
flat all-reduce of the gradients a step keeps the ranks' parameters
bitwise equal; rank 0 writes the checkpoints.  A batch that does not
divide runs unsharded on every rank, with the reference's message.

Every workload runs on the card by default; with no card and no
``--device cpu`` it stops with a named error.  The LM's sharded execution
is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import checkpoint as ckpt
from .. import tree
from ..device import resolve_device
from ..kernels import prng
from .steps import GAN_CONSTRAINTS

SEQ_LEN = 24


class StragglerMonitor:
    """EWMA step-time deadline: flags steps slower than ``factor``× the mean."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        straggle = self.mean is not None and dt > self.factor * self.mean
        self.mean = dt if self.mean is None else (1 - self.alpha) * self.mean + self.alpha * dt
        if straggle:
            self.flagged += 1
        return straggle


def _device_count(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def lm_batch(cfg, data_key, step: int, batch: int, seq: int) -> dict:
    """Step ``step``'s batch, the reference's: ``token_batches`` and, for a
    VLM, the prefix embeddings in place of the first ``frontend_len``
    tokens, or, for the encoder-decoder, the source embeddings; the
    normals from ``fold_in(data_key, step + 10000)`` in ``cfg.dtype``."""
    from ..data.synthetic import token_batches

    data = token_batches(data_key, step, batch, seq, cfg.vocab)
    if not (cfg.frontend or cfg.family == "encdec"):
        return data
    key = prng.fold_in_key(data_key, step + 10_000)
    if cfg.family == "encdec":
        src = prng.normal_like(key[0], key[1], (batch, seq, cfg.d_model), cfg.dtype)
        return {"src_embeds": src, **data}
    f = cfg.frontend_len
    embeds = prng.normal_like(key[0], key[1], (batch, f, cfg.d_model), cfg.dtype)
    return {"embeds": embeds, "tokens": data["tokens"][:, f:], "labels": data["labels"][:, f:]}


def train(arch: str, steps: int, batch: int, seq: int, ckpt_dir: Optional[str],
          ckpt_every: int = 20, smoke: bool = True, seed: int = 0,
          fail_at_step: Optional[int] = None, lose_devices: int = 0, log_every: int = 10,
          peak_lr: float = 3e-4, device=None, params=None):
    """LM training -> ``(params, losses)``, the reference's loop.

    ``params``: starting weights on the run's device (e.g. a JAX model's,
    carried across with ``params_from_jax``); default fresh ones from a
    ``torch.Generator`` seeded with ``seed``.  ``losses`` holds the loss of
    every step this call ran, each read after its step (which waits for the
    card).  A resumed run restores the parameters in the dtype the step
    leaves them (float32; the reference restores into its fresh template
    and so rounds a bfloat16 model's back to bfloat16, ROADMAP.md Queue 3),
    so it continues bitwise where the uninterrupted run would be."""
    from ..configs import get_config, smoke_config
    from ..distributed.elastic import plan_mesh, surviving_devices
    from ..models import transformer as T
    from .steps import make_optimizer, make_train_step

    cfg = smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    key = prng.PRNGKey(seed, device=dev)
    data_key = prng.fold_in_key(key, 1)

    n_dev = surviving_devices(_device_count(dev), 0) - lose_devices
    data_deg, model_deg = plan_mesh(max(n_dev, 1), model_parallel=1)
    print(f"[train] mesh plan: data={data_deg} model={model_deg} ({n_dev} devices)",
          flush=True)

    if params is None:
        params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    opt_init, opt_update = make_optimizer(cfg, peak_lr=peak_lr, total=steps)
    opt_state = opt_init(params)
    step_fn = make_train_step(cfg, opt_update)

    start = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        stepped = tree.map(lambda p: p.to(torch.promote_types(p.dtype, torch.float32)),
                           params)
        (params, opt_state), start = ckpt.restore_checkpoint(ckpt_dir, (stepped, opt_state))
        print(f"[train] resumed from step {start}", flush=True)

    monitor = StragglerMonitor()
    losses = []
    for step in range(start, steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"simulated node failure at step {step}")
        t0 = time.perf_counter()
        batch_data = lm_batch(cfg, data_key, step, batch, seq)
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        if monitor.observe(dt):
            print(f"[train] straggler: step {step} took {dt:.2f}s "
                  f"(mean {monitor.mean:.2f}s)", flush=True)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms", flush=True)
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt.save_checkpoint(ckpt_dir, step + 1, (params, opt_state))
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, steps, (params, opt_state))
    return params, losses


class CheckpointLayoutError(ValueError):
    """A checkpoint's leaves do not match the run's state layout (saved
    under other flags, e.g. ``--constraint``, or by an older version)."""


def _restore_or_fresh(ckpt_dir: Optional[str], template, tag: str):
    """Resume from the newest checkpoint into ``template`` (the fresh state
    and step 0 when there is none).  A layout mismatch stops here with
    :class:`CheckpointLayoutError` instead of deep inside a leaf lookup."""
    if ckpt_dir is None or ckpt.latest_step(ckpt_dir) is None:
        return template, 0
    try:
        state, start = ckpt.restore_checkpoint(ckpt_dir, template)
    except (KeyError, ValueError) as e:
        raise CheckpointLayoutError(
            f"checkpoint in {ckpt_dir} does not match the current "
            f"parameter/optimiser-state layout — it was saved under "
            f"different flags (e.g. --constraint) or an older code version; "
            f"use a fresh --ckpt-dir or rerun with matching flags") from e
    print(f"[{tag}] resumed from step {start}", flush=True)
    return state, start


def _data_parallel_mesh(batch: int, tag: str):
    """The data-parallel mesh over the process group's ranks (one rank: no
    mesh).  Both Neural-SDE workloads are pure batch parallelism: the
    parameters are tiny and replicated, only the sample batch shards.  A
    batch that does not divide runs unsharded on every rank."""
    import torch.distributed as dist

    from ..distributed.sharding import data_parallel_mesh

    mesh = data_parallel_mesh(batch)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh is None and world > 1:
        print(f"[{tag}] batch {batch} not divisible by {world} devices — running "
              f"unsharded", flush=True)
    return mesh


def _sde_training_loop(tag: str, start: int, steps: int, batch: int, state, step_fn,
                       data_key, ckpt_dir: Optional[str], ckpt_every: int, on_step,
                       serving):
    """The Neural-SDE workloads' step loop -> ``(state, history)``: the key
    of step ``s`` is ``fold_in(data_key, s)``, each step's metrics are read
    as floats (which waits for the card), a straggler monitor watches the
    step times, and with ``ckpt_dir`` a resumable checkpoint of ``state`` is
    written every ``ckpt_every`` steps and at the end.  Under a process
    group of several ranks the steps run under the data-parallel mesh
    (:func:`_data_parallel_mesh`), rank 0 writes each save while the others
    wait at a barrier, and every rank has restored the same checkpoint.

    ``step_fn``: ``(state, key) -> (state, metrics)``.  ``on_step(step,
    state, metrics, dt)`` logs and returns the step's record for
    ``history``.  ``serving``: ``(workload, cfg, extract_params)`` — every
    save also writes the servable parameters as a serving bundle
    (``<ckpt_dir>/serving/``), which the serve CLI restores."""
    import contextlib

    from ..distributed import compat

    workload, cfg, extract_params = serving

    def save(step, state):
        if compat.rank() == 0:
            ckpt.save_checkpoint(ckpt_dir, step, state)
            ckpt.save_serving_bundle(ckpt_dir, step, extract_params(state), workload, cfg)
        compat.barrier()

    mesh = _data_parallel_mesh(batch, tag)
    if mesh is not None:
        device = tree.leaves(state)[0].device
        print(f"[{tag}] data-parallel over {mesh.size} devices "
              f"({compat.backend_note(device)})", flush=True)
    monitor = StragglerMonitor()
    history = []
    with compat.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for step in range(start, steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, prng.fold_in_key(data_key, step))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if monitor.observe(dt):
                print(f"[{tag}] straggler: step {step} took {dt:.2f}s", flush=True)
            history.append(on_step(step, state, metrics, dt))
            if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
                save(step + 1, state)
    if ckpt_dir is not None:
        save(steps, state)
    return state, history


def train_sde_gan(steps: int, batch: int, ckpt_dir: Optional[str] = None,
                  ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
                  use_pallas: bool = False, num_steps: int = 31, seq_len: int = 32,
                  constraint: str = "clip", solver: str = "reversible_heun",
                  precision: str = "highest", device=None):
    """SDE-GAN training (paper §5) -> ``(params, history)``.

    At the reference's widths (data 1, hidden 16, noise 4, initial noise 4,
    width 32, depth 1; discriminator hidden 16, width 32), reversible Heun
    with the exact adjoint (another ``solver`` trains by discretise-then-
    optimise, as the reference's), the fields in ``precision``, Adadelta
    for both players at lr 1, and the
    discriminator carefully clipped (``constraint="clip"``) or penalised
    (``"gp"``); the step is :func:`repro_torch.launch.steps.make_sde_gan_step`.
    Fresh parameters come from one ``torch.Generator`` seeded with ``seed``
    (generator, then discriminator); the key of step ``s`` is
    ``fold_in(fold_in(PRNGKey(seed), 2), s)``, the reference's.  ``history``
    holds each step's ``gen_loss``, ``disc_loss`` and ``wasserstein`` (before
    its update), and every ``log_every`` steps ``sig_mmd``: the signature
    MMD between ``ou_process(fold_in(key, 777), 256, seq_len)`` and
    ``generator_sample(fold_in(key, 778), 256)`` after the step.  With
    ``ckpt_dir`` a rerun resumes from the newest checkpoint, and every save
    writes the generator as a serving bundle."""
    from ..core.losses import signature_mmd
    from ..core.sde import NeuralSDEConfig, discriminator_init, generator_init, generator_sample
    from ..data.synthetic import ou_process
    from .steps import make_gan_optimizers, make_sde_gan_step

    dev = resolve_device(device)
    cfg = NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, width=32,
                          num_steps=num_steps, solver=solver,
                          exact_adjoint=solver == "reversible_heun",
                          use_pallas_kernels=use_pallas, precision=precision)
    gen = torch.Generator().manual_seed(seed)
    params = {"gen": generator_init(gen, cfg, device=dev),
              "disc": discriminator_init(gen, cfg, device=dev)}
    key = prng.PRNGKey(seed, device=dev)
    data_key = prng.fold_in_key(key, 2)
    (gi, gu), (di, du) = make_gan_optimizers(lr=1.0, constraint=constraint)
    step_fn = make_sde_gan_step(cfg, gu, du, batch, seq_len, constraint=constraint,
                                device=dev)
    state, start = _restore_or_fresh(ckpt_dir, (params, gi(params["gen"]),
                                                di(params["disc"])), "sde-gan")

    def gan_step(state, k):
        params, g_state, d_state, metrics = step_fn(*state, k)
        return (params, g_state, d_state), metrics

    def on_step(step, state, metrics, dt):
        if step % log_every == 0:
            with torch.no_grad():
                y_real = ou_process(prng.fold_in_key(key, 777), 256, seq_len)
                fake = generator_sample(state[0]["gen"], cfg, prng.fold_in_key(key, 778), 256)
                metrics["sig_mmd"] = float(signature_mmd(y_real, fake))
            print(f"[sde-gan] step {step:5d} sig-MMD {metrics['sig_mmd']:.4f} "
                  f"W {metrics['wasserstein']:.4f} {dt * 1e3:.0f}ms", flush=True)
        return dict(metrics, step=step)

    (params, _, _), history = _sde_training_loop(
        "sde-gan", start, steps, batch, state, gan_step, data_key, ckpt_dir, ckpt_every,
        on_step, ("sde-gan", cfg, lambda s: s[0]["gen"]))
    return params, history


def train_latent_sde(steps: int, batch: int, ckpt_dir: Optional[str] = None,
                     ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
                     use_pallas: bool = False, num_steps: int = SEQ_LEN - 1,
                     seq_len: int = SEQ_LEN, kl_weight: float = 0.1, lr: float = 1e-2,
                     solver: str = "reversible_heun", adjoint: str = "exact",
                     precision: str = "highest", device=None):
    """Latent-SDE (VAE) training -> ``(params, losses)``, on the SDE-GAN's
    loop (:func:`_sde_training_loop`): resumable checkpoints with a serving
    bundle at every save.

    Fresh parameters come from a ``torch.Generator`` seeded with ``seed``
    (the port cannot draw the reference's ``jax.random`` init; the tests
    carry weights across instead).  ``losses`` holds the −ELBO of every step
    this call ran.  ``adjoint`` is the step's derivation (``"exact"``,
    ``"backsolve"`` or ``"checkpoint"``, :func:`repro_torch.launch.steps.
    make_latent_sde_step`), ``solver`` and ``precision`` the posterior
    solve's."""
    from ..core.sde import LatentSDEConfig, latent_sde_init
    from .steps import make_latent_sde_optimizer, make_latent_sde_step

    dev = resolve_device(device)
    cfg = LatentSDEConfig(
        data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=num_steps,
        solver=solver, kl_weight=kl_weight,
        exact_adjoint=adjoint == "exact" and solver == "reversible_heun",
        use_pallas_kernels=use_pallas, precision=precision)
    params = latent_sde_init(torch.Generator().manual_seed(seed), cfg, device=dev)
    init, update = make_latent_sde_optimizer(lr)
    step_fn = make_latent_sde_step(cfg, update, batch, seq_len, adjoint=adjoint, device=dev)
    data_key = prng.fold_in_key(prng.PRNGKey(seed, device=dev), 2)
    state, start = _restore_or_fresh(ckpt_dir, (params, init(params)), "latent-sde")

    def vae_step(state, k):
        params, opt_state, metrics = step_fn(*state, k)
        return (params, opt_state), metrics

    def on_step(step, state, metrics, dt):
        if step % log_every == 0:
            print(f"[latent-sde] step {step:5d} -ELBO {metrics['loss']:.4f} "
                  f"recon {metrics['recon']:.4f} kl_path {metrics['kl_path']:.4f} "
                  f"{dt * 1e3:.0f}ms", flush=True)
        return metrics["loss"]

    (params, _), losses = _sde_training_loop(
        "latent-sde", start, steps, batch, state, vae_step, data_key, ckpt_dir, ckpt_every,
        on_step, ("latent-sde", cfg, lambda s: s[0]))
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("lm", "sde-gan", "latent-sde"), default="lm")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="lm: the architecture (qwen2.5-14b, tinyllama-1.1b, starcoder2-3b, "
                         "minicpm3-4b, dbrx-132b, grok-1-314b, mamba2-1.3b, jamba-v0.1-52b, "
                         "pixtral-12b or seamless-m4t-medium)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8 (lm), 128 (sde-gan) or 64 (latent-sde)")
    ap.add_argument("--seq", type=int, default=64, help="lm: tokens per sequence")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="lm: the reduced smoke config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="lm: the full config")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between resumable checkpoints")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="lm: raise at this step (the failure drill)")
    ap.add_argument("--lose-devices", type=int, default=0,
                    help="lm: re-plan the mesh without this many devices")
    ap.add_argument("--constraint", choices=GAN_CONSTRAINTS, default="clip",
                    help="sde-gan Lipschitz control: 'clip' = the paper's careful "
                         "clipping, 'gp' = the WGAN-GP baseline")
    ap.add_argument("--sde-steps", type=int, default=None,
                    help="solver steps per solve (default 31 for sde-gan; 23 for "
                         "latent-sde, which needs a positive multiple of seq_len - 1)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="sde-gan: observed path length (default 32)")
    ap.add_argument("--solver", default="reversible_heun",
                    help="sde-gan/latent-sde: any solver registered with "
                         "repro_torch.core.solve")
    ap.add_argument("--backsolve", action="store_true",
                    help="latent-sde: use the continuous-adjoint backsolve baseline "
                         "(Li et al. eq. (6), O(√h) gradient error) instead of the "
                         "exact reversible adjoint; pairs with --solver midpoint "
                         "(auto-selected if the solver is left at reversible_heun)")
    ap.add_argument("--adjoint", choices=("exact", "backsolve", "checkpoint"),
                    default=None,
                    help="latent-sde gradient derivation: 'exact' (the paper's "
                         "reversible adjoint), 'backsolve' (same as --backsolve), or "
                         "'checkpoint' (recursive binomial checkpointing — exact "
                         "gradients at O(log n) memory, any solver).  Default: exact, "
                         "or backsolve when --backsolve is given")
    ap.add_argument("--precision", choices=("highest", "bf16_compute"), default="highest",
                    help="sde-gan/latent-sde field-eval compute policy: 'bf16_compute' "
                         "casts drift/diffusion evaluation to bfloat16 while gradient "
                         "accumulation stays in the state dtype; 'highest' (default) "
                         "is bitwise unchanged")
    ap.add_argument("--pallas", action="store_true",
                    help="the fused hot loop: latent-sde's forward, reconstruction and "
                         "cotangent phases in the CUDA kernels; sde-gan's general-noise "
                         "solves warn and run unfused")
    ap.add_argument("--lr", type=float, default=1e-2, help="latent-sde: Adam learning rate")
    ap.add_argument("--kl-weight", type=float, default=0.1,
                    help="latent-sde: ELBO KL term weight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda'), 'cpu' on request")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resumable checkpoints here (a rerun resumes from the newest); "
                         "sde-gan and latent-sde also write a serving bundle at every save")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="sde-gan/latent-sde: train data-parallel over N local ranks "
                         "(spawned processes; gloo on the CPU or ranks sharing one card, "
                         "NCCL with a card a rank)")
    args = ap.parse_args(argv)
    if args.host_devices is not None and args.host_devices > 1:
        if args.workload == "lm":
            ap.error("--host-devices: the LM's sharded execution is not ported yet — "
                     "ROADMAP.md Queue 1, 'Sharded LM execution'")
        from ..distributed.compat import run_cli_ranks

        return run_cli_ranks(main, argv, args.host_devices, args.device)
    if args.workload == "lm":
        _, losses = train(args.arch, args.steps, args.batch or 8, args.seq, args.ckpt_dir,
                          ckpt_every=args.ckpt_every, smoke=args.smoke, seed=args.seed,
                          fail_at_step=args.fail_at_step, lose_devices=args.lose_devices,
                          device=args.device)
        tag, what = "train", "loss"
    elif args.workload == "sde-gan":
        _, history = train_sde_gan(
            args.steps, args.batch or 128, args.ckpt_dir, args.ckpt_every, args.seed,
            use_pallas=args.pallas, num_steps=31 if args.sde_steps is None else args.sde_steps,
            seq_len=32 if args.seq_len is None else args.seq_len,
            constraint=args.constraint, solver=args.solver, precision=args.precision,
            device=args.device)
        losses = [r["sig_mmd"] for r in history if "sig_mmd" in r]
        what = "sig-MMD" if losses else "W"
        losses = losses or [r["wasserstein"] for r in history]
        tag = "sde-gan"
    else:
        adjoint = args.adjoint
        if adjoint is None:
            adjoint = "backsolve" if args.backsolve else "exact"
        elif args.backsolve and adjoint != "backsolve":
            ap.error(f"--backsolve conflicts with --adjoint {adjoint}")
        solver = args.solver
        if adjoint == "backsolve" and solver == "reversible_heun":
            solver = "midpoint"  # the backsolve baseline's solver (the paper's)
            print("[latent-sde] --backsolve: using midpoint (reversible_heun has no "
                  "continuous-adjoint backward)", flush=True)
        _, losses = train_latent_sde(
            args.steps, args.batch or 64, args.ckpt_dir, args.ckpt_every, seed=args.seed,
            use_pallas=args.pallas,
            num_steps=SEQ_LEN - 1 if args.sde_steps is None else args.sde_steps,
            kl_weight=args.kl_weight, lr=args.lr, solver=solver, adjoint=adjoint,
            precision=args.precision, device=args.device)
        tag, what = "latent-sde", "-ELBO"
    if losses:
        print(f"[{tag}] done: first {what} {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:  # e.g. resumed a finished run
        print(f"[{tag}] done: no steps run")
    return losses


if __name__ == "__main__":
    main()
