"""Training CLI (port of :mod:`repro.launch.train`: the ``lm`` workload,
the default, and ``latent-sde``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 50 --ckpt-dir D                   # the smoke config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde --pallas
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde \\
        --ckpt-dir D && python -m repro_torch.launch.serve --ckpt-dir D

``lm`` trains a decoder-only LM of the dense or SSM family (``--arch``; the
reduced smoke config unless ``--full``) with AdamW on the cosine schedule,
the loss through the ``fused_xent`` kernels on the card.  The loop is the
reference's: the batch of step ``n`` is ``token_batches(fold_in(PRNGKey(
seed), 1), n)``, bitwise the reference's; with ``--ckpt-dir`` it saves a
resumable checkpoint every ``--ckpt-every`` steps and at the end, and a
rerun resumes from the newest one; ``--fail-at-step`` raises at that step
(the failure drill); ``--lose-devices`` re-plans the mesh it prints.  Fresh
weights come from a ``torch.Generator`` seeded with ``seed`` on the run's
device (the port cannot draw the reference's ``jax.random`` init; the
tests carry weights across instead).

``latent-sde`` trains the Latent SDE (paper Appendix B) at the widths the
reference trains it at — data 2, hidden 16, context 16, initial noise 8,
width 32, depth 1, 24 observations on a 23-step grid — with Adam and the
exact reversible adjoint; the key of step ``s`` is ``fold_in(fold_in(
PRNGKey(seed), 2), s)``, the reference's.  With ``--ckpt-dir`` the trained
parameters are written as a ``repro-serving/v2`` bundle that the serve CLI
(either package's) restores.

Both run on the card by default; with no card and no ``--device cpu`` they
stop with a named error.  The ``sde-gan`` workload, the vlm/audio/encdec
families and the backsolve/checkpoint adjoints are not ported yet
(ROADMAP.md Queue 1).
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
    from ..data.synthetic import token_batches
    from ..distributed.elastic import plan_mesh, surviving_devices
    from ..models import transformer as T
    from .steps import make_optimizer, make_train_step

    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.frontend or cfg.family == "encdec":
        raise T.ModelNotPortedError(
            f"{arch}: the {cfg.family} family's training batches (prefix or source "
            f"embeddings) are not ported yet — ROADMAP.md Queue 1, 'The rest of the LM zoo'")
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
        batch_data = token_batches(data_key, step, batch, seq, cfg.vocab)
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


def train_latent_sde(steps: int, batch: int, ckpt_dir: Optional[str] = None,
                     seed: int = 0, log_every: int = 10, use_pallas: bool = False,
                     num_steps: int = SEQ_LEN - 1, seq_len: int = SEQ_LEN,
                     kl_weight: float = 0.1, lr: float = 1e-2, device=None):
    """Latent-SDE (VAE) training -> ``(params, losses)``.

    Fresh parameters come from a ``torch.Generator`` seeded with ``seed``
    (the port cannot draw the reference's ``jax.random`` init; the tests
    carry weights across instead).  ``losses`` holds every step's −ELBO as
    a float; each one is read after its step, which waits for the card."""
    from ..core.sde import LatentSDEConfig, latent_sde_init
    from .steps import make_latent_sde_optimizer, make_latent_sde_step

    dev = resolve_device(device)
    cfg = LatentSDEConfig(
        data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=num_steps,
        kl_weight=kl_weight, use_pallas_kernels=use_pallas)
    params = latent_sde_init(torch.Generator().manual_seed(seed), cfg, device=dev)
    init, update = make_latent_sde_optimizer(lr)
    opt_state = init(params)
    step_fn = make_latent_sde_step(cfg, update, batch, seq_len, device=dev)
    data_key = prng.fold_in_key(prng.PRNGKey(seed, device=dev), 2)
    losses = []
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             prng.fold_in_key(data_key, step))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            print(f"[latent-sde] step {step:5d} -ELBO {loss:.4f} "
                  f"recon {float(metrics['recon']):.4f} "
                  f"kl_path {float(metrics['kl_path']):.4f} "
                  f"{(time.perf_counter() - t0) * 1e3:.0f}ms", flush=True)
    if ckpt_dir is not None:
        path = ckpt.save_serving_bundle(ckpt_dir, steps, params, "latent-sde", cfg)
        print(f"[latent-sde] serving bundle written to {path}", flush=True)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("lm", "latent-sde"), default="lm")
    ap.add_argument("--arch", default="tinyllama-1.1b", help="lm: the architecture")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8 (lm) or 64 (latent-sde)")
    ap.add_argument("--seq", type=int, default=64, help="lm: tokens per sequence")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="lm: the reduced smoke config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="lm: the full config")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="lm: steps between resumable checkpoints")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="lm: raise at this step (the failure drill)")
    ap.add_argument("--lose-devices", type=int, default=0,
                    help="lm: re-plan the mesh without this many devices")
    ap.add_argument("--sde-steps", type=int, default=None,
                    help="latent-sde: solver steps; a positive multiple of seq_len - 1 "
                         "(default 23)")
    ap.add_argument("--pallas", action="store_true",
                    help="latent-sde: the fused hot loop: forward, reconstruction and "
                         "cotangent phases in the CUDA kernels")
    ap.add_argument("--lr", type=float, default=1e-2, help="latent-sde: Adam learning rate")
    ap.add_argument("--kl-weight", type=float, default=0.1,
                    help="latent-sde: ELBO KL term weight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda'), 'cpu' on request")
    ap.add_argument("--ckpt-dir", default=None,
                    help="lm: resumable checkpoints here (a rerun resumes); latent-sde: "
                         "write the trained parameters as a serving bundle here")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        _, losses = train(args.arch, args.steps, args.batch or 8, args.seq, args.ckpt_dir,
                          ckpt_every=args.ckpt_every, smoke=args.smoke, seed=args.seed,
                          fail_at_step=args.fail_at_step, lose_devices=args.lose_devices,
                          device=args.device)
        tag, what = "train", "loss"
    else:
        _, losses = train_latent_sde(
            args.steps, args.batch or 64, args.ckpt_dir, seed=args.seed,
            use_pallas=args.pallas,
            num_steps=SEQ_LEN - 1 if args.sde_steps is None else args.sde_steps,
            kl_weight=args.kl_weight, lr=args.lr, device=args.device)
        tag, what = "latent-sde", "-ELBO"
    if losses:
        print(f"[{tag}] done: first {what} {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        print(f"[{tag}] done: no steps run")
    return losses


if __name__ == "__main__":
    main()
