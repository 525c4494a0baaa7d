"""Neural-SDE training CLI (port of :mod:`repro.launch.train`, the
``latent-sde`` workload).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde --pallas
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde \\
        --device cpu --steps 2 --batch 8         # plain PyTorch versions, no card
    PYTHONPATH=src python -m repro_torch.launch.train --workload latent-sde \\
        --ckpt-dir D && python -m repro_torch.launch.serve --ckpt-dir D

Trains the Latent SDE (paper Appendix B) at the widths the reference trains
it at — data 2, hidden 16, context 16, initial noise 8, width 32, depth 1,
24 observations on a 23-step grid — with Adam and the exact reversible
adjoint.  Runs on the card by default; with no card and no ``--device cpu``
it stops with a named error.  The key of step ``s`` is ``fold_in(fold_in(
PRNGKey(seed), 2), s)``, the reference's.  With ``--ckpt-dir`` the trained
parameters are written as a ``repro-serving/v2`` bundle that the serve CLI
(either package's) restores.  Resumable training checkpoints, the
``sde-gan`` and ``lm`` workloads and the backsolve/checkpoint adjoints are
not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import checkpoint as ckpt
from ..device import resolve_device
from ..kernels import prng

SEQ_LEN = 24


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
    ap.add_argument("--workload", choices=("latent-sde",), default="latent-sde",
                    help="the port trains the Latent SDE so far")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sde-steps", type=int, default=None,
                    help="solver steps; a positive multiple of seq_len - 1 "
                         "(default 23)")
    ap.add_argument("--pallas", action="store_true",
                    help="the fused hot loop: forward, reconstruction and "
                         "cotangent phases in the CUDA kernels")
    ap.add_argument("--lr", type=float, default=1e-2, help="Adam learning rate")
    ap.add_argument("--kl-weight", type=float, default=0.1, help="ELBO KL term weight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda'), 'cpu' on request")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write the trained parameters as a serving bundle here")
    args = ap.parse_args(argv)
    _, losses = train_latent_sde(
        args.steps, args.batch, args.ckpt_dir, seed=args.seed, use_pallas=args.pallas,
        num_steps=SEQ_LEN - 1 if args.sde_steps is None else args.sde_steps,
        kl_weight=args.kl_weight, lr=args.lr, device=args.device)
    if losses:
        print(f"[latent-sde] done: first -ELBO {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        print("[latent-sde] done: no steps run")
    return losses


if __name__ == "__main__":
    main()
