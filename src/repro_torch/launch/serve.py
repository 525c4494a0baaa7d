"""Neural-SDE serving CLI (port of :mod:`repro.launch.serve`).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde --pallas
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan --adaptive \\
        --atol 1e-6                         # terminal samples, deadline-routed rtol
    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde \\
        --ckpt-dir /path/to/ckpt            # a JAX- or port-written bundle
    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde \\
        --device cpu                        # plain PyTorch versions, no card

Serves on the card by default; with no card and no ``--device cpu`` it
stops with a named error.  ``--adaptive`` serves SDE-GAN terminal samples,
each batch at the tolerance its deadline class admits.  Other workloads
and modes of the reference CLI raise a named error pointing at
ROADMAP.md.
"""

from __future__ import annotations

import argparse

from ..serving import serve_sde
from .steps import SERVE_WORKLOADS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=SERVE_WORKLOADS + ("lm",), default="latent-sde")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory holding a serving bundle under serving/; omit "
                         "for a freshly initialised model")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda'), 'cpu' on request")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="largest serving bucket (rows per batch)")
    ap.add_argument("--requests", type=int, default=12,
                    help="synthetic requests to drain through the queue")
    ap.add_argument("--request-max", type=int, default=4,
                    help="largest per-request trajectory count")
    ap.add_argument("--latent-mode", choices=("prior", "posterior"), default="prior")
    ap.add_argument("--stream-chunks", type=int, default=0,
                    help="stream each trajectory in this many time chunks (not "
                         "ported yet)")
    ap.add_argument("--adaptive", action="store_true",
                    help="sde-gan: adaptive terminal samples, rtol routed per "
                         "request deadline class")
    ap.add_argument("--atol", type=float, default=1e-6,
                    help="absolute tolerance of --adaptive")
    ap.add_argument("--pallas", action="store_true",
                    help="fresh-init: the fused hot loop (phase-1 kernel draws ΔW, "
                         "phase-2 kernel); restored bundles carry their own")
    ap.add_argument("--sde-steps", type=int, default=None,
                    help="fresh-init solver steps (default 16)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.workload == "lm":
        from ..serving.service import ServingNotPortedError

        raise ServingNotPortedError(
            "--workload lm (the transformer zoo's decode loop) is ported last — "
            "ROADMAP.md Queue 1, item 14")
    return serve_sde(args.workload, args.ckpt_dir, max_batch=args.max_batch, requests=args.requests,
                     request_max=args.request_max, latent_mode=args.latent_mode,
                     stream_chunks=args.stream_chunks, adaptive=args.adaptive,
                     atol=args.atol, seed=args.seed, device=args.device, sde_steps=args.sde_steps,
                     pallas=args.pallas)


if __name__ == "__main__":
    main()
