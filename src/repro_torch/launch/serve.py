"""Serving CLI (port of :mod:`repro.launch.serve`): the Neural-SDE services
and the transformer LM's prefill + greedy-decode loop.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde --pallas
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan --adaptive \\
        --atol 1e-6                         # terminal samples, deadline-routed rtol
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan \\
        --scheduler continuous --preempt --pool-budget-mb 64 --async-front
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan \\
        --stream-chunks 4                   # the rollout in four time chunks
    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde \\
        --latent-mode posterior --obs-len 9
    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde \\
        --ckpt-dir /path/to/ckpt            # a JAX- or port-written bundle
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch qwen2.5-14b --batch 4 --prompt-len 32 --gen 16   # smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch mamba2-1.3b --full             # the full model, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch dbrx-132b                    # MoE (also grok-1-314b), smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch jamba-v0.1-52b               # hybrid: attention, Mamba2 and MoE
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch minicpm3-4b                  # MLA (also pixtral-12b: a VLM prefix)
    PYTHONPATH=src python -m repro_torch.launch.serve --workload latent-sde \\
        --device cpu                        # plain PyTorch versions, no card
    PYTHONPATH=src python -m repro_torch.launch.serve --workload sde-gan \\
        --host-devices 2 [--scheduler continuous]   # data-parallel over 2 ranks

Serves on the card by default; with no card and no ``--device cpu`` it
stops with a named error.  The Neural-SDE modes are the reference's:
``--latent-mode posterior [--obs-len N]`` encodes observations and decodes
the posterior, ``--stream-chunks K`` emits the SDE-GAN rollout in time
chunks, ``--adaptive`` serves SDE-GAN terminal samples, each batch at the
tolerance its deadline class admits, and ``--scheduler
{continuous,fifo}`` drives the continuous-batching scheduler (``--preempt``,
``--pool-budget-mb``, ``--async-front`` ride on it; its steps are CUDA
graphs on the card).  ``--workload lm`` serves the dense family
(qwen2.5-14b, tinyllama-1.1b, starcoder2-3b, and minicpm3-4b with MLA
attention), the MoE family (dbrx-132b, grok-1-314b), the pure-SSM family
(mamba2-1.3b), the hybrid family (jamba-v0.1-52b) and the VLM
(pixtral-12b, behind a prefix of random patch embeddings) at their smoke
size unless ``--full`` is given, as the reference's flags read; the
encoder-decoder (seamless-m4t-medium) is refused with the reference's
message (it serves through ``make_prefill_step`` / ``make_serve_step``
with source embeddings).  ``--host-devices N`` serves the Neural-SDE
workloads data-parallel over ``N`` local ranks (spawned processes: gloo on
the CPU with ``--device cpu`` or ranks sharing one card, NCCL with a card a
rank), every mode included, each trajectory bitwise the one-rank
service's.  Still unported, with a named error pointing at ROADMAP.md:
the LM's sharded execution (``--workload lm --host-devices``).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..serving import serve_sde
from .steps import SERVE_WORKLOADS


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_prompts(seed: int, batch: int, prompt_len: int, vocab: int) -> torch.Tensor:
    """The reference's prompts, bitwise: ``jax.random.randint(fold_in(
    PRNGKey(seed), 1), (batch, prompt_len), 0, vocab)`` (int32, the
    ``jax_threefry_partitionable=False`` layout)."""
    from ..kernels import prng

    key = prng.fold_in_key(prng.PRNGKey(seed), 1)
    return prng.randint(key, batch * prompt_len, 0, vocab).reshape(batch, prompt_len)


def lm_prefix(seed: int, batch: int, cfg) -> torch.Tensor:
    """The reference's VLM prefix, ``jax.random.normal(fold_in(PRNGKey(
    seed), 2), (batch, frontend_len, d_model), cfg.dtype)``: the same
    random bits, the normals within a few float32 ulp (one bfloat16 ulp)."""
    from ..kernels import prng

    key = prng.fold_in_key(prng.PRNGKey(seed), 2)
    return prng.normal_like(key[0], key[1], (batch, cfg.frontend_len, cfg.d_model), cfg.dtype)


def serve_lm(arch: str, batch: int, prompt_len: int, gen: int, smoke: bool = True,
             seed: int = 0, device=None, params=None):
    """Prefill + greedy decode of a decoder-only LM (dense with GQA or MLA,
    MoE, Mamba2, hybrid, or the VLM); returns the generated tokens, int32
    ``(batch, gen)``.  The encoder-decoder is refused with the reference's
    ``SystemExit``.

    Fresh weights come from a generator seeded with ``seed`` on the serving
    device, unless ``params`` are given (weights carried across from JAX,
    or one model served at several shapes).  The prompts are the
    reference's (:func:`lm_prompts`); a VLM's prefix is the reference's
    ``normal(fold_in(PRNGKey(seed), 2), (batch, frontend_len, d_model),
    cfg.dtype)`` (:func:`lm_prefix`), and the first decode position follows
    it.  An attention cache holds ``frontend_len + prompt_len + gen`` slots;
    a Mamba2 cache is its conv window and SSM state, and a prompt shorter
    than ``ssm_conv − 1`` raises.  Prints the prefill time and the decode rate, each timed between
    device synchronisations."""
    from ..configs import get_config, smoke_config
    from ..models import transformer as T
    from .steps import greedy_sample, make_prefill_step, make_serve_step

    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "encdec":
        raise SystemExit("use --arch with a decoder-only config for serve.py")
    dev = resolve_device(device)
    if params is None:
        params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    prefix = cfg.frontend_len if cfg.frontend else 0
    max_len = prompt_len + gen + prefix
    batch_in = {"tokens": lm_prompts(seed, batch, prompt_len, cfg.vocab).to(dev)}
    if prefix:
        batch_in["embeds"] = lm_prefix(seed, batch, cfg).to(dev)
    pos0 = prompt_len + prefix
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch_in)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    token = greedy_sample(logits)
    out_tokens = [token]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, caches, token, pos0 + i)
        token = greedy_sample(logits)
        out_tokens.append(token)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out_tokens, dim=1)
    tps = batch * (gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] {arch}: batch={batch} prefill({prompt_len} tok) "
          f"{t_prefill * 1e3:.1f}ms; decode {gen - 1} steps @ {tps:.1f} tok/s")
    print(f"[serve] sample generation (row 0): {gen_tokens[0].tolist()}")
    return gen_tokens


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
    ap.add_argument("--host-devices", type=int, default=None,
                    help="sde-gan/latent-sde: serve data-parallel over N local ranks "
                         "(spawned processes; gloo on the CPU or ranks sharing one card, "
                         "NCCL with a card a rank)")
    ap.add_argument("--latent-mode", choices=("prior", "posterior"), default="prior",
                    help="latent-sde: decode from the prior, or encode observations "
                         "and decode the posterior")
    ap.add_argument("--obs-len", type=int, default=9,
                    help="latent-sde posterior: observation points per request "
                         "(num_steps must be a multiple of obs_len - 1)")
    ap.add_argument("--stream-chunks", type=int, default=0,
                    help="sde-gan: stream the horizon in K time chunks (0/1 = whole "
                         "trajectories)")
    ap.add_argument("--adaptive", action="store_true",
                    help="sde-gan: adaptive terminal samples, rtol routed per "
                         "request deadline class")
    ap.add_argument("--atol", type=float, default=1e-6,
                    help="absolute tolerance of --adaptive")
    ap.add_argument("--scheduler", choices=("continuous", "fifo"), default=None,
                    help="sde-gan: drive the continuous-batching scheduler; 'fifo' runs "
                         "the same pooled steps, draining before each coalesce")
    ap.add_argument("--preempt", action="store_true",
                    help="scheduler: relaxed-class rollouts yield at chunk boundaries "
                         "while any lane has realtime-class work (bitwise invisible)")
    ap.add_argument("--pool-budget-mb", type=float, default=None,
                    help="scheduler: evict the coldest pool entries (CUDA graphs on the "
                         "card) once the pools exceed this many MB; rebuilt on reuse")
    ap.add_argument("--async-front", action="store_true",
                    help="scheduler: drive the drain through the asyncio front instead "
                         "of a direct step loop")
    ap.add_argument("--solver", default="reversible_heun",
                    help="fresh-init solver; restored bundles carry their own")
    ap.add_argument("--pallas", action="store_true",
                    help="fresh-init: the fused hot loop (phase-1 kernel draws ΔW, "
                         "phase-2 kernel); restored bundles carry their own")
    ap.add_argument("--sde-steps", type=int, default=None,
                    help="fresh-init solver steps (default 16)")
    ap.add_argument("--seed", type=int, default=0)
    # --workload lm: the transformer LM's prefill + greedy decode
    ap.add_argument("--arch", default="qwen2.5-14b",
                    help="lm: qwen2.5-14b, tinyllama-1.1b, starcoder2-3b, minicpm3-4b, "
                         "dbrx-132b, grok-1-314b, mamba2-1.3b, jamba-v0.1-52b or "
                         "pixtral-12b (seamless-m4t-medium, the encoder-decoder, is "
                         "refused)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="lm: the reduced config (the default, as in the reference)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="lm: the full config")
    args = ap.parse_args(argv)
    if args.host_devices is not None and args.host_devices > 1:
        if args.workload == "lm":
            ap.error("--host-devices: the LM's sharded execution is not ported yet — "
                     "ROADMAP.md Queue 1, 'Sharded LM execution'")
        from ..distributed.compat import run_cli_ranks

        return run_cli_ranks(main, argv, args.host_devices, args.device)
    if args.workload == "lm":
        return serve_lm(args.arch, args.batch, args.prompt_len, args.gen, args.smoke,
                        args.seed, device=args.device)
    return serve_sde(args.workload, args.ckpt_dir, max_batch=args.max_batch, requests=args.requests,
                     request_max=args.request_max, latent_mode=args.latent_mode,
                     stream_chunks=args.stream_chunks, adaptive=args.adaptive,
                     atol=args.atol, seed=args.seed, device=args.device, sde_steps=args.sde_steps,
                     pallas=args.pallas, obs_len=args.obs_len, scheduler=args.scheduler,
                     preempt=args.preempt, pool_budget_mb=args.pool_budget_mb,
                     async_front=args.async_front, solver=args.solver)


if __name__ == "__main__":
    main()
