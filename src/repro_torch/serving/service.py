"""The serving engine (port of :mod:`repro.serving.service`:
``_request_keys``, ``_coalesce``, ``_batch_loop``,
``_adaptive_terminal_loop`` and ``serve_sde``).

The reference AOT-compiles one program per bucket; the port runs eagerly,
so it runs one warm-up pass per bucket instead (the first pass builds the
CUDA kernels and initialises cuBLAS).  Requests drain FIFO: coalesced until
the next one would overflow the largest bucket, keys padded with
``PAD_SEED`` rows up to the nearest bucket.  Every row is a pure function
of its own key, so padding never changes a client's rows.

Ported: the Latent-SDE prior decode and the SDE-GAN generator's
fixed-grid rollout (:func:`_batch_loop`), and the SDE-GAN's adaptive
terminal sampling with deadline-routed tolerances
(:func:`_adaptive_terminal_loop`).  The posterior decode, streaming and
the continuous-batching scheduler raise :class:`ServingNotPortedError`
(ROADMAP.md Queue 1, 'The rest of serving').
"""

from __future__ import annotations

import collections
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..device import resolve_device
from ..kernels import prng
from ..launch.steps import SERVE_WORKLOADS
from .scheduler import serve_buckets
from .types import (DEADLINE_CLASSES, PAD_SEED, ServeResult, deadline_class_for,
                    percentile, route_rtol, synthetic_requests)

class ServingNotPortedError(NotImplementedError):
    """A serving workload or mode of the reference that the port lacks."""


def _config_class(workload: str):
    from ..core.sde import LatentSDEConfig, NeuralSDEConfig

    if workload not in SERVE_WORKLOADS:
        raise ValueError(f"workload must be one of {SERVE_WORKLOADS}, got {workload!r}")
    return NeuralSDEConfig if workload == "sde-gan" else LatentSDEConfig


def _fresh_cfg(workload: str, num_steps: Optional[int], pallas: bool):
    """The reference's fresh-init (``--smoke``) config of a workload."""
    num_steps = 16 if num_steps is None else num_steps
    if workload == "sde-gan":
        return _config_class(workload)(data_dim=1, hidden_dim=16, noise_dim=4, width=32,
                                       num_steps=num_steps, use_pallas_kernels=pallas)
    return _config_class(workload)(data_dim=2, hidden_dim=16, context_dim=16, width=32,
                                   num_steps=num_steps, use_pallas_kernels=pallas)


def _init_params(workload: str, cfg, seed: int):
    """Fresh parameters of a workload's bundle (the SDE-GAN serves its
    generator only), from a ``torch.Generator`` seeded with ``seed``."""
    from ..core.sde import generator_init, latent_sde_init

    gen = torch.Generator().manual_seed(seed)
    return (generator_init if workload == "sde-gan" else latent_sde_init)(gen, cfg)


def config_from_meta(workload: str, config: dict):
    """Rebuild the model config from a bundle's JSON dict."""
    cls = _config_class(workload)
    d = dict(config)
    d["dtype"] = getattr(torch, d.get("dtype", "float32"))
    try:
        return cls(**d)
    except TypeError as e:
        raise ValueError(f"serving bundle config does not match {cls.__name__} "
                         f"— written by an incompatible code version ({e})") from e


def restore_for_serving(workload: str, ckpt_dir, device):
    """Read a (JAX- or port-written) bundle -> ``(params, cfg, step)``."""
    tree, entry, step = ckpt.load_serving_bundle(ckpt_dir)
    if entry["workload"] != workload:
        raise ValueError(
            f"serving bundle under {ckpt_dir} was trained for workload "
            f"{entry['workload']!r}, not {workload!r}")
    cfg = config_from_meta(workload, entry["config"])
    return ckpt.params_from_jax(tree, device=device, dtype=cfg.dtype), cfg, step


def _request_keys(requests, pad_to: int, device) -> torch.Tensor:
    """``(pad_to, 2)`` keys of a coalesced batch: row ``j`` of a request is
    ``fold_in(PRNGKey(seed), j)``; padding rows come from ``PAD_SEED``.

    The rows' ``(seed, j)`` pairs are laid out on the host with numpy, copied
    to ``device`` in one transfer, and folded there in one batched
    ``fold_in`` — a fixed handful of device ops per batch, whatever the
    number of requests."""
    used = sum(r.size for r in requests)
    seeds = np.full(max(pad_to, used), PAD_SEED, dtype=np.int64)
    idx = np.arange(max(pad_to, used), dtype=np.int64)
    row = 0
    for r in requests:
        seeds[row:row + r.size] = r.seed
        idx[row:row + r.size] = np.arange(r.size)
        row += r.size
    idx[used:] -= used
    words = torch.from_numpy(np.stack([seeds >> 32, seeds & prng.MASK, idx])).to(device)
    return torch.stack(prng.fold_in(words[0], words[1], words[2]), -1)


def _coalesce(pending, cap: int):
    """Pop pending requests FIFO until the next one would overflow ``cap``."""
    batch, rows = [], 0
    while pending and rows + pending[0].size <= cap:
        r = pending.popleft()
        batch.append(r)
        rows += r.size
    return batch, rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _report(tag: str, stats: dict, total_rows: int, n_batches: int, latencies,
            wall: float, device: torch.device) -> None:
    tps = total_rows / max(wall, 1e-9)
    p50, p99 = percentile(latencies, 0.50), percentile(latencies, 0.99)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    stats.update(trajectories=total_rows, batches=n_batches, traj_per_s=tps,
                 p50_s=p50, p99_s=p99, device=name)
    print(f"[serve] {tag} on {name}: {total_rows} trajectories in {n_batches} "
          f"batches @ {tps:.1f} traj/s", flush=True)
    print(f"[serve] latency p50 {p50 * 1e3:.1f}ms p99 {p99 * 1e3:.1f}ms "
          f"(n={len(latencies)} requests, closed-loop)", flush=True)


def serve_sde(workload: str, ckpt_dir=None, max_batch: int = 16,
              requests: int = 12, request_max: int = 4, latent_mode: str = "prior",
              stream_chunks: int = 0, adaptive: bool = False, atol: float = 1e-6,
              seed: int = 0, device=None, sde_steps: Optional[int] = None,
              pallas: bool = False, collect: bool = False) -> dict:
    """Run the trajectory-sampling service; return the stats it prints.

    ``device=None`` serves on the card and raises
    :class:`~repro_torch.NoCudaDeviceError` without one; ``device="cpu"``
    runs the plain versions on the CPU.  Without ``ckpt_dir``, a
    fresh model (``torch.Generator`` seeded with ``seed``; ``sde_steps`` and
    ``pallas`` shape its config) is written to a throwaway bundle and
    restored from it, the path a trained checkpoint takes.  ``adaptive``
    serves SDE-GAN terminal samples at deadline-routed tolerances
    (absolute tolerance ``atol``).  ``collect`` keeps every request's
    output on the CPU under ``stats["samples"][rid]``: trajectories
    ``(num_steps+1, size, data_dim)``, or terminal samples ``(size,
    data_dim)``.
    """
    _config_class(workload)
    if adaptive and workload != "sde-gan":
        raise ValueError(
            "--adaptive serves terminal samples from the SDE-GAN generator; "
            "the latent-sde decoders serve whole trajectories, which have no "
            "fixed output grid under adaptive stepping")
    if adaptive and stream_chunks > 1:
        raise ValueError(
            "--adaptive and --stream-chunks are mutually exclusive: "
            "streaming emits a fixed per-chunk grid, adaptive solving "
            "chooses its own")
    if stream_chunks > 1:
        raise ServingNotPortedError(
            "--stream-chunks (the chunked long-horizon rollout) is not ported yet "
            "— ROADMAP.md Queue 1, 'The rest of serving'")
    if latent_mode != "prior":
        raise ServingNotPortedError(
            f"latent_mode={latent_mode!r} is not ported yet (the port serves the "
            f"prior decode; the posterior decode needs the encoder — "
            f"ROADMAP.md Queue 1, 'The rest of serving')")
    if requests < 1 or request_max < 1:
        raise ValueError(f"requests ({requests}) and request_max ({request_max}) "
                         f"must both be >= 1")
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="repro-torch-serve-") as tmp:
        if ckpt_dir is None:
            ckpt_dir = tmp
            cfg = _fresh_cfg(workload, sde_steps, pallas)
            ckpt.save_serving_bundle(ckpt_dir, 0, _init_params(workload, cfg, seed),
                                     workload, cfg)
            print(f"[serve] fresh {workload} bundle (seed {seed})", flush=True)
        params, cfg, step = restore_for_serving(workload, ckpt_dir, dev)
    print(f"[serve] restored {workload} serving bundle (train step {step}, "
          f"solver={cfg.solver}, num_steps={cfg.num_steps}, "
          f"fused={cfg.use_pallas_kernels}, device={dev})", flush=True)
    buckets = serve_buckets(max_batch)
    stats = {"workload": workload, "restored_step": step, "buckets": buckets}
    request_max = min(request_max, buckets[-1])
    if adaptive:
        _adaptive_terminal_loop(cfg, params, buckets, requests, request_max, atol, seed,
                                stats, dev, collect)
    else:
        _batch_loop(workload, cfg, params, buckets, requests, request_max, latent_mode,
                    seed, stats, dev, collect)
    return stats


def _batch_loop(workload, cfg, params, buckets, requests, request_max, latent_mode,
                seed, stats, device, collect=False):
    from ..launch.steps import make_sample_step

    sampler = make_sample_step(workload, cfg, latent_mode=latent_mode, device=device)
    for b in buckets:  # warm-up pass per bucket, in place of AOT compiles
        t0 = time.perf_counter()
        sampler(params, _request_keys([], b, device))
        _sync(device)
        print(f"[serve] warmed bucket {b} in {time.perf_counter() - t0:.2f}s", flush=True)

    pending = synthetic_requests(requests, request_max, seed)
    latencies, total_rows, n_batches, samples = [], 0, 0, {}
    t_start = time.perf_counter()
    while pending:
        batch, rows = _coalesce(pending, buckets[-1])
        bucket = next(b for b in buckets if b >= rows)
        ys = sampler(params, _request_keys(batch, bucket, device))
        _sync(device)
        t_now = time.perf_counter()
        if collect:
            ys_cpu, i = ys.cpu(), 0
            for r in batch:
                samples[r.rid] = ys_cpu[:, i:i + r.size]
                i += r.size
        latencies += [t_now - t_start] * len(batch)  # closed-loop: all at t0
        total_rows += rows
        n_batches += 1
    wall = time.perf_counter() - t_start
    _report(workload + (f"/{latent_mode}" if workload == "latent-sde" else ""), stats,
            total_rows, n_batches, latencies, wall, device)
    if collect:
        stats["samples"] = samples


def _adaptive_terminal_loop(cfg, params, buckets, requests, request_max, atol, seed,
                            stats, device, collect=False):
    """Terminal sampling per deadline class (DESIGN.md §10/§11).

    Requests are grouped by deadline class, tightest first, and coalesced
    FIFO within a class; each batch runs at :func:`route_rtol`'s tolerance
    (the loosest its tightest deadline allows).  One sampler serves every
    tolerance: ``rtol`` is an argument, not part of the warm-up.  Rows
    that ran out of step budget come back ``converged=False`` on their
    request's :class:`ServeResult` and are counted."""
    from ..launch.steps import make_adaptive_terminal_step

    sampler = make_adaptive_terminal_step(cfg, atol=atol, device=device)
    # The warm-up pays first-use costs only (kernel builds, BLAS set-up): one
    # controller iteration per bucket runs every op of the loop.
    warm = make_adaptive_terminal_step(cfg, atol=atol, max_steps=1, device=device)
    warm_rtol = DEADLINE_CLASSES[0].rtol
    warmup_iterations = []
    for b in buckets:  # warm-up pass per bucket, one loop iteration each
        t0 = time.perf_counter()
        warmup_iterations.append(warm(params, _request_keys([], b, device),
                                      warm_rtol)[2].iterations)
        _sync(device)
        print(f"[serve] warmed adaptive bucket {b} in {time.perf_counter() - t0:.2f}s "
              f"(rtol {warm_rtol}, {warmup_iterations[-1]} loop iterations)", flush=True)

    by_class = {c.name: collections.deque() for c in DEADLINE_CLASSES}
    for r in synthetic_requests(requests, request_max, seed, adaptive=True):
        by_class[deadline_class_for(r.deadline_ms).name].append(r)

    results, latencies, samples, per_class, batch_log = [], [], {}, {}, []
    total_rows, n_batches, non_converged = 0, 0, 0
    t_start = time.perf_counter()
    for cls_name, pending in by_class.items():
        cls_lat, cls_rows, t_cls = [], 0, time.perf_counter()
        while pending:
            batch, rows = _coalesce(pending, buckets[-1])
            bucket = next(b for b in buckets if b >= rows)
            batch_rtol = route_rtol(batch)
            ys, conv, bstats = sampler(params, _request_keys(batch, bucket, device),
                                       batch_rtol)
            _sync(device)
            t_now = time.perf_counter()
            conv = conv.cpu()
            ys_cpu = ys.cpu() if collect else None
            i = 0
            for r in batch:
                results.append(ServeResult(
                    rid=r.rid, size=r.size,
                    converged=conv[i:i + r.size].tolist(), latency_s=t_now - t_start,
                    deadline_ms=r.deadline_ms, rtol=batch_rtol))
                if collect:
                    samples[r.rid] = ys_cpu[i:i + r.size]
                i += r.size
            # a non-converged real row is a sample at t_final < t1, not Y_T
            non_converged += int((~conv[:rows]).sum())
            batch_log.append(dict(deadline_class=cls_name, rows=rows, bucket=bucket,
                                  rtol=batch_rtol, iterations=bstats.iterations))
            cls_lat += [t_now - t_start] * len(batch)
            cls_rows += rows
            n_batches += 1
        if cls_lat:
            wall = time.perf_counter() - t_cls
            per_class[cls_name] = dict(rows=cls_rows, traj_per_s=cls_rows / max(wall, 1e-9),
                                       p50_s=percentile(cls_lat, 0.50),
                                       p99_s=percentile(cls_lat, 0.99))
            print(f"[serve] class {cls_name}: {cls_rows} rows @ "
                  f"{per_class[cls_name]['traj_per_s']:.1f} traj/s, latency p50 "
                  f"{per_class[cls_name]['p50_s'] * 1e3:.1f}ms p99 "
                  f"{per_class[cls_name]['p99_s'] * 1e3:.1f}ms", flush=True)
        latencies += cls_lat
        total_rows += cls_rows
    wall = time.perf_counter() - t_start
    _report("sde-gan/adaptive", stats, total_rows, n_batches, latencies, wall, device)
    rtols = sorted({b["rtol"] for b in batch_log})
    stats.update(rtols_served=rtols, classes_served=list(per_class), per_class=per_class,
                 batch_log=batch_log, warmup_iterations=warmup_iterations,
                 non_converged=non_converged, results=results)
    print(f"[serve] adaptive: {len(rtols)} distinct tolerances over {len(per_class)} "
          f"deadline classes; loop iterations per batch "
          f"{[b['iterations'] for b in batch_log]}", flush=True)
    if non_converged:
        print(f"[serve] WARNING: {non_converged}/{total_rows} rows exhausted the "
              f"adaptive step budget before t1 (served state is at t_final < t1) — "
              f"marked converged=False on their ServeResult; raise max_steps or "
              f"loosen the tolerance", flush=True)
    if collect:
        stats["samples"] = samples
