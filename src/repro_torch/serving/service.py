"""The serving driver for the Latent-SDE prior decode (port of
:mod:`repro.serving.service`: ``_request_keys``, ``_coalesce``,
``_batch_loop`` and ``serve_sde``).

The reference AOT-compiles one program per bucket; the port runs eagerly,
so it runs one warm-up pass per bucket instead (the first pass builds the
CUDA kernels and initialises cuBLAS).  Requests drain FIFO: coalesced until
the next one would overflow the largest bucket, keys padded with
``PAD_SEED`` rows up to the nearest bucket.  Every row is a pure function
of its own key, so padding never changes a client's rows.

Ported: ``workload="latent-sde"`` with ``latent_mode="prior"``.  The
SDE-GAN workload, the posterior decode, adaptive terminal sampling,
streaming and the continuous-batching scheduler raise
:class:`ServingNotPortedError` (ROADMAP.md Queue 1, item 12).
"""

from __future__ import annotations

import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..device import resolve_device
from ..kernels import prng
from .scheduler import serve_buckets
from .types import PAD_SEED, percentile, synthetic_requests


class ServingNotPortedError(NotImplementedError):
    """A serving workload or mode of the reference that the port lacks."""


def _fresh_cfg(num_steps: Optional[int], pallas: bool):
    """The reference's fresh-init (``--smoke``) config for latent-sde."""
    from ..core.sde import LatentSDEConfig

    return LatentSDEConfig(
        data_dim=2, hidden_dim=16, context_dim=16, width=32,
        num_steps=16 if num_steps is None else num_steps, use_pallas_kernels=pallas)


def config_from_meta(workload: str, config: dict):
    """Rebuild the model config from a bundle's JSON dict."""
    from ..core.sde import LatentSDEConfig

    if workload != "latent-sde":
        raise ServingNotPortedError(
            f"workload {workload!r} is not ported yet (the port serves "
            f"'latent-sde'); see ROADMAP.md Queue 1, item 7 and 12")
    d = dict(config)
    d["dtype"] = getattr(torch, d.get("dtype", "float32"))
    try:
        return LatentSDEConfig(**d)
    except TypeError as e:
        raise ValueError(f"serving bundle config does not match LatentSDEConfig "
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
              seed: int = 0, device=None, sde_steps: Optional[int] = None,
              pallas: bool = False, collect: bool = False) -> dict:
    """Run the trajectory-sampling service; return the stats it prints.

    ``device=None`` serves on the card and raises
    :class:`~repro_torch.NoCudaDeviceError` without one; ``device="cpu"``
    runs the plain versions on the CPU.  Without ``ckpt_dir``, a
    fresh model (``torch.Generator`` seeded with ``seed``; ``sde_steps`` and
    ``pallas`` shape its config) is written to a throwaway bundle and
    restored from it, the path a trained checkpoint takes.  ``collect``
    keeps every request's trajectories, ``(num_steps+1, size, data_dim)`` on
    the CPU, under ``stats["samples"][rid]``.
    """
    from ..core.sde import latent_sde_init

    dev = resolve_device(device)
    if workload != "latent-sde":
        raise ServingNotPortedError(
            f"serve_sde serves 'latent-sde' in the port so far, got {workload!r} "
            f"(sde-gan: ROADMAP.md Queue 1, items 7 and 12)")
    if latent_mode != "prior":
        raise ServingNotPortedError(
            f"latent_mode={latent_mode!r} is not ported yet (the port serves the "
            f"prior decode; the posterior decode needs the encoder — ROADMAP.md "
            f"Queue 1, items 6 and 12)")
    if requests < 1 or request_max < 1:
        raise ValueError(f"requests ({requests}) and request_max ({request_max}) "
                         f"must both be >= 1")
    with tempfile.TemporaryDirectory(prefix="repro-torch-serve-") as tmp:
        if ckpt_dir is None:
            ckpt_dir = tmp
            cfg = _fresh_cfg(sde_steps, pallas)
            gen = torch.Generator().manual_seed(seed)
            ckpt.save_serving_bundle(ckpt_dir, 0, latent_sde_init(gen, cfg), workload, cfg)
            print(f"[serve] fresh {workload} bundle (seed {seed})", flush=True)
        params, cfg, step = restore_for_serving(workload, ckpt_dir, dev)
    print(f"[serve] restored {workload} serving bundle (train step {step}, "
          f"solver={cfg.solver}, num_steps={cfg.num_steps}, "
          f"fused={cfg.use_pallas_kernels}, device={dev})", flush=True)
    buckets = serve_buckets(max_batch)
    stats = {"workload": workload, "restored_step": step, "buckets": buckets}
    _batch_loop(workload, cfg, params, buckets, requests, min(request_max, buckets[-1]),
                latent_mode, seed, stats, dev, collect)
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
    _report(f"{workload}/{latent_mode}", stats, total_rows, n_batches, latencies,
            wall, device)
    if collect:
        stats["samples"] = samples
