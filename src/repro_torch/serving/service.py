"""The serving engine (port of :mod:`repro.serving.service`:
``_request_keys``, ``_coalesce``, ``_batch_loop``,
``_adaptive_terminal_loop``, ``_stream_loop``, ``_scheduler_loop``,
``_drain_async`` and ``serve_sde``).

The reference AOT-compiles one program per bucket; the drain loops here run
eagerly, so they run one warm-up pass per bucket instead (the first pass
builds the CUDA kernels and initialises cuBLAS).  The continuous-batching
scheduler pools its steps in a :class:`~repro_torch.serving.ModelRegistry`,
as CUDA graphs on the card.  Requests drain FIFO: coalesced until the next
one would overflow the largest bucket, keys padded with ``PAD_SEED`` rows
up to the nearest bucket.  Every row is a pure function of its own key, so
padding never changes a client's rows.

Under a process group of several ranks (the serve CLI's ``--host-devices
N``) the buckets are ``N`` × powers of two and every loop runs on every
rank: each bucket's rows split evenly over the ranks, each rank samples its
own through its own steps (CUDA-graph pools on the card), and the rows are
gathered whole (:func:`repro_torch.distributed.sharding.gather_rows`,
bitwise); rank 0 answers.  The scheduler's rank 0 drives and the others
follow it (:meth:`Scheduler.follow`).  By the padding invariance every row
is the one-rank service's, bitwise.

The loops: :func:`_batch_loop` (the Latent SDE's prior and posterior
decodes and the SDE-GAN generator's fixed-grid rollout),
:func:`_adaptive_terminal_loop` (SDE-GAN terminal samples at
deadline-routed tolerances), :func:`_stream_loop` (the generator's rollout
emitted in time chunks) and :func:`_scheduler_loop` (the
:class:`~repro_torch.serving.Scheduler`, directly or through the
:class:`~repro_torch.serving.AsyncFrontend`).
"""

from __future__ import annotations

import collections
import contextlib
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..device import resolve_device
from ..distributed import compat
from ..kernels import prng
from .registry import (LoadedModel, ModelRegistry, _config_class, _init_params,
                       restore_for_serving)
from .scheduler import _CHUNK_FOLD, Scheduler, _keys, latency_summary, serve_buckets
from .types import (DEADLINE_CLASSES, PAD_SEED, ServeResult, deadline_class_for,
                    percentile, route_rtol, synthetic_requests)

#: The reference's stable private name for the percentile helper.
_percentile = percentile


def _fresh_cfg(workload: str, num_steps: Optional[int], pallas: bool,
               solver: str = "reversible_heun"):
    """The reference's fresh-init (``--smoke``) config of a workload."""
    num_steps = 16 if num_steps is None else num_steps
    kw = dict(num_steps=num_steps, solver=solver, exact_adjoint=solver == "reversible_heun",
              use_pallas_kernels=pallas)
    if workload == "sde-gan":
        return _config_class(workload)(data_dim=1, hidden_dim=16, noise_dim=4, width=32, **kw)
    return _config_class(workload)(data_dim=2, hidden_dim=16, context_dim=16, width=32, **kw)


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
    return _keys(seeds, idx, device)


def _warm_buckets(run, buckets, device, tag: str = "") -> None:
    """One warm-up pass per bucket, in place of the reference's AOT compiles:
    ``run(keys)`` on a bucket of padding keys pays first-use costs (kernel
    builds, cuBLAS set-up) before the clock starts.  A string that ``run``
    returns is a note for the bucket's line."""
    for b in buckets:
        t0 = time.perf_counter()
        note = run(_request_keys([], b, device))
        _sync(device)
        print(f"[serve] warmed {tag}bucket {b} in {time.perf_counter() - t0:.2f}s"
              + (f" ({note})" if isinstance(note, str) else ""), flush=True)


def _compile_pool(sampler, params, buckets, *example_args, tag: str = "", device=None):
    """The reference's ``{bucket: program}`` pool: ``sampler`` warmed at every
    bucket by :func:`_warm_buckets`, and serving each.  ``example_args``:
    operands after ``(params, keys)``, e.g. the adaptive sampler's rtol."""
    _warm_buckets(lambda keys: sampler(params, keys, *example_args), buckets,
                  resolve_device(device), tag)
    return {b: sampler for b in buckets}


def _rank_rows(fn, dims):
    """``fn(params, keys, *rest)`` run on this rank's rows of ``keys`` under
    the active data-parallel mesh, each tensor output gathered whole along
    its entry of ``dims`` (a bare tensor output: ``dims[0]``); an
    ``AdaptiveStats`` output keeps its loop iterations, the ranks' most.
    ``fn`` itself without a mesh."""
    from ..distributed import sharding

    if sharding.dp_world() == 1:
        return fn

    def run(params, keys, *rest):
        out = fn(params, sharding.shard_rows(keys, 0), *rest)
        if isinstance(out, torch.Tensor):
            return sharding.gather_rows(out, dims[0])
        whole = [sharding.gather_rows(o, d) for o, d in zip(out, dims)]
        for extra in out[len(dims):]:
            whole.append(extra._replace(iterations=sharding.global_max(extra.iterations)))
        return tuple(whole)

    return run


def _serving_mesh(max_batch: int):
    """The data-parallel mesh over the process group's ranks, or None (one
    rank, or a largest bucket smaller than the rank count, which serves
    unsharded as the reference does)."""
    from ..distributed.sharding import data_parallel_mesh

    mesh = data_parallel_mesh()
    if mesh is not None and max_batch < mesh.size:
        print(f"[serve] --max-batch {max_batch} < {mesh.size} devices — serving "
              f"unsharded", flush=True)
        mesh = None
    return mesh


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
              pallas: bool = False, collect: bool = False, obs_len: int = 9,
              scheduler: Optional[str] = None, preempt: bool = False,
              pool_budget_mb: Optional[float] = None, async_front: bool = False,
              solver: str = "reversible_heun") -> dict:
    """Run the trajectory-sampling service; return the stats it prints.

    ``device=None`` serves on the card and raises
    :class:`~repro_torch.NoCudaDeviceError` without one; ``device="cpu"``
    runs the plain versions on the CPU.  Without ``ckpt_dir``, a fresh model
    (``torch.Generator`` seeded with ``seed``; ``sde_steps``, ``pallas`` and
    ``solver`` shape its config) is written to a throwaway bundle and
    restored from it, the path a trained checkpoint takes.

    Modes, as the reference's: ``latent_mode="posterior"`` encodes
    ``obs_len`` stand-in observations per row and decodes the posterior;
    ``stream_chunks`` > 1 emits the SDE-GAN rollout in that many time
    chunks; ``adaptive`` serves SDE-GAN terminal samples at deadline-routed
    tolerances (absolute tolerance ``atol``); ``scheduler`` (``"continuous"``
    or ``"fifo"``) drives the continuous-batching scheduler, with
    ``preempt``, ``pool_budget_mb`` (the pool's LRU budget) and
    ``async_front`` (the drain through the asyncio front) riding on it.
    ``collect`` keeps every request's output on the CPU under
    ``stats["samples"][rid]``: trajectories ``(num_steps+1, size,
    data_dim)``, or terminal samples ``(size, data_dim)``.
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
    if scheduler is not None and workload != "sde-gan":
        raise ValueError(
            "--scheduler drives the continuous-batching chunked rollout, which is "
            "the SDE-GAN generator's carry machinery; latent-sde serves through "
            "the coalescing loop")
    if scheduler is None and (preempt or pool_budget_mb is not None or async_front):
        opts = [n for n, on in (("--preempt", preempt),
                                ("--pool-budget-mb", pool_budget_mb is not None),
                                ("--async-front", async_front)) if on]
        raise ValueError(f"{', '.join(opts)} require the continuous-batching path — "
                         f"pass --scheduler continuous (or fifo)")
    if pool_budget_mb is not None and pool_budget_mb <= 0:
        raise ValueError(f"--pool-budget-mb must be positive, got {pool_budget_mb}")
    if requests < 1 or request_max < 1:
        raise ValueError(f"requests ({requests}) and request_max ({request_max}) "
                         f"must both be >= 1")
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="repro-torch-serve-") as tmp:
        if ckpt_dir is None:
            ckpt_dir = tmp
            cfg = _fresh_cfg(workload, sde_steps, pallas, solver)
            ckpt.save_serving_bundle(ckpt_dir, 0, _init_params(workload, cfg, seed),
                                     workload, cfg)
            print(f"[serve] fresh {workload} bundle (seed {seed})", flush=True)
        params, cfg, step = restore_for_serving(workload, ckpt_dir, dev)
    print(f"[serve] restored {workload} serving bundle (train step {step}, "
          f"solver={cfg.solver}, num_steps={cfg.num_steps}, "
          f"fused={cfg.use_pallas_kernels}, device={dev})", flush=True)
    mesh = _serving_mesh(max_batch)
    n_dev = 1 if mesh is None else mesh.size
    buckets = serve_buckets(max_batch, n_dev)
    stats = {"workload": workload, "restored_step": step, "buckets": buckets,
             "devices": n_dev}
    request_max = min(request_max, buckets[-1])
    with compat.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        if mesh is not None:
            print(f"[serve] data-parallel over {n_dev} devices ({compat.backend_note(dev)})",
                  flush=True)
        if scheduler is not None:
            _scheduler_loop(cfg, params, buckets, requests, request_max, scheduler, seed,
                            stats, dev, preempt=preempt, pool_budget_mb=pool_budget_mb,
                            async_front=async_front, collect=collect, shard_base=n_dev)
        elif adaptive:
            _adaptive_terminal_loop(cfg, params, buckets, requests, request_max, atol, seed,
                                    stats, dev, collect)
        elif stream_chunks > 1:
            _stream_loop(workload, cfg, params, buckets, requests, request_max,
                         stream_chunks, seed, stats, dev, collect)
        else:
            _batch_loop(workload, cfg, params, buckets, requests, request_max, latent_mode,
                        obs_len, seed, stats, dev, collect)
    return stats


def _batch_loop(workload, cfg, params, buckets, requests, request_max, latent_mode,
                obs_len, seed, stats, device, collect=False):
    from ..launch.steps import make_sample_step

    sampler = _rank_rows(make_sample_step(workload, cfg, latent_mode=latent_mode,
                                          obs_len=obs_len, device=device), (1,))
    _warm_buckets(lambda keys: sampler(params, keys), buckets, device)
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

    sampler = _rank_rows(make_adaptive_terminal_step(cfg, atol=atol, device=device), (0, 0))
    # The warm-up pays first-use costs only (kernel builds, BLAS set-up): one
    # controller iteration per bucket runs every op of the loop.
    warm = _rank_rows(make_adaptive_terminal_step(cfg, atol=atol, max_steps=1, device=device),
                      (0, 0))
    warm_rtol = DEADLINE_CLASSES[0].rtol
    warmup_iterations = []

    def warm_once(keys):
        warmup_iterations.append(warm(params, keys, warm_rtol)[2].iterations)
        return f"rtol {warm_rtol}, {warmup_iterations[-1]} loop iterations"

    _warm_buckets(warm_once, buckets, device, "adaptive ")

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
                    rid=r.rid, model_id=r.model_id, size=r.size,
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


def _stream_loop(workload, cfg, params, buckets, requests, request_max, stream_chunks,
                 seed, stats, device, collect=False):
    """Long-horizon streaming: each batch's trajectories emitted in
    ``stream_chunks`` time chunks, chunk ``c`` keyed ``fold_in(key, 1000 +
    c)`` per row and carried from the last (the first chunk's latency, not
    the whole horizon's, is what a client waits for)."""
    from ..core.sde import generator_initial_state
    from ..distributed import sharding
    from ..launch.steps import make_stream_chunk_step

    if workload != "sde-gan":
        raise ValueError("--stream-chunks streams the SDE-GAN generator rollout; the "
                         "latent decoder serves whole trajectories")
    if cfg.num_steps % stream_chunks != 0:
        raise ValueError(f"--stream-chunks ({stream_chunks}) must divide the solver "
                         f"horizon num_steps ({cfg.num_steps}) so chunks share a grid")
    span = cfg.t1 / stream_chunks
    steps_per_chunk = cfg.num_steps // stream_chunks
    chunk = make_stream_chunk_step(cfg, span, steps_per_chunk, device=device)

    def rollout(keys, emit=None):
        keys = sharding.shard_rows(keys, 0)  # this rank's rows (all without a mesh)
        x = generator_initial_state(params, cfg, keys)
        for c in range(stream_chunks):
            ys_c, x = chunk(params, prng.fold_in_key(keys, _CHUNK_FOLD + c), x, c * span)
            ys_c = sharding.gather_rows(ys_c, 1)
            _sync(device)  # "emitted" to the client here
            if emit is not None:
                emit(c, ys_c)

    _warm_buckets(rollout, buckets, device, "stream ")

    pending = synthetic_requests(requests, request_max, seed)
    latencies, first_chunk_ms, total_rows, n_batches, samples = [], [], 0, 0, {}
    t_start = time.perf_counter()
    while pending:
        batch, rows = _coalesce(pending, buckets[-1])
        bucket = next(b for b in buckets if b >= rows)
        pieces = []
        t_batch0 = time.perf_counter()

        def emit(c, ys_c):
            if c == 0:
                first_chunk_ms.append((time.perf_counter() - t_batch0) * 1e3)
            if collect:  # a later chunk's entry row is the previous chunk's last
                pieces.append(ys_c.cpu() if c == 0 else ys_c[1:].cpu())

        rollout(_request_keys(batch, bucket, device), emit)
        t_now = time.perf_counter()
        if collect:
            ys, i = torch.cat(pieces), 0
            for r in batch:
                samples[r.rid] = ys[:, i:i + r.size]
                i += r.size
        latencies += [t_now - t_start] * len(batch)
        total_rows += rows
        n_batches += 1
    wall = time.perf_counter() - t_start
    _report(f"sde-gan/stream×{stream_chunks}", stats, total_rows, n_batches, latencies,
            wall, device)
    stats["first_chunk_ms"] = sum(first_chunk_ms) / len(first_chunk_ms)
    print(f"[serve] stream: mean first-chunk latency {stats['first_chunk_ms']:.1f}ms "
          f"({steps_per_chunk}/{cfg.num_steps} steps per chunk)", flush=True)
    if collect:
        stats["samples"] = samples


def _scheduler_loop(cfg, params, buckets, requests, request_max, mode, seed, stats,
                    device, preempt: bool = False, pool_budget_mb: Optional[float] = None,
                    async_front: bool = False, collect: bool = False, shard_base: int = 1):
    """Drive the continuous-batching :class:`Scheduler` over the synthetic
    stream (closed loop: every request arrives as the drain starts, after
    the pool's builds — the reference stamps the scheduler's construction,
    so its latencies carry its compiles).  With
    ``async_front`` the stream goes through :class:`AsyncFrontend` — one
    ``submit`` coroutine per request — instead of a direct ``step`` loop.
    The stats carry the registry's pool (keys, bytes, evictions, builds) and
    the launches its graph replays made.  With ``shard_base > 1`` rank 0
    drives the drain and the other ranks follow it."""
    budget = None if pool_budget_mb is None else int(pool_budget_mb * 2 ** 20)
    registry = ModelRegistry(pool_budget_bytes=budget)
    registry.register(LoadedModel("default", "sde-gan", cfg, params))
    chunks = 4 if cfg.num_steps % 4 == 0 else 1
    sched = Scheduler(registry, max_batch=buckets[-1], chunks=chunks, mode=mode,
                      preempt=preempt, collect=collect, shard_base=shard_base)
    sched.warm("default")
    if compat.rank() != 0 and shard_base > 1:
        sched.follow()
        return
    pending = synthetic_requests(requests, request_max, seed)
    t_start = time.perf_counter()
    arrival = sched.now()  # every request arrives as the drain starts, after the builds
    if async_front:
        results, n_iter = _drain_async(sched, pending, arrival)
    else:
        for r in pending:
            sched.submit(r, arrival_s=arrival)
        results, n_iter = [], 0
        while sched.busy:
            results += sched.step()
            n_iter += 1
    sched.close()
    wall = time.perf_counter() - t_start
    _report(f"sde-gan/scheduler-{mode}×{chunks}chunks", stats,
            sum(r.size for r in results), n_iter, [r.latency_s for r in results], wall,
            device)
    stats.update(latency_summary(results), scheduler=mode, chunks=chunks, preempt=preempt,
                 frontend="asyncio" if async_front else "direct",
                 counters=dict(sched.counters), pool_keys=registry.pool_keys(),
                 pool_bytes=registry.pool_bytes(), pool_evictions=registry.evictions,
                 pool_builds=registry.compiles,
                 replay_launches=dict(registry.replay_launches))
    if budget is not None:
        stats["pool_budget_bytes"] = budget
        print(f"[serve] pool budget {pool_budget_mb:g} MB: {registry.pool_bytes()} B "
              f"resident, {registry.evictions} evictions", flush=True)
    print(f"[serve] scheduler: mode={mode}, {len(results)} requests, "
          f"pools={len(registry.pool_keys('default'))} entries (chunk t_start per row — "
          f"admission at chunk boundaries)", flush=True)
    if collect:
        stats["samples"] = {r.rid: r.samples for r in results}


def _drain_async(sched, pending, arrival_s: float = 0.0):
    """Closed-loop drain over the asyncio front: one ``submit`` coroutine per
    request (all stamped ``arrival_s``), gathered -> ``(results, engine
    iterations)``."""
    import asyncio

    from .frontend import AsyncFrontend

    async def drive():
        front = AsyncFrontend(sched)
        await front.start()
        try:
            results = await asyncio.gather(*(front.submit(r, arrival_s=arrival_s)
                                              for r in pending))
        finally:
            await front.close()
        return list(results), front.steps

    return asyncio.run(drive())
