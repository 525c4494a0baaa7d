"""The continuous-batching scheduler (port of :mod:`repro.serving.scheduler`:
``serve_buckets``, ``_InFlight``, ``_Row``, ``_Lane``, ``Scheduler``,
``run_open_loop``, ``latency_summary`` and ``class_latency_summary``).

Iteration-level scheduling over the chunked rollout: a long-horizon
trajectory advances chunk by chunk through one pool entry per ``(model_id,
bucket)`` — a captured CUDA graph on the card
(:mod:`repro_torch.serving.registry`) — whose ``t_start`` is a per-row
tensor, so rows at different horizon positions share a batch, and newly
admitted requests join the batch in flight at the next chunk boundary.

Admission: free slots = largest bucket − rows in flight; pending rollouts
are admitted in arrival order (head of line, no skipping) while slots are
free.  ``mode="fifo"`` admits only when the lane has drained, with the same
pool entries, so the two modes differ only in when admission happens.

Keying, exactly the reference's: row ``j`` of a request has the base key
``fold_in(PRNGKey(seed), j)`` and its chunk ``c`` the key ``fold_in(base,
1000 + c)`` (``_CHUNK_FOLD``, the stream loop's constant); padding rows
are ``fold_in(PRNGKey(PAD_SEED), offset + i)`` (``_pad_keys``).  Every row
is a pure function of ``(params, seed, row, chunk index)``, so joining
mid-flight, being preempted and resuming, and fifo against continuous are
all bitwise invisible to a trajectory (tests/test_torch_scheduler.py).

Adaptive terminal requests ride the same scheduler: coalesced within one
deadline class per iteration, each batch at the tolerance
:func:`~repro_torch.serving.route_rtol` picks, through one eager entry per
``(model_id, bucket)`` (rtol is an argument).

Per-model admission quotas cap a model's rows in flight (an int for every
model, a ``{model_id: int}`` dict, or the bundle's ``serving`` hint).  With
``preempt=True``, while any lane has realtime-class work pending or in
flight, every other lane's relaxed-class rollout rows pause at their next
chunk boundary (carrying their state and chunk index) and its
relaxed-class terminal batches wait; paused rows resume once the pressure
clears.

Data parallelism (``shard_base = W > 1``, under a process group of ``W``
ranks): the buckets are ``W`` × powers of two, rank 0 alone admits
requests, keeps the lanes and quotas and preempts, and every pooled call
(a batch's initial states, a chunk, a terminal batch) is broadcast to the
other ranks, which wait in :meth:`Scheduler.follow`: the per-row keys,
states and times go out, each rank steps its ``bucket / W`` rows through
its own pool entry at that local bucket (its own CUDA graphs on the card),
and the rows are gathered back (:mod:`repro_torch.distributed.sharding`),
bitwise the one-rank drain by the padding invariance.  Rank 0 ends the
followers with :meth:`Scheduler.close`.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..kernels import prng
from .registry import ModelRegistry, capture_or_eager, eager_peak
from .types import (DEADLINE_CLASSES, PAD_SEED, Request, ServeResult, deadline_class_for,
                    percentile, route_rtol)

#: Chunk-key fold offset: the stream loop's constant, so scheduler rollouts
#: are bitwise the streamed rollouts.
_CHUNK_FOLD = 1000


def serve_buckets(max_batch: int, shard_base: int = 1) -> list:
    """Bucket sizes: ``shard_base`` × powers of two, up to ``max_batch``.

    The largest bucket caps how many rows one coalesced batch may hold — the
    scheduler's admission slot grid."""
    sizes = []
    b = max(shard_base, 1)
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    if not sizes:
        raise ValueError(
            f"--max-batch {max_batch} is below the shard base {shard_base}; "
            f"the smallest servable bucket is one row per device")
    return sizes


def _keys(seeds, rows, device, chunks=None) -> torch.Tensor:
    """``(n, 2)`` keys ``fold_in(PRNGKey(seeds[i]), rows[i])``, then folded by
    ``_CHUNK_FOLD + chunks[i]`` where ``chunks[i] >= 0`` (padding rows carry
    −1: their key is the base key).  Laid out on the host, one copy to the
    device, folded there in one batched pass."""
    seeds = np.asarray(seeds, np.int64)
    words = np.stack([seeds >> 32, seeds & prng.MASK, np.asarray(rows, np.int64)])
    if chunks is not None:
        words = np.concatenate([words, np.asarray(chunks, np.int64)[None]])
    w = torch.from_numpy(words).to(device)
    k1, k2 = prng.fold_in(w[0], w[1], w[2])
    if chunks is not None:
        c1, c2 = prng.fold_in(k1, k2, w[3] + _CHUNK_FOLD)
        real = w[3] >= 0
        k1, k2 = torch.where(real, c1, k1), torch.where(real, c2, k2)
    return torch.stack([k1, k2], -1)


def _device(model) -> torch.device:
    return model.params["ell"]["w"].device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _InFlight:
    """Book-keeping for one admitted request."""

    def __init__(self, request: Request, arrival_s: float):
        self.request = request
        self.arrival_s = arrival_s
        self.rows_left = request.size
        self.chunks: dict = {}  # j -> [(steps, data_dim) CPU tensors]


class _Row:
    """One in-flight trajectory row: its request, row index, carried hidden
    state and the chunks it has completed."""

    __slots__ = ("flight", "j", "x", "chunk_idx")

    def __init__(self, flight: _InFlight, j: int, x):
        self.flight = flight
        self.j = j
        self.x = x
        self.chunk_idx = 0


class _Lane:
    """Per-model scheduling state (models never share a batch)."""

    def __init__(self, model, chunks: int, quota: Optional[int] = None):
        cfg = model.cfg
        if cfg.num_steps % chunks != 0:
            raise ValueError(
                f"model {model.model_id!r}: chunks ({chunks}) must divide the solver "
                f"horizon num_steps ({cfg.num_steps}) so chunks share a grid")
        if quota is not None and quota < 1:
            raise ValueError(f"model {model.model_id!r}: admission quota must be >= 1 "
                             f"(got {quota}) — a zero quota can never serve")
        self.model = model
        self.chunks = chunks
        self.quota = quota
        self.span = cfg.t1 / chunks
        self.steps_per = cfg.num_steps // chunks
        self.device = _device(model)
        self.pending_roll: list = []   # (sort_key, seq, _InFlight)
        self.pending_term: list = []   # (seq, Request, arrival_s)
        self.active: list = []         # [_Row]
        self.paused: list = []         # [_Row] preempted at a chunk boundary

    @property
    def busy(self) -> bool:
        return bool(self.pending_roll or self.pending_term or self.active or self.paused)


class Scheduler:
    """The continuous-batching serving scheduler.

    Args:
        registry: the :class:`~repro_torch.serving.ModelRegistry` to serve
            from; every step is pooled there keyed ``(model_id, kind, bucket)``.
        max_batch: the largest bucket (the admission slot grid's width).
        chunks: time chunks per rollout horizon, the admission quantum; must
            divide every served model's ``num_steps``.
        mode: ``"continuous"`` (admit at every chunk boundary) or ``"fifo"``
            (drain fully, then coalesce).
        classes: the deadline → tolerance ladder of terminal requests.
        atol / max_steps: the adaptive terminal sampler's limits.
        collect: keep each request's rows on the CPU as
            :attr:`ServeResult.samples`.
        shard_base: bucket granularity: the data-parallel rank count, whose
            process group must be up (rank 0 drives, the others
            :meth:`follow`), or 1.
        clock: the time source (seconds), injectable for deterministic tests.
        preempt: cross-lane preemption (see the module docstring).
        quota: per-model admission cap on rows in flight: an int (every
            model), a ``{model_id: int}`` dict (others fall back to the
            bundle's hint, then unlimited), or None.  Requests over quota
            wait in arrival order; none is dropped.
    """

    def __init__(self, registry: ModelRegistry, *, max_batch: int = 16, chunks: int = 4,
                 mode: str = "continuous", classes=DEADLINE_CLASSES, atol: float = 1e-6,
                 max_steps: int = 4096, collect: bool = False, shard_base: int = 1,
                 clock=time.perf_counter, preempt: bool = False, quota=None):
        if mode not in ("continuous", "fifo"):
            raise ValueError(f"mode must be 'continuous' or 'fifo', got {mode!r}")
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        if quota is not None and not isinstance(quota, (int, dict)):
            raise TypeError(f"quota must be an int (every model), a dict "
                            f"{{model_id: int}}, or None, got {type(quota).__name__}")
        self.registry = registry
        self.buckets = serve_buckets(max_batch, shard_base)
        self.shard_base = shard_base
        self._mesh = None
        if shard_base > 1:
            from ..distributed.sharding import data_parallel_mesh

            self._mesh = data_parallel_mesh()
            if self._mesh is None or self._mesh.size != shard_base:
                raise ValueError(
                    f"shard_base={shard_base} needs a process group of {shard_base} "
                    f"ranks (repro_torch.distributed.compat.launch)")
        self.chunks = chunks
        self.mode = mode
        self.classes = classes
        self.atol = atol
        self.max_steps = max_steps
        self.collect = collect
        self.preempt = preempt
        self.quota = quota
        #: Scheduling counters (benchmarks charge time per batch; tests
        #: assert that preemption engaged).
        self.counters = {"chunk_batches": 0, "terminal_batches": 0,
                         "preempted_rows": 0, "resumed_rows": 0}
        self._clock = clock
        self._t0 = clock()
        self._seq = itertools.count()
        self._lanes: dict = {}

    # -- submission ---------------------------------------------------------

    def now(self) -> float:
        """Seconds since construction on the scheduler's clock."""
        return self._clock() - self._t0

    def _quota_for(self, model) -> Optional[int]:
        if isinstance(self.quota, int):
            return self.quota
        if isinstance(self.quota, dict) and model.model_id in self.quota:
            return self.quota[model.model_id]
        return (getattr(model, "hints", None) or {}).get("quota")

    def _lane(self, model_id: str) -> _Lane:
        if model_id not in self._lanes:
            model = self.registry.get(model_id)
            if model.workload != "sde-gan":
                raise ValueError(
                    f"model {model_id!r} is a {model.workload!r} workload; the "
                    f"continuous-batching scheduler serves the SDE-GAN generator "
                    f"(chunked rollouts / adaptive terminal samples) — serve "
                    f"latent-sde decodes through repro_torch.serving.serve_sde's "
                    f"coalescing loop")
            self._lanes[model_id] = _Lane(model, self.chunks, quota=self._quota_for(model))
        return self._lanes[model_id]

    def submit(self, request: Request, arrival_s: Optional[float] = None) -> None:
        """Enqueue one request (``arrival_s`` defaults to the clock's now; an
        open-loop driver passes the synthetic arrival, so latency includes
        the queueing delay)."""
        if request.size > self.buckets[-1]:
            raise ValueError(f"request {request.rid}: size {request.size} exceeds the "
                             f"largest bucket {self.buckets[-1]} — raise max_batch or "
                             f"split the request")
        lane = self._lane(request.model_id)
        arrival = self.now() if arrival_s is None else arrival_s
        seq = next(self._seq)
        if request.kind == "terminal":
            lane.pending_term.append((seq, request, arrival))
        else:
            # arrival order in both modes: deadlines route terminal batches'
            # tolerances, never rollout admission (EDF starves the relaxed class)
            lane.pending_roll.append(((seq,), seq, _InFlight(request, arrival)))

    @property
    def busy(self) -> bool:
        """True while any lane holds pending, in-flight or paused work."""
        return any(lane.busy for lane in self._lanes.values())

    # -- the pooled steps ---------------------------------------------------

    def _bucket_for(self, rows: int) -> int:
        return next(b for b in self.buckets if b >= rows)

    def _init_pool(self, lane: _Lane, bucket: int):
        from ..core.sde import generator_initial_state

        model, cfg = lane.model, lane.model.cfg

        def step(keys):
            with torch.no_grad():
                return generator_initial_state(model.params, cfg, keys)

        def build():
            return capture_or_eager(step, (_keys([PAD_SEED] * bucket, range(bucket),
                                                 lane.device),))

        return self.registry.compiled(model.model_id, "init", bucket, build)

    def _chunk_pool(self, lane: _Lane, bucket: int):
        from ..core.sde import generator_rollout_chunk

        model, cfg = lane.model, lane.model.cfg

        def step(keys, x0, t_start):
            with torch.no_grad():
                return generator_rollout_chunk(model.params, cfg, keys, x0, t_start,
                                               lane.span, lane.steps_per)

        def build():
            keys = _keys([PAD_SEED] * bucket, range(bucket), lane.device)
            x0 = self._init_pool(lane, bucket)(keys)
            ts = torch.zeros((bucket,), dtype=cfg.dtype, device=lane.device)
            return capture_or_eager(step, (keys, x0, ts))

        return self.registry.compiled(model.model_id, "chunk", bucket, build)

    def _terminal_pool(self, lane: _Lane, bucket: int):
        from ..launch.steps import make_adaptive_terminal_step

        model, cfg = lane.model, lane.model.cfg

        def build():
            full = make_adaptive_terminal_step(cfg, atol=self.atol, max_steps=self.max_steps,
                                               device=lane.device)
            warm = make_adaptive_terminal_step(cfg, atol=self.atol, max_steps=1,
                                               device=lane.device)
            keys = _keys([PAD_SEED] * bucket, range(bucket), lane.device)
            with torch.no_grad():
                return eager_peak(lambda k, rtol: full(model.params, k, rtol), (keys, 1e-3),
                                  warm=lambda k, rtol: warm(model.params, k, rtol))

        return self.registry.compiled(model.model_id, "terminal", bucket, build)

    # -- data parallelism -----------------------------------------------------

    _KINDS = ("init", "chunk", "terminal")

    def _head(self, *words) -> torch.Tensor:
        """A call's header on the registry's device: ``(kind + 1, bucket,
        model index, rtol's float64 bits)``; kind 0 ends :meth:`follow`."""
        model = self.registry.get(self.registry.ids()[0])
        return torch.tensor(words or (0, 0, 0, 0), dtype=torch.int64, device=_device(model))

    def _pool_call(self, kind: str, lane: _Lane, bucket: int, *operands, rtol=None):
        """A pooled step over a ``bucket``-row batch: the pool entry itself on
        one rank; with ``shard_base > 1`` the leader's broadcast of the call
        (:meth:`follow` receives it), then :meth:`_sharded_call`."""
        if self._mesh is None:
            return self._local_call(kind, lane, bucket, operands, rtol)
        from ..distributed import compat, sharding

        head = self._head(1 + self._KINDS.index(kind), bucket,
                          self.registry.ids().index(lane.model.model_id),
                          int(np.float64(rtol or 0.0).view(np.int64)))
        with compat.set_mesh(self._mesh):
            for x in (head, *operands):
                sharding.broadcast(x)
        return self._sharded_call(kind, lane, bucket, operands, rtol)

    def _local_call(self, kind, lane, bucket, operands, rtol):
        if kind == "init":
            return self._init_pool(lane, bucket)(*operands)
        if kind == "chunk":
            return self._chunk_pool(lane, bucket)(*operands)
        return self._terminal_pool(lane, bucket)(*operands, rtol)

    def _sharded_call(self, kind, lane, bucket, operands, rtol):
        """This rank's rows of the call through its pool entry at the local
        bucket, then the rows gathered back (bitwise)."""
        from ..distributed import compat, sharding

        with compat.set_mesh(self._mesh):
            local = [sharding.shard_rows(x, 0) for x in operands]
            out = self._local_call(kind, lane, bucket // self.shard_base, local, rtol)
            if kind == "init":
                return sharding.gather_rows(out, 0)
            if kind == "chunk":
                ys, x_next = out
                return sharding.gather_rows(ys, 1), sharding.gather_rows(x_next, 0)
            samples, conv, stats = out
            return sharding.gather_rows(samples, 0), sharding.gather_rows(conv, 0), stats

    def follow(self) -> None:
        """A follower rank's loop (``shard_base > 1``, rank > 0): receive each
        pooled call the leader broadcasts (its header, then its operands: the
        keys, and for a chunk the states and times), step this rank's rows,
        join the gather; return when the leader calls :meth:`close`."""
        from ..distributed import compat, sharding

        while True:
            with compat.set_mesh(self._mesh):
                kind_i, bucket, index, rtol_bits = sharding.broadcast(self._head()).tolist()
            if kind_i == 0:
                return
            kind = self._KINDS[kind_i - 1]
            lane = self._lane(self.registry.ids()[index])
            cfg = lane.model.cfg
            shapes = [((bucket, 2), torch.int64)]
            if kind == "chunk":
                shapes += [((bucket, cfg.hidden_dim), cfg.dtype), ((bucket,), cfg.dtype)]
            operands = [torch.zeros(shape, dtype=dtype, device=lane.device)
                        for shape, dtype in shapes]
            with compat.set_mesh(self._mesh):
                for x in operands:
                    sharding.broadcast(x)
            rtol = float(np.int64(rtol_bits).view(np.float64)) if kind == "terminal" else None
            self._sharded_call(kind, lane, bucket, operands, rtol)

    def close(self) -> None:
        """The leader's end of a data-parallel drain: release the followers."""
        if self._mesh is None:
            return
        from ..distributed import compat, sharding

        with compat.set_mesh(self._mesh):
            sharding.broadcast(self._head())

    def warm(self, model_id: str, kinds=("init", "chunk")) -> None:
        """Build a model's pool entries for every bucket up front (so builds
        never ride the latency measurements); with ``shard_base > 1`` every
        rank builds its own, at the local buckets."""
        lane = self._lane(model_id)
        for b in self.buckets:
            b //= self.shard_base
            if "init" in kinds:
                self._init_pool(lane, b)
            if "chunk" in kinds:
                self._chunk_pool(lane, b)
            if "terminal" in kinds:
                self._terminal_pool(lane, b)

    # -- the iteration ------------------------------------------------------

    def step(self) -> List[ServeResult]:
        """One iteration: per lane, at most one terminal batch, admission of
        pending rollouts into free slots, and one chunk for every row in
        flight (after the preemption pause or resume).  Returns the requests
        this iteration completed."""
        results: List[ServeResult] = []
        urgent = self._urgent_lanes() if self.preempt else frozenset()
        for model_id, lane in self._lanes.items():
            yield_now = bool(urgent) and model_id not in urgent
            if self.preempt:
                if yield_now:
                    self._pause_relaxed(lane)
                else:
                    self._resume(lane)
            results += self._step_terminal(lane, defer_relaxed=yield_now)
            self._admit(lane)
            results += self._advance(lane)
        return results

    def run(self) -> List[ServeResult]:
        """Drain every queue -> all results, in completion order."""
        results: List[ServeResult] = []
        while self.busy:
            results += self.step()
        return results

    # -- preemption ---------------------------------------------------------

    def _is_realtime(self, request: Request) -> bool:
        return deadline_class_for(request.deadline_ms, self.classes) is self.classes[0]

    def _is_relaxed(self, request: Request) -> bool:
        return deadline_class_for(request.deadline_ms, self.classes) is self.classes[-1]

    def _urgent_lanes(self) -> frozenset:
        """Model ids with realtime-class work pending or in flight (pending
        realtime work always counts as at risk: the policy does not predict
        misses)."""
        return frozenset(
            model_id for model_id, lane in self._lanes.items()
            if any(self._is_realtime(f.request) for _, _, f in lane.pending_roll)
            or any(self._is_realtime(req) for _, req, _ in lane.pending_term)
            or any(self._is_realtime(r.flight.request) for r in lane.active))

    def _pause_relaxed(self, lane: _Lane) -> None:
        """Move the lane's relaxed-class rows from ``active`` to ``paused``
        (they carry their state and chunk index, so resuming is bitwise
        invisible)."""
        still, paused = [], []
        for row in lane.active:
            (paused if self._is_relaxed(row.flight.request) else still).append(row)
        if paused:
            lane.active = still
            lane.paused += paused
            self.counters["preempted_rows"] += len(paused)

    def _resume(self, lane: _Lane) -> None:
        """Re-activate paused rows, in pause order, while the bucket allows."""
        while lane.paused and len(lane.active) < self.buckets[-1]:
            lane.active.append(lane.paused.pop(0))
            self.counters["resumed_rows"] += 1

    # -- rollouts -----------------------------------------------------------

    def _admit(self, lane: _Lane) -> None:
        if self.mode == "fifo" and (lane.active or lane.paused):
            return  # the batch in flight drains before the next coalesce
        in_flight = len(lane.active) + len(lane.paused)
        capacity = self.buckets[-1] - in_flight
        if lane.quota is not None:
            # paused rows keep their admission (they yielded compute, not a slot)
            capacity = min(capacity, lane.quota - in_flight)
        admitted: list = []
        while lane.pending_roll and lane.pending_roll[0][2].request.size <= capacity:
            _, _, flight = lane.pending_roll.pop(0)
            admitted.append(flight)
            capacity -= flight.request.size
        if not admitted:
            return
        # the initial states of every admitted row, in one padded batch
        n = sum(f.request.size for f in admitted)
        bucket = self._bucket_for(n)
        seeds = [f.request.seed for f in admitted for _ in range(f.request.size)]
        rows = [j for f in admitted for j in range(f.request.size)]
        keys = _keys(seeds + [PAD_SEED] * (bucket - n), rows + list(range(bucket - n)),
                     lane.device)
        x0 = self._pool_call("init", lane, bucket, keys)
        i = 0
        for flight in admitted:
            for j in range(flight.request.size):
                lane.active.append(_Row(flight, j, x0[i]))
                i += 1

    def _advance(self, lane: _Lane) -> List[ServeResult]:
        if not lane.active:
            return []
        cfg = lane.model.cfg
        n = len(lane.active)
        bucket = self._bucket_for(n)
        pad = bucket - n
        keys = _keys([r.flight.request.seed for r in lane.active] + [PAD_SEED] * pad,
                     [r.j for r in lane.active] + [1 + i for i in range(pad)], lane.device,
                     chunks=[r.chunk_idx for r in lane.active] + [-1] * pad)
        x = torch.stack([r.x for r in lane.active]
                        + [lane.active[0].x.new_zeros(lane.active[0].x.shape)] * pad)
        t_starts = torch.tensor([r.chunk_idx * lane.span for r in lane.active] + [0.0] * pad,
                                dtype=cfg.dtype).to(lane.device)
        ys, x_next = self._pool_call("chunk", lane, bucket, keys, x, t_starts)
        _sync(lane.device)
        self.counters["chunk_batches"] += 1

        results: List[ServeResult] = []
        still_active: list = []
        ys_host = ys.cpu() if self.collect else None
        for i, row in enumerate(lane.active):
            if self.collect:
                # chunk 0 keeps its entry row; a later chunk's entry row is
                # the previous chunk's last
                lo = 0 if row.chunk_idx == 0 else 1
                row.flight.chunks.setdefault(row.j, []).append(ys_host[lo:, i])
            row.x = x_next[i]
            row.chunk_idx += 1
            if row.chunk_idx < lane.chunks:
                still_active.append(row)
                continue
            flight = row.flight
            flight.rows_left -= 1
            if flight.rows_left == 0:
                results.append(self._finish(flight))
        lane.active = still_active
        return results

    def _finish(self, flight: _InFlight) -> ServeResult:
        req = flight.request
        samples = None
        if self.collect:
            samples = torch.stack([torch.cat(flight.chunks[j]) for j in range(req.size)], 1)
        return ServeResult(rid=req.rid, model_id=req.model_id, size=req.size,
                           converged=np.ones(req.size, bool),
                           latency_s=self.now() - flight.arrival_s,
                           deadline_ms=req.deadline_ms, rtol=None, samples=samples)

    # -- adaptive terminal batches ------------------------------------------

    def _step_terminal(self, lane: _Lane, defer_relaxed: bool = False) -> List[ServeResult]:
        if not lane.pending_term:
            return []
        # one deadline class per iteration, tightest first: the class keys
        # the grouping and (through route_rtol) the batch's tolerance
        by_class: dict = {}
        for entry in lane.pending_term:
            by_class.setdefault(deadline_class_for(entry[1].deadline_ms, self.classes).name,
                                []).append(entry)
        cls = next(c for c in self.classes if c.name in by_class)
        entries = by_class[cls.name]
        if defer_relaxed and cls is self.classes[-1]:
            return []  # preemption: the urgent lane gets this iteration
        batch, rows = [], 0
        while entries and rows + entries[0][1].size <= self.buckets[-1]:
            batch.append(entries.pop(0))
            rows += batch[-1][1].size
        taken = {seq for seq, _, _ in batch}
        lane.pending_term = [e for e in lane.pending_term if e[0] not in taken]
        reqs = [req for _, req, _ in batch]
        rtol = route_rtol(reqs, self.classes)

        bucket = self._bucket_for(rows)
        keys = _keys([r.seed for r in reqs for _ in range(r.size)] + [PAD_SEED] * (bucket - rows),
                     [j for r in reqs for j in range(r.size)] + list(range(bucket - rows)),
                     lane.device)
        samples, conv, _ = self._pool_call("terminal", lane, bucket, keys, rtol=rtol)
        _sync(lane.device)
        self.counters["terminal_batches"] += 1
        conv = conv.cpu().numpy()
        samples = samples.cpu() if self.collect else None

        results, i = [], 0
        now = self.now()
        for _, req, arrival in batch:
            results.append(ServeResult(
                rid=req.rid, model_id=req.model_id, size=req.size,
                converged=conv[i:i + req.size], latency_s=now - arrival,
                deadline_ms=req.deadline_ms, rtol=rtol,
                samples=None if samples is None else samples[i:i + req.size]))
            i += req.size
        return results


def run_open_loop(scheduler: Scheduler, requests, arrivals_s) -> list:
    """Open-loop driver: feed ``requests`` at their ``arrivals_s`` offsets
    (seconds from start) whatever the service's progress — the offered load
    is fixed by the arrivals, not by completions.  Returns every
    :class:`ServeResult`; latencies include the queueing delay."""
    feed = sorted(zip(arrivals_s, range(len(requests))))
    results = []
    i = 0
    while i < len(feed) or scheduler.busy:
        now = scheduler.now()
        while i < len(feed) and feed[i][0] <= now:
            arrival, idx = feed[i]
            scheduler.submit(requests[idx], arrival_s=arrival)
            i += 1
        if scheduler.busy:
            results += scheduler.step()
        elif i < len(feed):
            time.sleep(max(0.0, min(feed[i][0] - scheduler.now(), 0.01)))
    return results


def latency_summary(results, q=(0.5, 0.99)) -> dict:
    """p50 / p99 (nearest rank), requests, rows and deadline misses of a
    result list."""
    lat = [r.latency_s for r in results]
    out = {f"p{int(100 * x)}_s": percentile(lat, x) for x in q}
    out["requests"] = len(results)
    out["rows"] = sum(r.size for r in results)
    out["deadline_misses"] = sum(1 for r in results
                                 if not r.deadline_met and math.isfinite(r.deadline_ms))
    return out


def class_latency_summary(results, classes=DEADLINE_CLASSES) -> dict:
    """:func:`latency_summary` per deadline class present in ``results``
    (an aggregate p99 hides a realtime miss behind the relaxed bulk)."""
    by_cls: dict = {}
    for r in results:
        by_cls.setdefault(deadline_class_for(r.deadline_ms, classes).name, []).append(r)
    return {name: latency_summary(rs) for name, rs in by_cls.items()}
