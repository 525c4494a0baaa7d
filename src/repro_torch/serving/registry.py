"""The in-process model registry and its program pools (port of
:mod:`repro.serving.registry`: ``LoadedModel``, ``load_model``,
``restore_for_serving`` and ``ModelRegistry``).

N named checkpoints live in one serving process: each :class:`LoadedModel`
is a params-only restore of one ``repro-serving/v2`` bundle entry (a v1
bundle reads as the single entry ``"default"``), and every program the
scheduler builds is cached here keyed ``(model_id, kind, bucket)``.
Unloading a model drops its params and its pool entries; loading another
under a fresh id touches nothing that is serving.

The reference caches one AOT-compiled XLA program per key.  The port's
pool entries, by kind and device:

* ``"init"`` and ``"chunk"`` on the card: one captured
  ``torch.cuda.CUDAGraph`` per key (:class:`CapturedGraph`).  The step
  runs once eagerly on the capture's side stream first (first-use work —
  ``cudaFuncSetAttribute``, loading the kernel library, the cuBLAS handle
  and the stream's workspace — stays out of the capture, whose pool would
  otherwise hold a workspace that outlives the graph), then is captured on
  that stream into a memory pool of its own over static input buffers.  A
  call copies the batch into the inputs, replays the graph and returns
  copies of the static outputs.  A failed capture raises: nothing serves
  eagerly in its place.  The entry's bytes are what the capture took from
  the caching allocator — ``torch.cuda.memory_reserved`` just after the
  capture less just before it, which is the graph's private pool (its
  inputs, its outputs and every intermediate): a fresh pool reuses no
  cached block, so every block it holds is a segment the capture added.
  The capture is begun and ended by hand, not under ``torch.cuda.graph``,
  whose entry empties the whole process's allocator cache.  Evicting the
  entry resets the graph and drops its tensors: its pool's segments go back
  to the device at the allocator's next release of its cache
  (``torch.cuda.empty_cache()``, or the retry of an allocation that would
  not otherwise fit).  Nothing here empties the cache of a serving process,
  whose other models' eager steps keep using it.
* ``"terminal"`` on the card: not captured.  The adaptive loop reads one
  value on the host each iteration and its step count depends on the data,
  so its entry is the built eager step (:class:`EagerProgram`); its bytes
  are the peak that a warm call at that bucket allocated above the memory
  in use before it (one controller iteration, ``max_steps=1``: memory is
  constant across iterations, the loop being forward only).
* Any kind on the CPU (``device="cpu"``, the tests): the eager callable,
  0 bytes — the CPU path the caller asked for.  A budget never trips there.

Launches.  ``ops.launch_counts()`` counts the kernel wrappers' calls on the
host, so a replay adds nothing to it.  The wrappers' calls while a graph
records launch nothing: each graph keeps them as the launches it recorded
(:attr:`CapturedGraph.launches`) and takes them back off
``ops.launch_counts()``.  Every replay adds them to
:attr:`ModelRegistry.replay_launches`, so the eager counts plus the
replays' are the kernels that ran.

Under ``pool_budget_bytes`` the pool is an LRU: a hit refreshes its entry,
a miss builds it and evicts the coldest entries until the pool fits (the
entry just built is never evicted, so one larger than the whole budget
still serves).  Eviction never changes results: a rebuilt entry gives the
bits of the evicted one.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import torch

from .. import checkpoint as ckpt, tree
from ..device import resolve_device
from ..kernels import ops


def _config_class(workload: str):
    from ..core.sde import LatentSDEConfig, NeuralSDEConfig
    from ..launch.steps import SERVE_WORKLOADS

    if workload not in SERVE_WORKLOADS:
        raise ValueError(f"workload must be one of {SERVE_WORKLOADS}, got {workload!r}")
    return NeuralSDEConfig if workload == "sde-gan" else LatentSDEConfig


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


def _init_params(workload: str, cfg, seed: int):
    """Fresh parameters of a workload's bundle (the SDE-GAN serves its
    generator only), from a ``torch.Generator`` seeded with ``seed``."""
    from ..core.sde import generator_init, latent_sde_init

    gen = torch.Generator().manual_seed(seed)
    return (generator_init if workload == "sde-gan" else latent_sde_init)(gen, cfg)


@dataclasses.dataclass
class LoadedModel:
    """One registry entry: a named, servable checkpoint.  ``hints`` is the
    bundle entry's optional ``"serving"`` dict (``{"quota": 4}``: the
    scheduler's default admission quota for the model; an explicit
    ``Scheduler(quota=...)`` wins)."""

    model_id: str
    workload: str
    cfg: object
    params: object
    step: int = 0
    hints: dict = dataclasses.field(default_factory=dict)


def load_model(ckpt_dir, model_id: Optional[str] = None, step: Optional[int] = None,
               device=None) -> LoadedModel:
    """Restore one named model of a serving bundle onto ``device`` (the card
    unless ``device="cpu"``) -> :class:`LoadedModel`.  ``model_id=None``
    takes a single-entry bundle's model and refuses, by name, to pick one of
    several."""
    dev = resolve_device(device)
    meta, _ = ckpt.load_serving_manifest(ckpt_dir)
    entries = {m["model_id"]: m for m in meta["models"]}
    if model_id is None:
        if len(entries) != 1:
            raise ValueError(
                f"serving bundle under {ckpt_dir} carries {len(entries)} model entries "
                f"({sorted(entries)}); pass model_id= to pick one")
        model_id = next(iter(entries))
    if model_id not in entries:
        raise ValueError(f"serving bundle under {ckpt_dir} has no model {model_id!r} "
                         f"(entries: {sorted(entries)})")
    entry = entries[model_id]
    cfg = config_from_meta(entry["workload"], entry["config"])
    params, got = ckpt.restore_serving_model(
        ckpt_dir, _init_params(entry["workload"], cfg, 0), model_id, step=step)
    return LoadedModel(model_id, entry["workload"], cfg, tree.map(lambda x: x.to(dev), params), got,
                       hints=dict(entry.get("serving") or {}))


def restore_for_serving(workload: str, ckpt_dir, device=None):
    """Read a single-model (JAX- or port-written) bundle onto ``device`` ->
    ``(params, cfg, step)``; a bundle of another workload stops with a named
    error."""
    model = load_model(ckpt_dir, device=device)
    if model.workload != workload:
        raise ValueError(
            f"serving bundle under {ckpt_dir} was trained for workload "
            f"{model.workload!r}, not {workload!r} — point --ckpt-dir at a matching "
            f"run or change --workload")
    return model.params, model.cfg, model.step


class EagerProgram:
    """A pool entry that runs its step eagerly: every entry on the CPU, and
    the adaptive ``"terminal"`` entries on the card."""

    def __init__(self, fn: Callable, nbytes: int = 0):
        self.fn = fn
        self.nbytes = nbytes

    def __call__(self, *args):
        return self.fn(*args)

    def release(self) -> None:
        self.fn = None


def eager_peak(fn: Callable, example_args, warm: Optional[Callable] = None) -> EagerProgram:
    """``fn`` as a pool entry whose bytes are the peak one warm call
    (``warm``, default ``fn``) allocated above what was in use before it."""
    dev = example_args[0].device
    warm = fn if warm is None else warm
    if dev.type != "cuda":
        return EagerProgram(fn)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    warm(*example_args)
    torch.cuda.synchronize(dev)
    return EagerProgram(fn, max(torch.cuda.max_memory_allocated(dev) - base, 0))


_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev: torch.device):
    """The one side stream every warm-up and capture on ``dev`` runs on:
    cuBLAS keeps a workspace per stream, so the warm-up allocates it there,
    outside any graph's pool, and no capture allocates another.

    The first capture in a process also allocates state that outlives it
    (the CUDA generator's graph-safe seed and offset, in that capture's
    pool), so a throwaway capture takes it here: no pool entry's bytes then
    hold memory its eviction cannot free."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _CAPTURE_STREAMS:
        side = torch.cuda.Stream(dev)
        primer = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            primer.capture_begin()
            try:
                torch.zeros(1, device=dev)
            finally:
                primer.capture_end()
        _CAPTURE_STREAMS[key] = (side, primer)
    return _CAPTURE_STREAMS[key][0]


class CapturedGraph:
    """``fn(*args)`` captured once as a CUDA graph over static inputs shaped
    like ``example_args`` (CUDA tensors), in a memory pool of its own; see
    the module docstring for the warm-up, the bytes and the launches.

    Calls take tensors of the example shapes and return fresh tensors (the
    graph's outputs are overwritten by the next replay)."""

    def __init__(self, fn: Callable, example_args):
        dev = example_args[0].device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*example_args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        reserved = torch.cuda.memory_reserved(dev)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                self.inputs = [torch.empty_like(a) for a in example_args]
                out = fn(*self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.synchronize(dev)
        self.nbytes = torch.cuda.memory_reserved(dev) - reserved
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        after = ops.launch_counts()
        #: Kernel launches the graph recorded, by kernel name.
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        ops.uncount_launches(self.launches)
        #: Set by the registry: every replay adds :attr:`launches` to it.
        self.counter: Optional[collections.Counter] = None

    def __call__(self, *args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        if self.counter is not None:
            self.counter.update(self.launches)
        outs = tuple(o.clone() for o in self.outputs)
        return outs[0] if self.single else outs

    def release(self) -> None:
        """Free the graph and its pool (the bytes go back to the device at
        the allocator's next release of its cache)."""
        self.graph.reset()
        self.graph = self.inputs = self.outputs = None


def capture_or_eager(fn: Callable, example_args):
    """The pool entry of an ``"init"`` or ``"chunk"`` step: a
    :class:`CapturedGraph` on the card, the eager callable on the CPU."""
    if example_args[0].device.type == "cuda":
        return CapturedGraph(fn, example_args)
    return EagerProgram(fn)


def _program_bytes(program) -> int:
    """A pool entry's bytes (0 where none are measured: the budget then
    never trips)."""
    return int(getattr(program, "nbytes", 0) or 0)


class ModelRegistry:
    """The model table ``model_id -> LoadedModel`` plus the program pools
    keyed ``(model_id, kind, bucket)``.

    Hot loading: :meth:`load` / :meth:`register` may run while other models
    serve — entries are built lazily per key, so a new model's first batch
    pays its builds and nobody else's cache is touched.  :meth:`unload`
    drops a model's params and every pool entry keyed to it.  With
    ``pool_budget_bytes`` the pool is an LRU over the entries' bytes (the
    module docstring says how they are measured); ``evictions`` and
    ``compiles`` (builder calls) are public for tests and benchmarks."""

    def __init__(self, pool_budget_bytes: Optional[int] = None):
        if pool_budget_bytes is not None and pool_budget_bytes <= 0:
            raise ValueError(f"pool_budget_bytes must be positive (got {pool_budget_bytes}); "
                             f"pass None for an unbounded pool")
        self._models: dict = {}
        # (model_id, kind, bucket) -> (program, nbytes); ordered cold -> hot
        self._pools: "collections.OrderedDict" = collections.OrderedDict()
        self.pool_budget_bytes = pool_budget_bytes
        self.evictions = 0
        self.compiles = 0
        #: Kernel launches of every graph replay, by kernel name.
        self.replay_launches: collections.Counter = collections.Counter()

    # -- the model table ----------------------------------------------------

    def register(self, model: LoadedModel, replace: bool = False) -> str:
        """Add a model under its id (``replace=True`` hot-swaps it; the old
        model's pool goes with its params)."""
        if model.model_id in self._models and not replace:
            raise ValueError(f"model {model.model_id!r} is already registered (ids: "
                             f"{sorted(self._models)}); unload it or pass replace=True "
                             f"to hot-swap")
        if model.model_id in self._models:
            self.unload(model.model_id)
        self._models[model.model_id] = model
        return model.model_id

    def load(self, ckpt_dir, step: Optional[int] = None, replace: bool = False,
             device=None) -> tuple:
        """Restore every entry of a serving bundle -> the loaded ids."""
        meta, _ = ckpt.load_serving_manifest(ckpt_dir)
        return tuple(self.register(load_model(ckpt_dir, e["model_id"], step=step,
                                              device=device), replace=replace)
                     for e in meta["models"])

    def unload(self, model_id: str) -> None:
        """Drop a model's params and every pool entry keyed to it."""
        if model_id not in self._models:
            raise ValueError(f"model {model_id!r} is not registered (ids: "
                             f"{sorted(self._models)})")
        del self._models[model_id]
        for key in [k for k in self._pools if k[0] == model_id]:
            self._pools.pop(key)[0].release()

    def get(self, model_id: str) -> LoadedModel:
        try:
            return self._models[model_id]
        except KeyError:
            raise ValueError(f"no model {model_id!r} in the registry (ids: "
                             f"{sorted(self._models)}); load a bundle or register a "
                             f"model first") from None

    def ids(self) -> tuple:
        return tuple(sorted(self._models))

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._models

    # -- the pools ----------------------------------------------------------

    def compiled(self, model_id: str, kind: str, bucket: int, builder: Callable,
                 verbose: bool = True):
        """The pool entry keyed ``(model_id, kind, bucket)``, built by
        ``builder()`` on a miss (the caller owns the build — a capture or an
        eager step — the registry owns the cache, its bytes and the LRU)."""
        self.get(model_id)
        key = (model_id, kind, bucket)
        if key not in self._pools:
            t0 = time.perf_counter()
            program = builder()
            self.compiles += 1
            if isinstance(program, CapturedGraph):
                program.counter = self.replay_launches
            self._pools[key] = (program, _program_bytes(program))
            if verbose:
                print(f"[serve] built {model_id}/{kind} bucket {bucket} "
                      f"({type(program).__name__}, {self._pools[key][1]} B) in "
                      f"{time.perf_counter() - t0:.2f}s", flush=True)
            self._evict(protect=key, verbose=verbose)
        self._pools.move_to_end(key)
        return self._pools[key][0]

    def _evict(self, protect, verbose: bool = True) -> None:
        """Drop the coldest entries until the pool fits the budget; the key
        just built is never dropped."""
        if self.pool_budget_bytes is None:
            return
        while self.pool_bytes() > self.pool_budget_bytes and len(self._pools) > 1:
            cold = next(iter(self._pools))
            if cold == protect:
                break
            program, nbytes = self._pools.pop(cold)
            program.release()
            self.evictions += 1
            if verbose:
                print(f"[serve] evicted {cold[0]}/{cold[1]} bucket {cold[2]} ({nbytes} B) "
                      f"under pool budget {self.pool_budget_bytes} B", flush=True)

    def pool_keys(self, model_id: Optional[str] = None) -> tuple:
        keys = self._pools if model_id is None else [k for k in self._pools
                                                     if k[0] == model_id]
        return tuple(sorted(keys))

    def pool_bytes(self, model_id: Optional[str] = None) -> int:
        return sum(nbytes for k, (_, nbytes) in self._pools.items()
                   if model_id is None or k[0] == model_id)
