"""Mesh APIs on ``torch.distributed`` (port of :mod:`repro.distributed.compat`).

The reference wraps the moving JAX mesh surface; the port's counterpart is
one record, :class:`Mesh`, over a ``torch.distributed`` ``DeviceMesh``:

* :func:`make_mesh` — a mesh of named axes over the process group's ranks
  (``init_device_mesh``; the group must hold exactly ``prod(axis_shapes)``
  ranks).
* :func:`set_mesh` / :func:`ambient_mesh` — the active mesh, a context
  variable, or ``None`` when unsharded.
* :func:`abstract_mesh` — the shape-and-names record with no process group
  (the rule tables read only the axes and their sizes).
* :func:`launch` — in place of ``force_host_device_count``: start ``n``
  local ranks with ``torch.multiprocessing`` (spawn), each with the process
  group initialised through a ``file://`` rendezvous (parallel test workers
  never race for a TCP port), and join them with a time limit.

Backend rule (:func:`backend_for`): NCCL when each rank has a card of its
own; gloo on the CPU, or when ranks share one card (NCCL refuses two ranks
on one device; gloo carries CUDA tensors through ``broadcast`` and
``all_reduce``, which is all the data-parallel path uses).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes; ``device_mesh`` is the ``DeviceMesh`` (None for an
    abstract mesh) and ``coordinate`` this rank's place on it."""

    axis_shapes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Any = None
    coordinate: Optional[Tuple[int, ...]] = None

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_shapes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shapes)

    @property
    def empty(self) -> bool:
        return not self.axis_names

    def group(self, axis: str):
        """The process group of ``axis`` (a concrete mesh only)."""
        if self.device_mesh is None:
            raise ValueError("an abstract mesh has no process groups")
        return self.device_mesh.get_group(axis)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def ambient_mesh() -> Optional[Mesh]:
    """The active mesh (concrete or abstract), or ``None`` when unsharded."""
    mesh = _AMBIENT.get()
    return None if mesh is None or mesh.empty else mesh


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Activate ``mesh`` for the dynamic extent of the block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def abstract_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh record of shapes and names with no process group."""
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"{len(shapes)} axis sizes for {len(names)} axis names")
    return Mesh(shapes, names)


def _device_type() -> str:
    """A mesh's device type: ``cuda`` under NCCL, else ``cpu`` (gloo carries
    CUDA tensors' collectives through the host either way)."""
    return "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` over the initialised process group's ranks, built
    with ``init_device_mesh``; the group must hold ``prod(axis_shapes)``
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shapes) != world:
        raise ValueError(f"a mesh of {shapes} needs {math.prod(shapes)} ranks; the "
                         f"process group has {world}")
    dm = init_device_mesh(_device_type(), shapes, mesh_dim_names=names)
    return Mesh(shapes, names, dm, tuple(int(c) for c in dm.get_coordinate()))


def backend_for(device: str, nprocs: int) -> str:
    """NCCL when each of ``nprocs`` ranks has its own card, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, nprocs, init_file, backend, device, args, out_dir, quiet):
    """One spawned rank: join the group, run ``fn(*args)``, save its result.
    Its device: ``cuda:r`` under NCCL (a card a rank), ``cuda:0`` when the
    ranks share the one card, else the CPU."""
    torch.set_num_threads(1)
    if quiet and rank != 0:
        sys.stdout = open(os.devnull, "w")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else (dev.index or 0))
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=nprocs, **kw)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class RanksFailed(RuntimeError):
    """A spawned rank raised, died, or the ranks outran their time limit."""


def launch(fn: Callable, nprocs: int, args: tuple = (), device: str = "cpu",
           timeout: Optional[float] = None, quiet: bool = True) -> list:
    """Run ``fn(*args)`` on ``nprocs`` local ranks (spawned processes) with the
    process group up, and return each rank's result, rank order.

    ``fn`` and ``args`` must be picklable (a module-level function); a
    result comes back through ``torch.save``.  The backend follows
    :func:`backend_for`; every rank runs one thread (``OMP_NUM_THREADS=1``).
    With ``timeout`` the ranks are joined with that many seconds in all:
    past it they are killed and :class:`RanksFailed` is raised, as when any
    rank fails.  Without it (the default) the ranks are waited for however
    long they run.
    ``quiet`` silences the standard output of every rank but 0."""
    import torch.multiprocessing as mp

    backend = backend_for(device, nprocs)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            ctx = mp.start_processes(_rank_main, args=(fn, nprocs, init_file, backend, device,
                                                       args, tmp, quiet),
                                     nprocs=nprocs, join=False, start_method="spawn")
        finally:
            if old is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = old
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0 if deadline is None else
                               max(0.0, min(5.0, deadline - time.monotonic()))):
                if deadline is not None and time.monotonic() >= deadline:
                    raise RanksFailed(f"{nprocs} ranks did not finish within {timeout} s")
        except Exception as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            errs = sorted(Path(tmp).glob("rank*.err"))
            detail = "\n".join(f"{p.stem}:\n{p.read_text()}" for p in errs)
            raise RanksFailed(f"data-parallel ranks failed: {e}\n{detail}") from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def backend_note(device) -> str:
    """The process group's backend and why (the :func:`backend_for` rule)
    for ranks computing on ``device``, for the "data-parallel over N
    devices" line."""
    backend = dist.get_backend()
    if backend == "nccl":
        return "nccl: a card a rank"
    shared = torch.device(device).type == "cuda"
    return f"{backend}: {'ranks share one card' if shared else 'ranks on the CPU'}"


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _cli_rank(main, argv):
    out = main(argv)
    return out if rank() == 0 else None


def _without_flag(argv: Sequence[str], flag: str) -> list:
    """``argv`` without ``flag`` and its value (``--flag N`` or ``--flag=N``)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def run_cli_ranks(main: Callable, argv: Optional[Sequence[str]], nprocs: int,
                  device: Optional[str]):
    """A CLI's ``--host-devices N``: rerun ``main`` (a module-level function)
    on ``nprocs`` local ranks with the flag taken out of ``argv``, and return
    rank 0's result.  Ranks run on ``device`` (the card by default) with no
    time limit: a training run or a service runs as long as it runs."""
    argv = _without_flag(sys.argv[1:] if argv is None else list(argv), "--host-devices")
    dev = "cuda" if device is None else str(device)
    return launch(_cli_rank, nprocs, (main, argv), device=dev)[0]
