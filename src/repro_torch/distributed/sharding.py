"""Sharding rules and the data-parallel collectives (port of
:mod:`repro.distributed.sharding`).

Axis roles on the production mesh (:mod:`repro_torch.launch.mesh`): ``pod``
and ``data`` carry the batch (and FSDP), ``model`` the tensor-parallel
shards.  The reference states its rules as GSPMD ``PartitionSpec``\\ s and lets
one global program run them; here each rank is a process that computes its
own rows, so the module holds two things:

* the rule tables, as pure functions of the axes: :func:`param_specs` (the
  reference's ``PartitionSpec`` entries, a tuple a leaf) and
  :func:`param_pspecs` (the same as DTensor placements, one a mesh
  dimension), with the divisibility fallback and ``serve_pure_tp``.
  Nothing executes the LM sharded yet;
* the Neural-SDE path's data parallelism: :func:`data_parallel_mesh`,
  :func:`shard_time_major` (the rank's rows of a ``(T+1, B, ...)`` tensor),
  :func:`row_window` (the rank's rows of the whole batch, which the one-key
  draws need), and the collectives that make a rank's local values
  whole: :func:`allreduce_mean` (one flat all-reduce, sum then divided by
  the rank count), :func:`gather_rows` and :func:`broadcast`.

Every helper is the identity without an active mesh, so one device runs
the same code unsharded.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .compat import Mesh, ambient_mesh, make_mesh


def active_mesh_axes() -> Tuple[str, ...]:
    am = ambient_mesh()
    return tuple(am.axis_names) if am is not None else ()


def dp_axes(axes: Optional[Tuple[str, ...]] = None):
    axes = active_mesh_axes() if axes is None else axes
    got = tuple(a for a in ("pod", "data") if a in axes)
    return got if got else None


def tp_axis(axes: Optional[Tuple[str, ...]] = None) -> Optional[str]:
    axes = active_mesh_axes() if axes is None else axes
    return "model" if "model" in axes else None


def tp_size() -> int:
    am = ambient_mesh()
    if am is None:
        return 1
    return am.shape.get("model", 1)


def batch_pspec(batch_dim_first: bool = True) -> tuple:
    """The reference's ``P(dp)`` (or ``P(None, dp)``) as a spec tuple."""
    return (dp_axes(),) if batch_dim_first else (None, dp_axes())


# -----------------------------------------------------------------------------
# data parallelism (the Neural-SDE training steps and the sampler)
# -----------------------------------------------------------------------------


def data_parallel_mesh(batch: Optional[int] = None) -> Optional[Mesh]:
    """Pure data-parallel mesh over every rank of the process group, or
    ``None`` when there is one rank (or ``batch`` is given and does not
    divide by the rank count).  Activate it with ``compat.set_mesh``."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n <= 1:
        return None
    if batch is not None and batch % n != 0:
        return None
    return make_mesh((n,), ("data",))


def _dp_place(mesh: Mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank along the mesh's data axes."""
    index, count = 0, 1
    for name, size, c in zip(mesh.axis_names, mesh.axis_shapes, mesh.coordinate):
        if name in ("pod", "data"):
            index, count = index * size + c, count * size
    return index, count


def _dp_mesh() -> Optional[Mesh]:
    am = ambient_mesh()
    if am is None or am.device_mesh is None or dp_axes(am.axis_names) is None:
        return None
    return am


def dp_world() -> int:
    """The number of data-parallel shards under the active mesh (1 without)."""
    am = _dp_mesh()
    return 1 if am is None else _dp_place(am)[1]


def row_window(batch: int) -> Optional[Tuple[int, int]]:
    """``(r0, r1)``, this rank's rows of a whole batch of ``batch`` under the
    active data-parallel mesh, or None without one."""
    am = _dp_mesh()
    if am is None:
        return None
    index, count = _dp_place(am)
    if batch % count:
        raise ValueError(f"a batch of {batch} does not divide over {count} "
                         f"data-parallel ranks")
    local = batch // count
    return index * local, (index + 1) * local


def shard_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim`` (the whole ``x``
    without a mesh)."""
    am = _dp_mesh()
    if am is None:
        return x
    index, count = _dp_place(am)
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"{n} rows do not divide over {count} data-parallel ranks")
    return x.narrow(dim, index * (n // count), n // count)


def shard_time_major(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a ``(T+1, batch, ...)`` path tensor; a no-op
    without a mesh.  Every rank makes the tensor whole from the step key
    (its statistics are the whole batch's, as the reference's global
    program computes them) and keeps its rows."""
    return shard_rows(x, 1)


def _group():
    am = _dp_mesh()
    if am is None:
        return None
    if len(am.axis_names) == 1:
        return am.group(am.axis_names[0])
    return None  # the data axes of a multi-axis mesh: the whole group


def allreduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the data-parallel ranks of each tensor: one flat
    all-reduce (sum) of all of them per dtype, then a division by the rank
    count.  Every rank gets the same bits.  The inputs come back unchanged
    without a mesh."""
    tensors = list(tensors)
    am = _dp_mesh()
    if am is None:
        return tensors
    count = _dp_place(am)[1]
    group = _group()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        # a true division (on the card ``tensor / int`` multiplies by the
        # reciprocal, which is not the division for a count like 3)
        flat = flat / torch.full((), count, dtype=flat.dtype, device=flat.device)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].reshape(tensors[i].shape)
            at += n
    return out


_INT_VIEWS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole tensor from every rank's equal share along ``dim``, on every
    rank, bitwise: each rank writes its share into a zero-filled whole
    buffer, viewed as integers, and one ``all_reduce`` sums them (adding
    integer zeros changes no bits).  Every backend runs it on CUDA tensors
    (gloo too).  The input comes back unchanged without a mesh."""
    am = _dp_mesh()
    if am is None:
        return x
    index, count = _dp_place(am)
    x = x.movedim(dim, 0).contiguous()
    n = x.shape[0]
    whole = x.new_zeros((n * count,) + tuple(x.shape[1:]))
    whole[index * n:(index + 1) * n] = x
    if whole.dtype == torch.bool:
        words = whole.view(torch.uint8)
    else:
        words = whole.view(_INT_VIEWS[whole.element_size()])
    dist.all_reduce(words, op=dist.ReduceOp.SUM, group=_group())
    return whole.movedim(0, dim)


def global_max(value: int) -> int:
    """The largest ``value`` over the ranks (``value`` itself without a mesh)."""
    am = _dp_mesh()
    if am is None:
        return value
    device = "cuda" if am.device_mesh.device_type == "cuda" else "cpu"
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group())
    return int(t.item())


def broadcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` from rank 0 on every rank (in place on the receivers, whose
    ``x`` gives the shape and dtype); unchanged without a mesh."""
    if _dp_mesh() is None:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=0, group=_group())
    return x


# -----------------------------------------------------------------------------
# parameter sharding rules (by name, innermost path component)
# -----------------------------------------------------------------------------

# name -> spec over the *trailing* dims (leading stacked-layer dims get None);
# the reference's table, src/repro/distributed/sharding.py:129-155
_RULES = {
    "embed": ("tp", "dp"),
    "head": ("dp", "tp"),
    "pos_embed": (None, "dp"),
    "wq": ("dp", "tp"), "wk": ("dp", "tp"), "wv": ("dp", "tp"), "wo": ("tp", "dp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "wq_a": ("dp", None), "wq_b": (None, "tp"),
    "wkv_a": ("dp", None), "wkv_b": (None, "tp"), "wo_mla": ("tp", "dp"),
    "gate": ("dp", "tp"), "up": ("dp", "tp"), "down": ("tp", "dp"),
    # the router is absent (replicated): sharding its contraction dim costs
    # a partial-sum all-reduce per MoE layer in the backward
    "e_gate": ("ep", "dp", "tp_or_none"), "e_up": ("ep", "dp", "tp_or_none"),
    "e_down": ("ep", "tp_or_none", "dp"),
    "in_proj": ("dp", "tp"), "out_proj": ("tp", "dp"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "A_log": ("tp",), "Dskip": ("tp",), "dt_bias": ("tp",), "norm_g": ("tp",),
}

_REPLICATED = {"g", "b", "ln1", "ln2", "ln3", "final_norm", "scale"}


def _axis_product(entry, sizes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(entry, 1)


def _spec_for(name: str, shape, axes, sizes, ep_ok: bool) -> tuple:
    """A leaf's spec: per tensor dim ``None``, an axis name or a tuple of
    them (the reference's ``PartitionSpec`` entries); ``()`` replicates."""
    if name not in _RULES:
        return ()
    spec = []
    for r in _RULES[name]:
        if r == "dp":
            spec.append(dp_axes(axes))
        elif r == "tp":
            spec.append(tp_axis(axes))
        elif r == "ep":
            spec.append(tp_axis(axes) if ep_ok else None)
        elif r == "tp_or_none":
            spec.append(None if ep_ok else tp_axis(axes))
        else:
            spec.append(None)
    spec = [None] * (len(shape) - len(spec)) + spec
    # jit in_shardings (and DTensor's even shards) need divisibility: an
    # entry whose axis product does not divide the dim replicates that dim
    return tuple(s if d % _axis_product(s, sizes) == 0 else None
                 for s, d in zip(spec, shape))


def placements(spec: tuple, axis_names: Sequence[str]) -> tuple:
    """DTensor placements of a spec, one per mesh dimension: ``Shard(d)``
    where tensor dim ``d`` is split over the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_names:
        dims = [d for d, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _leaf_specs(params, num_experts: int, serve_pure_tp: bool, leaf):
    axes = active_mesh_axes()
    am = ambient_mesh()
    sizes = am.shape if am is not None else {}
    tp_n = sizes.get("model", 1)
    ep_ok = num_experts > 0 and tp_n > 1 and num_experts % tp_n == 0
    dp = dp_axes(axes)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        spec = _spec_for(name, tree.shape, axes, sizes, ep_ok)
        if serve_pure_tp:
            spec = tuple(None if (s == dp or s in ("pod", "data")) else s for s in spec)
        return leaf(spec)

    return walk(params)


def param_specs(params, num_experts: int = 0, serve_pure_tp: bool = False):
    """Tree of spec tuples matching ``params`` (tensors, meta tensors too),
    by the naming convention of :mod:`repro_torch.models`, under the active
    mesh.  ``serve_pure_tp`` drops the FSDP (dp) factor: pure tensor
    parallelism, for decode, which moves one token against all weights."""
    return _leaf_specs(params, num_experts, serve_pure_tp, lambda spec: spec)


def param_pspecs(params, num_experts: int = 0, serve_pure_tp: bool = False):
    """:func:`param_specs` as DTensor placements (a tuple per leaf, one
    placement per dimension of the active mesh)."""
    am = ambient_mesh()
    names = am.axis_names if am is not None else ()
    return _leaf_specs(params, num_experts, serve_pure_tp,
                       lambda spec: placements(spec, names))
