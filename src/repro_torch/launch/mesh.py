"""Production mesh construction (port of :mod:`repro.launch.mesh`).

A FUNCTION, not a module-level constant: importing this module touches no
process group.  The layout is the reference's (TPU v5e pods):

  single pod : (data=16, model=16)              = 256 ranks
  multi-pod  : (pod=2, data=16, model=16)       = 512 ranks

``pod`` and ``data`` jointly carry batch/FSDP sharding, ``model`` the
tensor/expert-parallel shards.  :func:`make_production_mesh` returns that
plan as an abstract mesh (the rule tables read only its axes and sizes) and
builds the ``DeviceMesh`` only when the process group holds exactly that
many ranks.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from ..distributed.compat import abstract_mesh, make_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh(shape, axes):
    if _world() == math.prod(shape):
        return make_mesh(shape, axes)
    return abstract_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) plan: a concrete mesh where the process
    group has that many ranks, else the abstract one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_from_devices(num_devices: int, model_parallel: int = 16):
    """Elastic fallback: the best (data, model) factorisation of a surviving
    device count (:func:`repro_torch.distributed.elastic.plan_mesh`), built
    where the process group has that many ranks."""
    from ..distributed.elastic import plan_mesh

    data, model = plan_mesh(num_devices, model_parallel)
    return _mesh((data, model), ("data", "model"))
