"""Mesh planning and data parallelism (port of :mod:`repro.distributed`):
the elastic planner, the mesh APIs on ``torch.distributed``
(:mod:`.compat`) and the sharding rules and data-parallel collectives
(:mod:`.sharding`).  The package exports the reference's names."""

from .elastic import plan_mesh, rebatch, surviving_devices  # noqa: F401
from .sharding import (  # noqa: F401
    active_mesh_axes,
    batch_pspec,
    dp_axes,
    param_pspecs,
    tp_axis,
)
