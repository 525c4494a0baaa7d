"""Elastic mesh re-planning after device loss (a copy of the pure-Python
:mod:`repro.distributed.elastic`, which the port does not import).

The policy: keep the model-parallel degree, shrink the data axis to the
largest value that fits the surviving device count, and re-balance the
global batch across the new data degree.  Deterministic data (batch =
f(key, step)) means a restarted run replays identical samples whatever the
new topology.  The train CLI prints the plan; the port runs one device.
"""

from __future__ import annotations

from typing import Tuple


def plan_mesh(num_devices: int, model_parallel: int = 16) -> Tuple[int, int]:
    """Largest ``(data, model)`` grid with ``data·model <= num_devices``;
    ``model`` shrinks only when fewer than ``model_parallel`` devices
    survive."""
    if num_devices < 1:
        raise ValueError("no surviving devices")
    model = min(model_parallel, num_devices)
    while model > 1 and num_devices // model == 0:
        model //= 2
    data = max(1, num_devices // model)
    return data, model


def rebatch(global_batch: int, data_degree: int) -> int:
    """Per-data-shard batch after an elastic resize (the global batch kept by
    raising the per-shard batch; exact when divisible, padded otherwise)."""
    return -(-global_batch // data_degree)


def surviving_devices(total: int, failed_hosts: int, devices_per_host: int = 8) -> int:
    return total - failed_hosts * devices_per_host
