"""Counter-based Brownian sample path (port of :mod:`repro.core.brownian`,
the ``levy_area=None`` part of ``BrownianPath``).

:class:`BrownianPath` is defined by its key: the increment of step ``n`` of
an ``num_steps`` grid is ``normal(fold_in(key, n), shape)·sqrt(dt)``, a pure
function of ``(key, n)`` — no storage, bitwise the same on every query.
Off-grid queries (``value``, ``evaluate``; the adaptive loop's) descend a
virtual dyadic tree by Lévy bridges, the paper's eq. (8), to ``depth``
levels: the ``brownian_value`` kernel on CUDA keys, its plain version on
CPU keys.

Batching.  The reference builds one path per key under ``jax.vmap``.  Here
``key`` is a ``(*K, 2)`` int64 tensor and every query returns
``(*K, *shape)``: row ``k`` is what the reference's path for ``key[k]``
gives (within the float tolerance of tests/test_torch_brownian.py; the
bits and counters are exact).  On CUDA keys the draw runs in the
``brownian_increment`` kernel; on CPU keys in the plain version.  Point
queries take one time per row: ``value(t)`` with ``t`` of shape ``K``
gives row ``k`` the reference path's ``value(t[k])``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import ops


class SpaceTimeLevyNotPortedError(NotImplementedError):
    """``levy_area="space-time"`` ((W, H) pairs for the srk solver) is not
    ported yet."""


LEVY_AREAS = (None, "space-time")


@dataclasses.dataclass(frozen=True)
class BrownianPath:
    """Exact, stateless Brownian path on ``[t0, t1]``, one per key row."""

    key: torch.Tensor
    t0: float
    t1: float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    levy_area: Optional[str] = None

    def __post_init__(self):
        if self.levy_area not in LEVY_AREAS:
            raise ValueError(f"unknown levy_area mode {self.levy_area!r}; "
                             f"supported: {LEVY_AREAS}")
        if self.levy_area is not None:
            raise SpaceTimeLevyNotPortedError(
                "levy_area='space-time' (the srk solver's (W, H) pairs) is not "
                "ported yet — ROADMAP.md Queue 1, "
                "'The rest of the Brownian layer, then space-time Lévy area and srk'")
        if self.key.dtype != torch.int64 or self.key.shape[-1:] != (2,):
            raise ValueError(f"key must be an int64 (..., 2) tensor, got "
                             f"{self.key.dtype} {tuple(self.key.shape)}")

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.key.shape[:-1])

    def increment(self, n: int, num_steps: int, use_kernel: Optional[bool] = None):
        """Increment of step ``n`` on the ``num_steps`` uniform grid."""
        dt = (self.t1 - self.t0) / num_steps
        return ops.brownian_increment(self.key, n, self.shape, self.dtype, dt,
                                      use_kernel=use_kernel)

    def increments(self, num_steps: int) -> torch.Tensor:
        """All grid increments stacked: ``(num_steps, *K, *shape)``."""
        return torch.stack([self.increment(n, num_steps) for n in range(num_steps)])

    def value(self, t, depth: int = 24):
        """``W(t) − W(t0)`` by one Lévy-bridge descent -> ``(*K, *shape)``.

        ``t``: a Python float, or a tensor of shape ``K`` (or broadcastable
        to it) holding each row's own time; a tensor on the path's device
        reaches the kernel without a copy to the host.  Contract (relied on
        by the adaptive loop, which carries the left endpoint's value):
        ``evaluate(s, t) == value(t) - value(s)`` bitwise."""
        K = self.batch_shape
        dev = self.key.device
        if isinstance(t, torch.Tensor):
            tt = t.to(device=dev, dtype=self.dtype).expand(K)
        else:
            tt = torch.full(K, float(t), dtype=self.dtype, device=dev)
        w = ops.brownian_value(self.key.reshape(-1, 2), tt.reshape(-1).contiguous(),
                               self.t0, self.t1, self.shape, self.dtype, depth)
        return w.reshape(K + tuple(self.shape))

    def evaluate(self, s, t, depth: int = 24):
        """``W(t) − W(s)``, as ``value(t) − value(s)``."""
        return self.value(t, depth) - self.value(s, depth)
