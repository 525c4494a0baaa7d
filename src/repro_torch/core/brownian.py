"""Counter-based Brownian sample path (port of :mod:`repro.core.brownian`,
the ``levy_area=None`` fixed-grid part).

:class:`BrownianPath` is defined by its key: the increment of step ``n`` of
an ``num_steps`` grid is ``normal(fold_in(key, n), shape)·sqrt(dt)``, a pure
function of ``(key, n)`` — no storage, bitwise the same on every query.

Batching.  The reference builds one path per key under ``jax.vmap``.  Here
``key`` is a ``(*K, 2)`` int64 tensor and every query returns
``(*K, *shape)``: row ``k`` is what the reference's path for ``key[k]``
gives (within the float tolerance of tests/test_torch_brownian.py; the
bits and counters are exact).  On CUDA keys the draw runs in the
``brownian_increment`` kernel; on CPU keys in the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import ops


class AdaptiveSliceNotPortedError(NotImplementedError):
    """Off-grid Brownian queries arrive with the adaptive driver's port."""


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
            raise AdaptiveSliceNotPortedError(
                "levy_area='space-time' (the srk solver's (W, H) pairs) is not "
                "ported yet — ROADMAP.md Queue 1, item 10")
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

    def evaluate(self, s, t, depth: int = 24):
        raise AdaptiveSliceNotPortedError(
            "BrownianPath.evaluate (Lévy-bridge descent, the brownian_value "
            "kernel) is ported with the adaptive driver — ROADMAP.md Queue 1, "
            "item 8; fixed-grid solves use increment(n, num_steps)")

    def value(self, t, depth: int = 24):
        raise AdaptiveSliceNotPortedError(
            "BrownianPath.value (Lévy-bridge descent, the brownian_value "
            "kernel) is ported with the adaptive driver — ROADMAP.md Queue 1, "
            "item 8; fixed-grid solves use increment(n, num_steps)")
