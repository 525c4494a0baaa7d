"""Request type and the synthetic request stream (port of the parts of
:mod:`repro.serving.types` the trajectory drain loop uses)."""

from __future__ import annotations

import collections
import dataclasses

#: Seed for bucket-padding rows (their output is discarded; rows are
#: independent, so padding never reaches a client's rows).
PAD_SEED = 0x5EED_0DD


@dataclasses.dataclass
class Request:
    """One client ask: ``size`` trajectories keyed off ``seed``."""

    rid: int
    size: int
    seed: int

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"request {self.rid}: size must be >= 1, got {self.size}")


def synthetic_requests(n: int, max_size: int, seed: int):
    """Deterministic rollout stream: sizes cycle ``1..max_size``, seeds unique
    (the reference's stream with ``adaptive=False``)."""
    return collections.deque(
        Request(rid=i, size=1 + (i * 7 + seed) % max_size, seed=seed * 100_003 + i)
        for i in range(n))


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of a non-empty sample."""
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
    return xs[idx]
