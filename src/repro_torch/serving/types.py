"""Request and result types, the deadline classes and tolerance routing,
and the synthetic request stream (port of :mod:`repro.serving.types`).

A request carries ``deadline_ms``, the latency SLO its client bought; the
service maps it onto the loosest solver tolerance its deadline class
admits (:func:`route_rtol`), and adaptive terminal sampling runs each
batch at that tolerance.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Optional

import numpy as np

#: Seed for bucket-padding rows (their output is discarded; rows are
#: independent, so padding never reaches a client's rows).
PAD_SEED = 0x5EED_0DD


@dataclasses.dataclass
class Request:
    """One client ask: ``size`` trajectories (or terminal samples) keyed
    off ``seed``.

    ``deadline_ms`` picks the request's deadline class (``math.inf``: no
    SLO), which routes an adaptive batch's tolerance and, under
    ``Scheduler(preempt=True)``, makes the request realtime pressure (the
    tightest class) or lets it yield (the loosest); ``model_id`` names the
    registry entry that serves it (``"default"``: a single-model bundle,
    every upgraded v1 bundle); ``rtol`` is an optional explicit accuracy
    ask, a floor the batch never runs looser than; ``kind`` is
    ``"rollout"`` (a fixed-grid trajectory, chunked by the scheduler) or
    ``"terminal"`` (an adaptive terminal sample)."""

    rid: int
    size: int
    seed: int
    rtol: Optional[float] = None
    deadline_ms: float = math.inf
    model_id: str = "default"
    kind: str = "rollout"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"request {self.rid}: size must be >= 1, got {self.size}")
        if self.kind not in ("rollout", "terminal"):
            raise ValueError(f"request {self.rid}: kind must be 'rollout' or "
                             f"'terminal', got {self.kind!r}")
        if self.rtol is not None and self.rtol <= 0:
            raise ValueError(f"request {self.rid}: rtol must be positive, got {self.rtol}")


@dataclasses.dataclass
class ServeResult:
    """What the service hands back for one :class:`Request`.

    ``converged``: one bool per row; ``False`` marks an adaptive row whose
    controller ran out of budget before ``t1`` (its sample is the state at
    ``t_final < t1``).  ``rtol``: the tolerance the batch ran at.
    ``samples``: the payload on the CPU when the caller asked the scheduler
    to collect it (``(num_steps+1, size, data_dim)`` trajectories, or
    ``(size, data_dim)`` terminal samples), else None."""

    rid: int
    model_id: str
    size: int
    converged: Any
    latency_s: float
    deadline_ms: float = math.inf
    rtol: Optional[float] = None
    samples: Any = None

    @property
    def deadline_met(self) -> bool:
        """Whether the latency landed inside ``deadline_ms`` (always, with no SLO)."""
        return self.latency_s * 1e3 <= self.deadline_ms

    @property
    def num_converged(self) -> int:
        """How many of the rows converged (``size`` for fixed-grid rollouts)."""
        return int(np.sum(np.asarray(self.converged)))


@dataclasses.dataclass(frozen=True)
class DeadlineClass:
    """One SLO tier: deadlines up to ``max_deadline_ms`` (above the previous
    tier's), served at ``rtol``, the loosest tolerance the tier admits."""

    name: str
    max_deadline_ms: float
    rtol: float


#: The SLO ladder, tightest deadline first; a tighter deadline admits a
#: looser tolerance.  Class i covers (classes[i-1].max_deadline_ms,
#: classes[i].max_deadline_ms].
DEADLINE_CLASSES = (
    DeadlineClass("realtime", 50.0, 1e-2),
    DeadlineClass("interactive", 250.0, 3e-3),
    DeadlineClass("standard", 1000.0, 1e-3),
    DeadlineClass("relaxed", math.inf, 3e-4),
)


def deadline_class_for(deadline_ms: float, classes=DEADLINE_CLASSES) -> DeadlineClass:
    """The first class whose bound covers ``deadline_ms``."""
    for c in classes:
        if deadline_ms <= c.max_deadline_ms:
            return c
    return classes[-1]


def route_rtol(batch, classes=DEADLINE_CLASSES) -> float:
    """The tolerance one coalesced batch runs at: the loosest rtol its
    tightest deadline allows, never looser than an explicit ask in it."""
    if not batch:
        raise ValueError("route_rtol needs a non-empty batch")
    rtol = deadline_class_for(min(r.deadline_ms for r in batch), classes).rtol
    explicit = [r.rtol for r in batch if r.rtol is not None]
    if explicit:
        rtol = min(rtol, *explicit)
    return rtol


def synthetic_requests(n: int, max_size: int, seed: int, adaptive: bool = False,
                       model_id: str = "default"):
    """Deterministic request stream for ``model_id``: sizes cycle
    ``1..max_size``, seeds unique.  With ``adaptive`` the requests are
    terminal samples cycling through every deadline class (the unbounded
    class gets ten times the previous class's bound); otherwise rollouts
    with no deadline."""
    reqs = collections.deque()
    for i in range(n):
        kw = {}
        if adaptive:
            cls = DEADLINE_CLASSES[i % len(DEADLINE_CLASSES)]
            dl = (cls.max_deadline_ms if math.isfinite(cls.max_deadline_ms)
                  else 10 * DEADLINE_CLASSES[-2].max_deadline_ms)
            kw = dict(kind="terminal", deadline_ms=dl)
        reqs.append(Request(rid=i, size=1 + (i * 7 + seed) % max_size,
                            seed=seed * 100_003 + i, model_id=model_id, **kw))
    return reqs


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of a non-empty sample."""
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
    return xs[idx]
