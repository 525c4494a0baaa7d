"""Control paths for CDEs (port of :mod:`repro.core.paths`): the SDE-GAN
discriminator consumes a path, paper eq. (2).

Anything exposing ``increment(n, num_steps)`` drives the port's solvers —
Brownian motion (:class:`repro_torch.core.brownian.BrownianPath`) or an
observed or generated data path interpolated piecewise-linearly (paper
§2.3: "equation (2) may be evaluated on an interpolation of the observed
data").  A data path carries no key and runs no kernel: its increments are
differences of the tensor it holds, so autograd reaches ``ys`` through them
(the gradient penalty differentiates the discriminator's score by its path
that way).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .solvers import NP_DTYPES


@dataclasses.dataclass(frozen=True)
class LinearPathControl:
    """Piecewise-linear interpolation of a discrete series ``ys`` (T+1, ..., d).

    ``increment(n, N)`` with ``N == T`` returns ``ys[n+1] - ys[n]`` — the
    control increment ``dY`` a CDE solver consumes on step ``n``; any other
    ``N`` re-grids ``N`` steps over the same span through :meth:`_eval`.
    """

    ys: torch.Tensor  # (T+1, ..., d), time leading

    def increment(self, n: int, num_steps: int) -> torch.Tensor:
        T = self.ys.shape[0] - 1
        if num_steps == T:
            return self.ys[n + 1] - self.ys[n]
        # re-gridding: num_steps steps over the same [0, 1] span, the
        # fractions in the path's dtype as the reference computes them
        # (float(n) / float(N), then × T)
        f = NP_DTYPES[self.ys.dtype]
        frac0 = f(n) / f(num_steps) * f(T)
        frac1 = f(n + 1) / f(num_steps) * f(T)
        return self._eval(frac1) - self._eval(frac0)

    def _eval(self, frac) -> torch.Tensor:
        T = self.ys.shape[0] - 1
        frac = np.clip(frac, 0, T)
        i0 = min(max(math.floor(frac), 0), T - 1)
        w = float(frac - type(frac)(i0))
        return self.ys[i0] * (1 - w) + self.ys[i0 + 1] * w
