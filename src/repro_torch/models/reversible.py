"""The reversible Heun update as a residual-stack wrapper (port of
:mod:`repro.models.reversible`).

The transformer layer stack read as an ODE with the layer-indexed vector
field ``F(θ_n, ·) = unit_n(x) − x``, integrated with the paper's own
reversible Heun scheme (σ = 0, Δt = 1)::

    ẑ_{n+1} = 2 z_n − ẑ_n + F(θ_n, ẑ_n)
    z_{n+1} = z_n + ½ (F(θ_n, ẑ_n) + F(θ_{n+1}, ẑ_{n+1}))

The update is algebraically reversible, so the backward reconstructs every
intermediate activation in closed form: training keeps O(1) activations in
depth, at one extra F evaluation per unit in the backward.  The gradients
are exact, through the SDE adjoint itself
(:func:`repro_torch.core.gradients.reversible.reversible_heun_solve_final`,
the reference's ``custom_vjp``).  Unit ``n`` is the field at times in
``[n, n + 1)``, the last unit past the end: the initial drift reads unit
0, step ``n`` unit ``min(n + 1, units − 1)``, as the reference's clipped
index.  ``cfg.reversible_residual=True`` selects it; the two-track scheme
is a different architecture than the vanilla stack, a model choice and
not an execution knob.

The state may be float32, float64 or bfloat16: the adjoint's time grid
runs in float32 for a bfloat16 state (:func:`repro_torch.core.solvers.
time_dtype`; the grid's times are the integers 0 … units, exact there),
and ``mu·Δt`` keeps the state's dtype, as the reference's weak-typed
Python ``Δt`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..core.gradients.reversible import reversible_heun_solve_final


@dataclasses.dataclass(frozen=True)
class ZeroPath:
    """A Brownian-path stand-in whose increments are identically zero: the
    SDE machinery in its deterministic (ODE / resnet) case."""

    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    def increment(self, n, num_steps: int) -> torch.Tensor:
        return torch.zeros((), dtype=self.dtype, device=self.device)


def reversible_stack(cfg: ArchConfig, stacked_units, x, unit_residual) -> torch.Tensor:
    """Run the unit stack reversibly.  ``unit_residual(uparams, cfg, x) ->
    F`` returns one unit's residual delta for the unit's blocks
    ``uparams`` (views of ``stacked_units``).  Returns the final hidden
    state; nothing O(depth) is kept for the backward."""
    from .transformer import _layer, num_units

    n = num_units(cfg)

    def drift(p, t, z):
        return unit_residual(_layer(p, min(max(int(t), 0), n - 1)), cfg, z)

    def diffusion(p, t, z):
        return torch.zeros((), dtype=z.dtype, device=z.device)  # σ = 0: deterministic

    return reversible_heun_solve_final(drift, diffusion, stacked_units, x,
                                       ZeroPath(x.dtype, x.device), 0.0, float(n), n,
                                       "diagonal")
