"""Recursive checkpointing: exact gradients at O(log n) memory for every
registered solver (``gradient_mode="checkpoint"``) — port of
:mod:`repro.core.gradients.checkpoint`: ``checkpoint_solve``,
``checkpoint_solve_adaptive``, ``checkpoint_schedule`` (with ``_peak_live``
and ``_recompute``) and the backend glue.

The gradients are discretise-then-optimise gradients, exact to floating
point, recomputed instead of stored: the schedule is recursive halving.  A
level-``k`` runner advances ``2^k`` steps by running its level-``k-1``
runner twice, each call a :class:`_Segment` node that runs without a graph
and keeps only its entry carry.  Its backward re-runs the call with
autograd recording — the nested calls inside it are segments again, so
their insides are dropped at once — and pulls the cotangent through, one
half at a time: at most one root-to-leaf path of segment carries is live,
``2·depth + 1`` solver states, and each step is recomputed once per level
above it (:func:`checkpoint_schedule` counts both; the launch counts on
the card are held to it).  ``torch.utils.checkpoint`` is not used: its
non-reentrant form keeps a nested call's activations while it recomputes
the outer one (every step is recomputed once, so the recomputed half is
live whole), and its reentrant form cannot serve ``torch.autograd.grad``.
The parameters enter each segment as inputs, as the reference threads them
through its ``jax.checkpoint`` bodies.  ΔW is drawn inside the checkpointed region from the
counter-based path, so noise is regenerated, never stored.  A horizon that
is not a power of two pads the step index up to ``2^depth`` and masks the
surplus steps to the identity (a select, so their field evaluations get a
zero cotangent): the recompute counts are the reference's model.

Adaptive solves freeze and replay: the PI controller runs once without a
graph and fixes each row's accepted ``(ts, dts)``; the differentiable path
replays them under the same schedule, a row's steps past its own count
masked.  Each replayed step re-derives its increment as the loop formed it,
``value(t + dt) − value(t)`` (for a space-time path the pair
:func:`~repro_torch.core.brownian.stlevy_difference` of the two values,
zero over a padding slot's zero-length interval), so the replay is bitwise
the controller's forward.  The reference replays over the whole ``max_steps`` buffer; the
port reads the largest accepted count (one host read, after the
controller's own) and replays that many, padded to a power of two.

Terminal-value cotangents only: a trajectory output is itself the O(n)
memory this backend exists to avoid.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
from torch.autograd.function import once_differentiable

from ... import tree
from ..brownian import stlevy_difference
from ..solvers import (
    NP_DTYPES,
    RevHeunState,
    _tree_cast,
    carry_init,
    carry_z,
    grid_step,
    is_reversible,
)
from .base import GradientBackend, register_backend
from .reversible import _flat_tensor_leaves, _vjp

__all__ = ["checkpoint_schedule", "checkpoint_solve", "checkpoint_solve_adaptive"]


def _depth(num_steps: int) -> int:
    return max(0, math.ceil(math.log2(num_steps))) if num_steps > 1 else 0


def _select(keep, new, carry):
    """``new`` where ``keep`` (a bool tensor of the rows), else ``carry``."""
    def one(a, b):
        return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - keep.dim())), a, b)

    if isinstance(carry, RevHeunState):
        return RevHeunState(*(one(a, b) for a, b in zip(new, carry)))
    return one(new, carry)


def _split(carry):
    return tuple(carry) if isinstance(carry, RevHeunState) else (carry,)


def _join(parts):
    return RevHeunState(*parts) if len(parts) == 4 else parts[0]


class _Segment(torch.autograd.Function):
    """``apply(run, base, n_carry, treespec, *carry, *param_leaves)`` ->
    ``run(carry, params, base)``'s carry, computed without a graph; the
    backward recomputes it with one and pulls the cotangent through."""

    @staticmethod
    def forward(ctx, run, base, n_carry, treespec, *tensors):
        ctx.run, ctx.base, ctx.n_carry, ctx.treespec = run, base, n_carry, treespec
        ctx.save_for_backward(*tensors)
        out = run(_join(tensors[:n_carry]), tree.unflatten(treespec, tensors[n_carry:]), base)
        return _split(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_out):
        inputs = [x.detach().requires_grad_(need and x.is_floating_point())
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        n = ctx.n_carry
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = ctx.run(_join(inputs[:n]), tree.unflatten(ctx.treespec, inputs[n:]),
                          ctx.base)
            grads = iter(_vjp(_split(out), wrt, g_out))
        return (None, None, None, None,
                *(next(grads) if x.requires_grad else None for x in inputs))


def _chain(step, num_steps: int, params):
    """Compose ``num_steps`` steps under the recursive-halving schedule ->
    ``carry -> carry``.  ``step`` is ``(carry, params, i) -> carry`` and must
    mask ``i >= num_steps`` (the padding up to ``2^depth``) to the
    identity."""
    leaves, treespec = _flat_tensor_leaves(params)

    def runner(k):
        if k == 0:
            return step
        half = 2 ** (k - 1)
        inner = runner(k - 1)

        def run(carry, params_, base):
            p_leaves = tree.leaves(params_)
            for j in range(2):
                parts = _split(carry)
                carry = _join(_Segment.apply(inner, base + j * half, len(parts), treespec,
                                             *parts, *p_leaves))
            return carry

        return run

    top = runner(_depth(num_steps))
    return lambda carry: top(carry, tree.unflatten(treespec, leaves), 0)


def checkpoint_solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, noise):
    """Terminal value ``z_T``; autograd through it follows the halving
    schedule.  Each step is ``spec.stepper`` on the uniform grid, the same
    ops in the same order as the discretise loop, so the gradients agree
    with discretise-then-optimise to floating-point error."""
    dt = NP_DTYPES[z0.dtype]((t1 - t0) / num_steps)
    pad = torch.zeros((), dtype=torch.bool, device=z0.device)

    def step(carry, params_, i):
        j = min(i, num_steps - 1)  # the padding slots evaluate step N - 1 ...
        dw = _tree_cast(bm.increment(j, num_steps), z0.dtype)
        new = grid_step(spec.stepper, carry, t0, j, dt, dw, drift, diffusion, params_, noise)
        return new if i < num_steps else _select(pad, new, carry)  # ... masked out

    carry0 = carry_init(spec.stepper, drift, diffusion, params, z0, t0)
    return carry_z(_chain(step, num_steps, params)(carry0))


def checkpoint_solve_adaptive(spec, drift, diffusion, params, z0, bm, rtol, atol, t0, t1,
                              max_steps, dt0, noise, bridge_depth=None):
    """``(z_T, converged)`` over the controller's accepted grid: the loop runs
    once without a graph, then its accepted steps are replayed under the
    halving schedule (one controller per key row of ``bm``)."""
    from ..solve import _adaptive_loop, _rows

    with torch.no_grad():
        _, stats = _adaptive_loop(spec, drift, diffusion, params, z0, bm, t0, t1, rtol,
                                  atol, max_steps, dt0, noise, bridge_depth=bridge_depth)
    ts, dts, n_acc = stats.ts, stats.dts, stats.num_accepted
    n = max(int(n_acc.max()), 1)
    dkw = {} if bridge_depth is None else {"depth": bridge_depth}
    rev = is_reversible(spec.stepper)
    has_value = hasattr(bm, "value")
    levy = getattr(bm, "levy_area", None) == "space-time"

    def step(carry, params_, i):
        j = min(i, n - 1)
        t_left, dt = ts[..., j], dts[..., j]
        t_right = t_left + dt  # the loop's t + dt_eff, op for op
        if not has_value:
            dw = _tree_cast(bm.evaluate(t_left, t_right, **dkw), z0.dtype)
        elif levy:  # a row's padding slots (t, dt = 0) give the zero pair
            dw = stlevy_difference(_tree_cast(bm.value(t_left, **dkw), z0.dtype),
                                   _tree_cast(bm.value(t_right, **dkw), z0.dtype),
                                   t_left, t_right, bm.t0)
        else:
            dw = (bm.value(t_right, **dkw).to(z0.dtype)
                  - bm.value(t_left, **dkw).to(z0.dtype))
        kw = {} if rev else {"tm": t_left + 0.5 * dt}
        new = spec.stepper(carry, t_left, _rows(dt, z0), dw, drift, diffusion, params_,
                           noise, t1=t_right, **kw)
        return _select(n_acc > i, new, carry)

    carry0 = carry_init(spec.stepper, drift, diffusion, params, z0, t0)
    return carry_z(_chain(step, n, params)(carry0)), stats.converged


# =============================================================================
# The schedule's cost model (the memory and launch-count gates)
# =============================================================================


@lru_cache(maxsize=None)
def _peak_live(depth: int) -> int:
    """Most solver carries live at once while differentiating a level-``depth``
    runner (the leaf's own step residuals count as 1): each level holds its
    two entry carries while the backward recurses into one half,
    ``L(k) = 2 + L(k-1)``, ``L(0) = 1``."""
    if depth <= 0:
        return 1
    return 2 + _peak_live(depth - 1)


@lru_cache(maxsize=None)
def _recompute(depth: int) -> int:
    """Step evaluations the backward over a level-``depth`` runner adds: each
    of its two halves re-runs its inner forward (``2^(k-1)`` steps) before
    differentiating it, ``R(k) = 2·(2^(k-1) + R(k-1))``, ``R(0) = 0``, i.e.
    ``k·2^k``."""
    if depth <= 0:
        return 0
    return 2 * (2 ** (depth - 1) + _recompute(depth - 1))


def checkpoint_schedule(num_steps: int) -> dict:
    """The halving schedule's exact cost: ``padded_steps`` (``2^depth``, the
    forward's step count), ``depth`` (``ceil(log2 n)``), ``peak_live_states``
    (``2·depth + 1`` carries during the backward) and ``recompute_steps``
    (``depth · padded`` step evaluations the backward adds)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    depth = _depth(num_steps)
    return {
        "num_steps": num_steps,
        "padded_steps": 2 ** depth,
        "depth": depth,
        "peak_live_states": _peak_live(depth),
        "recompute_steps": _recompute(depth),
    }


# =============================================================================
# Backend registration
# =============================================================================


def _validate(spec, *, noise, save_trajectory, use_pallas, adaptive):
    if save_trajectory:
        raise ValueError(
            "gradient_mode='checkpoint' backpropagates a terminal-value "
            "cotangent only (a trajectory output is itself the O(n) "
            "memory this backend exists to avoid) — call solve(..., "
            "save_trajectory=False)")
    if use_pallas:
        raise ValueError(
            "use_pallas_kernels is incompatible with gradient_mode="
            "'checkpoint': the recomputed segments are differentiated by "
            "autograd, and the fused state updates' derivative is the "
            "hand-derived backward kernel pair of the reversible adjoint.  Use "
            "gradient_mode='reversible_adjoint' for the fused path")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    return checkpoint_solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, noise)


def _solve_adaptive(spec, drift, diffusion, params, z0, bm, rtol, atol, t0, t1,
                    max_steps, dt0, *, noise, use_pallas, bridge_depth):
    return checkpoint_solve_adaptive(spec, drift, diffusion, params, z0, bm, rtol, atol,
                                     t0, t1, max_steps, dt0, noise, bridge_depth=bridge_depth)


register_backend(GradientBackend(
    name="checkpoint",
    summary="recursive binomial checkpointing: exact gradients, "
            "O(log n) memory, O(n log n) recompute",
    solve=_solve,
    solve_adaptive=_solve_adaptive,
    validate=_validate,
))
