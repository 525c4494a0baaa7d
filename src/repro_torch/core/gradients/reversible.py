"""Reversible Heun with the paper's exact O(1)-memory adjoint (port of
:mod:`repro.core.gradients.reversible`: ``_gen_spec``, ``_forward``,
``_fwd_rule``, ``_bwd_rule``, ``_bwd_rule_final``, ``_fused_local_vjp``,
and the adaptive ``reversible_heun_solve_adaptive`` with
``_fwd_rule_adaptive`` / ``_bwd_rule_adaptive``).

The reference wraps the solve in a ``jax.custom_vjp``; here it is a
``torch.autograd.Function``.  The forward runs Algorithm 1 under
``torch.no_grad()`` and saves only the terminal :class:`RevHeunState`, the
parameter leaves and (on the Function's context) the Brownian path.  The
backward walks the grid right to left: it re-draws each step's ΔW from the
path's key, reconstructs the step's left state in closed form (Algorithm 2),
and pulls **one** ``torch.autograd.grad`` of the fields per step.  Where the
forward draws inside its phase-1 kernel (:func:`_gen_spec`), so does the
reconstruction: one ``rev_heun_phase1_gen`` launch at ``sign = -1`` gives the
step's left ẑ and its ΔW, which the rest of the step consumes; otherwise
the path's ``increment`` re-draws it.  Each step's graph is freed
before the next, so memory does not grow with ``num_steps``.

Parameters.  The params tree is flattened into tensor inputs of ``apply``
(:mod:`repro_torch.tree`), so gradients reach non-leaf parameters too —
the Latent SDE's encoder context ``ctx`` is the GRU's output.  Leaves the
fields do not read get zero gradients.

Fused vs unfused.  With ``use_pallas`` and diagonal noise the local VJP is
the hand-derived transpose (:func:`_fused_local_vjp`): the phase kernels
recompute ẑ₁, ``rev_heun_bwd_phase1`` seeds the field VJP,
``rev_heun_bwd_phase2`` distributes its result.  Otherwise it is autograd
of the unfused :func:`reversible_heun_step`.  The two agree bitwise: the
kernels keep the transpose's grouping, and the ẑ₁ cotangent sum takes the
``g_zh`` seed first in both, because autograd's graph root delivers it
before any field contribution arrives (tests/test_torch_adjoint.py pins
the identity in float64).

Times.  Every field is evaluated at a grid time ``t0 + k·dt`` rounded once
(:func:`repro_torch.core.solvers.grid_time`), a numpy scalar of the state
dtype: the forward's step ``n`` at ``k = n+1``, the backward's
reconstruction at ``k = n`` and its local forward at ``k = n+1``.  These are
the bits the compiled reference evaluates (XLA contracts its ``t0 + (n+1)·dt
− dt`` into fused multiply-adds), which matters because the posterior's
context lookup turns ``t`` into an integer index.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.autograd.function import once_differentiable

from ... import tree
from ...kernels import ops
from ..brownian import BrownianPath
from ..solvers import (
    RevHeunState,
    grid_time,
    reversible_heun_reverse_step,
    reversible_heun_step,
    time_dtype,
)
from .base import GradientBackend, register_backend

def _gen_spec(bm, z0, noise, use_pallas):
    """``(keys, dt_grid_fn)`` for in-kernel ΔW generation, or ``None``.

    Legal only where the in-kernel draw is bitwise ``bm.increment(n,
    num_steps)``: a counter-keyed :class:`BrownianPath` in the state dtype,
    shaped like the state (diagonal noise)."""
    if not (use_pallas and noise == "diagonal" and type(bm) is BrownianPath):
        return None
    if bm.dtype != z0.dtype:
        return None
    if bm.batch_shape + bm.local_shape != tuple(z0.shape):
        return None
    return bm.key, lambda num_steps: (bm.t1 - bm.t0) / num_steps, bm.window


def _forward(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
             use_pallas=False, save_trajectory=True):
    """Algorithm 1 over the uniform grid -> ``(trajectory or None, final
    state)``.  Without ``save_trajectory`` no state outlives its step, so
    the terminal form holds O(1) states in the forward too."""
    dtype = z0.dtype
    np_dtype = time_dtype(dtype)
    dt = np_dtype((t1 - t0) / num_steps)
    state = RevHeunState(z0, z0, drift(params, t0, z0), diffusion(params, t0, z0))
    gen = _gen_spec(bm, z0, noise, use_pallas)
    zs = [z0] if save_trajectory else None
    for n in range(num_steps):
        t, t1_n = grid_time(t0, n, dt), grid_time(t0, n + 1, dt)
        if gen is not None:
            keys, dt_grid_fn, window = gen
            state = reversible_heun_step(state, t, dt, None, drift, diffusion, params,
                                         noise, use_pallas=use_pallas,
                                         gen=(keys, n, dt_grid_fn(num_steps), window),
                                         t1=t1_n)
        else:
            dw = bm.increment(n, num_steps).to(dtype)
            state = reversible_heun_step(state, t, dt, dw, drift, diffusion, params,
                                         noise, use_pallas=use_pallas, t1=t1_n)
        if zs is not None:
            zs.append(state.z)
    return (None if zs is None else torch.stack(zs)), state


def _vjp(outputs, inputs, cotangents):
    """``torch.autograd.grad`` of the outputs that depend on anything (a
    field may be a constant, e.g. additive noise ``σ = c``)."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    if not pairs:
        return [None] * len(inputs)
    outs, cts = zip(*pairs)
    return torch.autograd.grad(outs, inputs, cts, allow_unused=True)


def _grads_or_zeros(grads, like):
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, like)]


def _fused_local_vjp(drift, diffusion, params, wrt, state0, cts, t_right, dt, dw):
    """Hand-derived VJP of one Algorithm-1 step, elementwise phases in the
    kernels, one field VJP at ``t_right``.  ``state0`` is the step's
    reconstructed left state; ``cts = (g_z, g_zh, g_mu, g_sigma)`` the
    step-``n+1`` cotangents.  Returns ``(d_params, (d_z, d_zh, d_mu,
    d_sigma))``."""
    g_z, g_zh, g_mu, g_sigma = cts
    # ẑ₁ recomputed from the left state: the bits the unfused local forward
    # produces internally (state1.zh has drifted through reconstruction).
    zh1 = ops.rev_heun_phase1(state0.z, state0.zh, state0.mu, state0.sigma, dw, dt)
    c_mu1, c_sig1 = ops.rev_heun_bwd_phase1(g_z, g_mu, g_sigma, dw, dt)
    with torch.enable_grad():
        x = zh1.requires_grad_()
        mu1 = drift(params, t_right, x)
        sigma1 = diffusion(params, t_right, x)
        # x itself is an output seeded with g_zh: the graph root delivers that
        # seed before the field contributions, as in the unfused graph.
        grads = _vjp((x, mu1, sigma1), [*wrt, x], (g_zh, c_mu1, c_sig1))
    ghat = grads[-1].contiguous()
    return grads[:-1], ops.rev_heun_bwd_phase2(g_z, ghat, dw, dt)


def _local_vjp(drift, diffusion, params, wrt, state0, cts, t_left, t_right, dt, dw,
               noise):
    """Autograd of the unfused step from the reconstructed left state."""
    with torch.enable_grad():
        s = [x.detach().requires_grad_() for x in state0]
        out = reversible_heun_step(RevHeunState(*s), t_left, dt, dw, drift, diffusion,
                                   params, noise, t1=t_right)
        grads = _vjp(tuple(out), [*wrt, *s], cts)
    return grads[:len(wrt)], tuple(_grads_or_zeros(grads[len(wrt):], s))


@dataclasses.dataclass(frozen=True)
class _SolveSpec:
    """The non-tensor arguments of one solve (the reference's nondiff args)."""

    drift: Callable
    diffusion: Callable
    treespec: Any
    bm: Any
    t0: float
    t1: float
    num_steps: int
    noise: str
    use_pallas: bool
    save_trajectory: bool


def _backward_leaves(treespec, leaves, needs):
    """The backward's parameter leaves -> ``(leaves, the ones to
    differentiate, the params tree, zeroed gradient accumulators)``."""
    p_leaves = [leaf.detach().requires_grad_(need and leaf.is_floating_point())
                for leaf, need in zip(leaves, needs)]
    wrt = [leaf for leaf in p_leaves if leaf.requires_grad]
    return p_leaves, wrt, tree.unflatten(treespec, p_leaves), [torch.zeros_like(p)
                                                               for p in wrt]


def _backward(spec: _SolveSpec, final: RevHeunState, leaves, needs, g_out):
    """Algorithm 2 sweep -> ``(g_z0, [g_leaf or None])``."""
    N = spec.num_steps
    np_dtype = time_dtype(final.z.dtype)
    dt = np_dtype((spec.t1 - spec.t0) / N)
    p_leaves, wrt, params, g_params = _backward_leaves(spec.treespec, leaves, needs)
    g_out = g_out.contiguous()
    zeros = torch.zeros_like(final.z)
    g_z = g_out[N] if spec.save_trajectory else g_out
    cts = (g_z, zeros, zeros, torch.zeros_like(final.sigma))
    fused = spec.use_pallas and spec.noise == "diagonal"
    gen = _gen_spec(spec.bm, final.z, spec.noise, spec.use_pallas)
    state = final
    for n in range(N - 1, -1, -1):
        t_left, t_right = grid_time(spec.t0, n, dt), grid_time(spec.t0, n + 1, dt)
        with torch.no_grad():
            if gen is not None:
                keys, dt_grid_fn, window = gen
                state, dw = reversible_heun_reverse_step(
                    state, t_right, dt, None, spec.drift, spec.diffusion, params, spec.noise,
                    use_pallas=spec.use_pallas, t0=t_left,
                    gen=(keys, n, dt_grid_fn(N), window))
            else:
                dw = spec.bm.increment(n, N).to(final.z.dtype)
                state = reversible_heun_reverse_step(state, t_right, dt, dw, spec.drift,
                                                     spec.diffusion, params, spec.noise,
                                                     use_pallas=spec.use_pallas, t0=t_left)
        if fused:
            d_params, d_state = _fused_local_vjp(spec.drift, spec.diffusion, params, wrt,
                                                 state, cts, t_right, dt, dw)
        else:
            d_params, d_state = _local_vjp(spec.drift, spec.diffusion, params, wrt,
                                           state, cts, t_left, t_right, dt, dw, spec.noise)
        for g, d in zip(g_params, d_params):
            if d is not None:
                g.add_(d)
        d_z = d_state[0] + g_out[n] if spec.save_trajectory else d_state[0]
        cts = (d_z, *d_state[1:])
    return _initial_vjp(spec.drift, spec.diffusion, params, wrt, g_params, p_leaves,
                        state.z, spec.t0, cts)


def _initial_vjp(drift, diffusion, params, wrt, g_params, p_leaves, z0, t0, cts):
    """Close the sweep at the initial condition (ẑ₀ = z₀, μ₀ = drift(t0, z₀),
    σ₀ = diffusion(t0, z₀)) -> ``(g_z0, [g_leaf or None])``."""
    with torch.enable_grad():
        z0 = z0.detach().requires_grad_()
        outs = (z0, z0, drift(params, t0, z0), diffusion(params, t0, z0))
        grads = _vjp(outs, [*wrt, z0], cts)
    for g, d in zip(g_params, grads[:-1]):
        if d is not None:
            g.add_(d)
    it = iter(g_params)
    return grads[-1], [next(it) if leaf.requires_grad else None for leaf in p_leaves]


class _ReversibleAdjoint(torch.autograd.Function):
    """``apply(spec, z0, *param_leaves)`` -> trajectory or terminal value."""

    @staticmethod
    def forward(ctx, spec, z0, *leaves):
        params = tree.unflatten(spec.treespec, leaves)
        traj, final = _forward(spec.drift, spec.diffusion, params, z0, spec.bm, spec.t0,
                               spec.t1, spec.num_steps, spec.noise, spec.use_pallas,
                               spec.save_trajectory)
        ctx.spec = spec
        # O(1)-in-depth residuals: the terminal state and the parameters.
        ctx.save_for_backward(*final, *leaves)
        return traj if spec.save_trajectory else final.z.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        saved = ctx.saved_tensors
        final, leaves = RevHeunState(*saved[:4]), saved[4:]
        g_z0, g_leaves = _backward(ctx.spec, final, leaves, ctx.needs_input_grad[2:], g_out)
        return (None, g_z0 if ctx.needs_input_grad[1] else None, *g_leaves)


def _flat_tensor_leaves(params):
    leaves, treespec = tree.flatten(params)
    bad = [type(x).__name__ for x in leaves if not isinstance(x, torch.Tensor)]
    if bad:
        raise TypeError(f"reversible_adjoint: every parameter leaf must be a tensor, "
                        f"got {bad}")
    return leaves, treespec


def _apply(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise, use_pallas,
           save_trajectory):
    leaves, treespec = _flat_tensor_leaves(params)
    spec = _SolveSpec(drift, diffusion, treespec, bm, t0, t1, num_steps, noise,
                      use_pallas, save_trajectory)
    return _ReversibleAdjoint.apply(spec, z0, *leaves)


def reversible_heun_solve(drift, diffusion, params, z0, bm, t0, t1, num_steps,
                          noise="diagonal", use_pallas=False):
    """Trajectory ``(num_steps+1, *z0.shape)`` (index 0 is ``z0``); exact
    O(1)-memory gradients for any loss on any subset of it."""
    return _apply(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
                  use_pallas, True)


def reversible_heun_solve_final(drift, diffusion, params, z0, bm, t0, t1,
                                num_steps, noise="diagonal", use_pallas=False):
    """Terminal value only, with the same exact backward."""
    return _apply(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise,
                  use_pallas, False)


# =============================================================================
# Adaptive reversible Heun with the exact adjoint over the accepted grid
# =============================================================================
#
# The forward (repro_torch.core.solve._adaptive_loop) accepts steps on a
# controller-chosen grid and stores only the accepted (ts, dts): O(max_steps)
# scalars, no trajectory.  The backward walks the accepted steps right to
# left and re-derives each one's ΔW as value(ts[i] + dts[i]) − value(ts[i]):
# the forward formed t + dt with the same tensor op, in the same dtype, on
# the same device, so the replayed ΔW is bitwise the one the step consumed.
# Rejected attempts never enter the buffers.


@dataclasses.dataclass(frozen=True)
class _AdaptiveSpec:
    """The non-tensor arguments of one adaptive solve."""

    drift: Callable
    diffusion: Callable
    treespec: Any
    bm: Any
    rtol: Any
    atol: Any
    t0: float
    t1: float
    max_steps: int
    dt0: float
    noise: str
    use_pallas: bool
    bridge_depth: Any


def _backward_adaptive(spec: _AdaptiveSpec, final: RevHeunState, ts, dts, n_acc,
                       leaves, needs, g_z):
    """Algorithm 2 over the accepted grid -> ``(g_z0, [g_leaf or None])``."""
    n = int(n_acc)
    fused = spec.use_pallas and spec.noise == "diagonal"
    dts_host = dts[:n].tolist() if fused else None  # the kernels' scalar step sizes
    dkw = {} if spec.bridge_depth is None else {"depth": spec.bridge_depth}
    p_leaves, wrt, params, g_params = _backward_leaves(spec.treespec, leaves, needs)
    zeros = torch.zeros_like(final.z)
    cts = (g_z.contiguous(), zeros, zeros, torch.zeros_like(final.sigma))
    state = final
    for i in range(n - 1, -1, -1):
        t_left = ts[i]
        t_right = t_left + dts[i]  # the forward's t + dt_eff, op for op
        dw = (spec.bm.value(t_right, **dkw).to(final.z.dtype)
              - spec.bm.value(t_left, **dkw).to(final.z.dtype))
        dt = dts_host[i] if fused else dts[i]
        with torch.no_grad():
            state = reversible_heun_reverse_step(state, t_right, dt, dw, spec.drift,
                                                 spec.diffusion, params, spec.noise,
                                                 use_pallas=spec.use_pallas, t0=t_left)
        if fused:
            d_params, d_state = _fused_local_vjp(spec.drift, spec.diffusion, params, wrt,
                                                 state, cts, t_right, dt, dw)
        else:
            d_params, d_state = _local_vjp(spec.drift, spec.diffusion, params, wrt, state,
                                           cts, t_left, t_right, dt, dw, spec.noise)
        for g, d in zip(g_params, d_params):
            if d is not None:
                g.add_(d)
        cts = d_state
    return _initial_vjp(spec.drift, spec.diffusion, params, wrt, g_params, p_leaves,
                        state.z, spec.t0, cts)


class _ReversibleAdjointAdaptive(torch.autograd.Function):
    """``apply(spec, z0, *param_leaves)`` -> ``(z_T, converged)``."""

    @staticmethod
    def forward(ctx, spec, z0, *leaves):
        from ..solve import _adaptive_loop, get_solver

        params = tree.unflatten(spec.treespec, leaves)
        final, stats = _adaptive_loop(get_solver("reversible_heun"), spec.drift,
                                      spec.diffusion, params, z0, spec.bm, spec.t0,
                                      spec.t1, spec.rtol, spec.atol, spec.max_steps,
                                      spec.dt0, spec.noise, spec.use_pallas,
                                      spec.bridge_depth)
        ctx.spec = spec
        # O(max_steps) scalars beside the terminal state and the parameters
        ctx.save_for_backward(*final, stats.ts, stats.dts, stats.num_accepted, *leaves)
        ctx.mark_non_differentiable(stats.converged)
        return final.z.clone(), stats.converged

    @staticmethod
    @once_differentiable
    def backward(ctx, g_z, _g_converged):
        saved = ctx.saved_tensors
        final, (ts, dts, n_acc), leaves = RevHeunState(*saved[:4]), saved[4:7], saved[7:]
        g_z0, g_leaves = _backward_adaptive(ctx.spec, final, ts, dts, n_acc, leaves,
                                            ctx.needs_input_grad[2:], g_z)
        return (None, g_z0 if ctx.needs_input_grad[1] else None, *g_leaves)


def reversible_heun_solve_adaptive(drift, diffusion, params, z0, bm, rtol, atol, t0, t1,
                                   max_steps, dt0, noise="diagonal", use_pallas=False,
                                   bridge_depth=None):
    """``(z_T, converged)`` of the adaptive reversible-Heun solve, with the
    exact adjoint on ``z_T`` over the accepted grid.  One controller: ``bm``
    is a single-key path.  ``use_pallas`` runs the forward's state updates
    and the backward's reconstruction and cotangent phases in the kernels
    (diagonal noise)."""
    if bm.batch_shape:
        raise ValueError(
            f"the adaptive exact adjoint runs one controller per solve: pass a "
            f"single-key BrownianPath (got key batch {bm.batch_shape}; "
            f"solve_adaptive runs one controller per key row, forward only)")
    leaves, treespec = _flat_tensor_leaves(params)
    spec = _AdaptiveSpec(drift, diffusion, treespec, bm, rtol, atol, t0, t1, max_steps,
                         dt0, noise, use_pallas, bridge_depth)
    return _ReversibleAdjointAdaptive.apply(spec, z0, *leaves)


def _validate(spec, *, noise, save_trajectory, use_pallas, adaptive):
    if spec.name != "reversible_heun":
        raise ValueError(
            f"solver {spec.name!r} declares reversible_adjoint but the exact "
            f"adjoint is implemented for the reversible-Heun stepper only")


def _solve(spec, drift, diffusion, params, z0, bm, t0, t1, num_steps, *,
           noise, save_trajectory, use_pallas):
    fn = reversible_heun_solve if save_trajectory else reversible_heun_solve_final
    return fn(drift, diffusion, params, z0, bm, t0, t1, num_steps, noise, use_pallas)


def _solve_adaptive(spec, drift, diffusion, params, z0, bm, rtol, atol, t0, t1,
                    max_steps, dt0, *, noise, use_pallas, bridge_depth):
    return reversible_heun_solve_adaptive(drift, diffusion, params, z0, bm, rtol, atol,
                                          t0, t1, max_steps, dt0, noise, use_pallas,
                                          bridge_depth)


register_backend(GradientBackend(
    name="reversible_adjoint",
    summary="paper's exact adjoint: algebraic reversal, O(1) memory",
    solve=_solve,
    solve_adaptive=_solve_adaptive,
    validate=_validate,
))
