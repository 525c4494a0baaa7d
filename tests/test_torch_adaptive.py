"""The port's adaptive stepping (repro_torch.core.solve._adaptive_loop,
solve_adaptive, the adaptive exact adjoint, the SDE-GAN's adaptive
terminal sampler) against the JAX package, on the CPU.

Workload: the repo's adaptive benchmark problem at a small size
(benchmarks/solver_speed.py:207) — the stiffness-burst drift θ(t)(1−y) plus
0.05·MLP(y), diagonal σ = 0.05 — and the SDE-GAN generator.  Weights and
states come from numpy seeds.

What is held, and how tightly:
* the controller: per-row accepted and rejected counts EQUAL to the
  reference's, at bridge depth 10 (the workload's), float64 and float32;
  the terminal values within ADAPT_TOL (absolute), and in float64 the
  accepted grids too.  The two packages round the step arithmetic
  differently (XLA contracts into FMAs; pow and the mean's summation order
  are each library's own), so dt differs by ulps after the first step,
  and the controller feeds every dt back into the next: the grids drift
  apart step by step.  Measured on these inputs: float64 up to 1.7e-9 in
  ts (3 rows, rtol 1e-3, ~150 steps); float32 up to 5.4e-4 in z_T, while
  its grids part over the last steps (a dts 4.3× its reference's, 2.5e-2
  in ts, at rtol 3e-3), so no grid tolerance in float32 would hold
  anything: there the equal counts and the replay test below hold the
  controller.
* at the default bridge depth 24 the Brownian path is so rough at the
  finest level (slope ~2^12 across a cell) that those ulps grow by orders
  of magnitude per step and the grids part (ROADMAP.md Queue 3); there the
  floats downstream of a grid are held by REPLAY: the reference's own
  accepted grid fed to the port's frozen-grid solve gives its z_T within
  the fixed-grid trajectory tolerance (REPLAY_TOL).
* the exact adjoint: within 1e-12 relative of autograd through the frozen
  accepted grid (float64), and fused ≡ unfused bitwise; against the
  reference's custom_vjp within GRAD_TOL (float64, depth 10: its grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys
from repro import nn as jnn
from repro.core import sde as jax_sde
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.core.solve import solve as jax_solve
from repro.core.solve import solve_adaptive as jax_solve_adaptive
from repro_torch import nn, tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import sde
from repro_torch.core.brownian import BrownianPath
from repro_torch.core.gradients.discretise import solve_accepted_grid
from repro_torch.core.solve import solve, solve_adaptive

ADAPT_TOL = {"float32": {"grid": None, "z": 2e-3}, "float64": {"grid": 1e-8, "z": 1e-8}}
REPLAY_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
GRAD_TOL = dict(rtol=1e-8, atol=1e-10)
ADJOINT_RTOL = 1e-12
X, H = 3, 8
ATOL = 1e-5


def _mlp_params(dtype, seed=60):
    rng = np.random.default_rng(seed)
    return {"f": {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                              "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                             for a, b in ((X, H), (H, X))]}}


def _jax_fields():
    def drift(p, t, y):
        theta = 0.5 + 30.0 * jnp.exp(-(((t - 0.5) / 0.05) ** 2))
        return theta * (1.0 - y) + 0.05 * jnn.mlp(p["f"], y, jnn.lipswish, jnp.tanh)

    return drift, lambda p, t, y: 0.05 * jnp.ones_like(y)


def _torch_fields():
    def drift(p, t, y):
        # a row's time broadcasts over that row's state (one controller per row)
        t = torch.as_tensor(t, dtype=y.dtype)
        t = t.reshape(t.shape + (1,) * (y.dim() - t.dim()))
        theta = 0.5 + 30.0 * torch.exp(-(((t - 0.5) / 0.05) ** 2))
        return theta * (1.0 - y) + 0.05 * nn.mlp(p["f"], y, nn.lipswish, torch.tanh)

    return drift, lambda p, t, y: 0.05 * torch.ones_like(y)


def _z0(dtype, shape, seed=61):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(dtype)


def _jax_adaptive(params, z0, words, dtype, rtol, depth, per_row, max_steps=512):
    """The reference's solve_adaptive: one path per key (vmapped) when
    ``per_row``, else one key over the whole state."""
    shape = z0.shape[1:] if per_row else z0.shape
    with jax_config(x64=dtype == "float64"):
        def one(k, z):
            bm = JaxBrownianPath(k, 0.0, 1.0, shape, jnp.dtype(dtype))
            return jax_solve_adaptive(*_jax_fields(), params, z, bm, 0.0, 1.0, rtol=rtol,
                                      atol=ATOL, max_steps=max_steps, dt0=1 / 16,
                                      bridge_depth=depth)

        fn = jax.vmap(one) if per_row else one
        z, st = jax.jit(fn)(jnp.asarray(words), z0)
        return np.array(z), jax.tree.map(np.array, st)


def _port_adaptive(params, z0, words, dtype, rtol, depth, per_row, max_steps=512):
    shape = z0.shape[1:] if per_row else z0.shape
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, shape, TORCH_DTYPES[dtype])
    return solve_adaptive(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0), bm,
                          0.0, 1.0, rtol=rtol, atol=ATOL, max_steps=max_steps, dt0=1 / 16,
                          bridge_depth=depth), bm


@pytest.mark.parametrize("dtype,rtol,per_row", [
    ("float64", 3e-3, True), ("float64", 1e-3, True), ("float32", 3e-3, True),
    ("float32", 1e-2, True), ("float64", 3e-3, False), ("float32", 3e-3, False)])
def test_adaptive_loop_matches_jax_solve_adaptive(dtype, rtol, per_row):
    params = _mlp_params(dtype)
    if per_row:
        words, z0 = key_words(62, 3), _z0(dtype, (3, X))
    else:
        words, z0 = key_words(63, 1)[0], _z0(dtype, (4, X))
    want_z, want = _jax_adaptive(params, z0, words, dtype, rtol, 10, per_row)
    (got_z, got), _ = _port_adaptive(params, z0, words, dtype, rtol, 10, per_row)
    assert np.array_equal(got.num_accepted.numpy(), want.num_accepted)
    assert np.array_equal(got.num_rejected.numpy(), want.num_rejected)
    assert np.array_equal(got.nfe.numpy(), want.nfe)
    assert got.converged.all() and np.all(want.converged)
    assert got.iterations == int(np.max(want.num_accepted + want.num_rejected))
    tol = ADAPT_TOL[dtype]
    torch.testing.assert_close(got_z, torch.from_numpy(want_z), rtol=0.0, atol=tol["z"])
    for buf in ("ts", "dts") if tol["grid"] is not None else ():
        torch.testing.assert_close(getattr(got, buf), torch.from_numpy(getattr(want, buf)),
                                   rtol=0.0, atol=tol["grid"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_replay_of_the_reference_grid(dtype):
    """The reference's accepted (ts, dts) through the port's frozen-grid
    solve at the default bridge depth 24: its z_T within the fixed-grid
    tolerance; and the port's own grid replays to its own z_T bitwise."""
    params = _mlp_params(dtype)
    words, z0 = key_words(64, 1)[0], _z0(dtype, (4, X))
    depth = None
    want_z, want = _jax_adaptive(params, z0, words, dtype, 1e-2, depth, False)
    (got_z, got), bm = _port_adaptive(params, z0, words, dtype, 1e-2, depth, False)
    p, z = params_from_jax(params), torch.from_numpy(z0)
    n = int(want.num_accepted)
    replay = solve_accepted_grid(*_torch_fields(), p, z, bm, 0.0,
                                 torch.from_numpy(want.ts[:n]), torch.from_numpy(want.dts[:n]),
                                 bridge_depth=depth)
    torch.testing.assert_close(replay, torch.from_numpy(want_z), **REPLAY_TOL[dtype])
    n = int(got.num_accepted)
    own = solve_accepted_grid(*_torch_fields(), p, z, bm, 0.0, got.ts[:n], got.dts[:n],
                              bridge_depth=depth)
    assert torch.equal(own, got_z)


def _grads(fn, params, z0):
    leaves, spec = tree.flatten(params)
    leaves = [x.clone().requires_grad_() for x in leaves]
    z = z0.clone().requires_grad_()
    zT = fn(tree.unflatten(spec, leaves), z)
    return zT.detach(), torch.autograd.grad(torch.mean(zT ** 2), [z, *leaves])


def _port_solve(bm, fused, depth=10):
    def fn(p, z):
        return solve(*_torch_fields(), p, z, bm, 0.0, 1.0, 16,
                     gradient_mode="reversible_adjoint", save_trajectory=False,
                     adaptive=True, rtol=1e-2, atol=ATOL, max_steps=512,
                     bridge_depth=depth, use_pallas_kernels=fused)
    return fn


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adaptive_adjoint_fused_equals_unfused_and_frozen_grid_autograd(dtype):
    params = params_from_jax(_mlp_params(dtype))
    z0 = torch.from_numpy(_z0(dtype, (4, X)))
    bm = BrownianPath(torch_keys(key_words(65, 1)[0]), 0.0, 1.0, (4, X), TORCH_DTYPES[dtype])
    z_u, g_u = _grads(_port_solve(bm, False), params, z0)
    z_f, g_f = _grads(_port_solve(bm, True), params, z0)
    assert torch.equal(z_u, z_f)
    assert all(torch.equal(a, b) for a, b in zip(g_u, g_f))
    _, st = solve_adaptive(*_torch_fields(), params, z0, bm, 0.0, 1.0, rtol=1e-2, atol=ATOL,
                           max_steps=512, dt0=1 / 16, bridge_depth=10)
    n = int(st.num_accepted)
    z_r, g_r = _grads(lambda p, z: solve_accepted_grid(
        *_torch_fields(), p, z, bm, 0.0, st.ts[:n], st.dts[:n], bridge_depth=10), params, z0)
    assert torch.equal(z_r, z_u)
    if dtype == "float64":
        for a, b in zip(g_u, g_r):
            assert ((a - b).abs().max() / b.abs().max()).item() <= ADJOINT_RTOL


def test_adaptive_adjoint_matches_jax_custom_vjp():
    params = _mlp_params("float64")
    words, z0 = key_words(66, 1)[0], _z0("float64", (4, X))
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (4, X), torch.float64)
    z_got, g_got = _grads(_port_solve(bm, False), params_from_jax(params),
                          torch.from_numpy(z0))
    with jax_config(x64=True):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, (4, X), jnp.float64)

        def loss(p, z):
            zT = jax_solve(*_jax_fields(), p, z, jbm, 0.0, 1.0, 16,
                           gradient_mode="reversible_adjoint", save_trajectory=False,
                           adaptive=True, rtol=1e-2, atol=ATOL, max_steps=512,
                           bridge_depth=10)
            return jnp.mean(zT ** 2)

        g_p, g_z = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, z0)
        want = [np.array(g_z)] + [np.array(x) for x in jax.tree.leaves(g_p)]
    for got, w in zip(g_got, want):
        torch.testing.assert_close(got, torch.from_numpy(w), **GRAD_TOL)


def test_budget_exhaustion_poisons_solve_and_flags_solve_adaptive():
    params = params_from_jax(_mlp_params("float32"))
    z0 = torch.from_numpy(_z0("float32", (4, X)))
    bm = BrownianPath(torch_keys(key_words(67, 1)[0]), 0.0, 1.0, (4, X))
    out = solve(*_torch_fields(), params, z0, bm, 0.0, 1.0, 16, save_trajectory=False,
                adaptive=True, rtol=1e-3, atol=ATOL, max_steps=8, bridge_depth=10)
    assert torch.isnan(out).all()
    z, st = solve_adaptive(*_torch_fields(), params, z0, bm, 0.0, 1.0, rtol=1e-3, atol=ATOL,
                           max_steps=8, bridge_depth=10)
    assert not bool(st.converged) and int(st.num_accepted) <= 8
    assert float(st.t_final) < 1.0 and torch.isfinite(z).all()
    # per row: a row out of budget is frozen, the others run on to t1
    rows = BrownianPath(torch_keys(key_words(68, 3)), 0.0, 1.0, (X,))
    z3 = torch.from_numpy(_z0("float32", (3, X)))
    _, full = solve_adaptive(*_torch_fields(), params, z3, rows, 0.0, 1.0, rtol=3e-3,
                             atol=ATOL, max_steps=512, bridge_depth=10)
    cap = int(full.num_accepted.min())
    _, capped = solve_adaptive(*_torch_fields(), params, z3, rows, 0.0, 1.0, rtol=3e-3,
                               atol=ATOL, max_steps=cap, bridge_depth=10)
    assert capped.converged.tolist() == (full.num_accepted <= cap).tolist()


def test_discretise_adaptive_is_forward_only():
    params = params_from_jax(_mlp_params("float64"))
    z0 = torch.from_numpy(_z0("float64", (4, X)))
    bm = BrownianPath(torch_keys(key_words(69, 1)[0]), 0.0, 1.0, (4, X), torch.float64)
    kw = dict(save_trajectory=False, adaptive=True, rtol=1e-2, atol=ATOL, bridge_depth=10)
    exact = solve(*_torch_fields(), params, z0, bm, 0.0, 1.0, 16,
                  gradient_mode="reversible_adjoint", **kw)
    w = params["f"]["layers"][0]["w"].requires_grad_()
    fwd = solve(*_torch_fields(), params, z0, bm, 0.0, 1.0, 16, gradient_mode="discretise",
                **kw)
    assert torch.equal(fwd.detach(), exact)
    with pytest.raises(ValueError, match="forward-only for adaptive solves"):
        torch.autograd.grad(fwd.sum(), w)


# -----------------------------------------------------------------------------
# the SDE-GAN generator's adaptive terminal sampler
# -----------------------------------------------------------------------------

GAN = dict(data_dim=1, hidden_dim=5, noise_dim=3, initial_noise_dim=2, width=8, depth=1,
           num_steps=8, t1=1.0)


def _gan_params(dtype, seed=70):
    rng = np.random.default_rng(seed)

    def net(sizes, scale=1.0):
        return {"layers": [{"w": (scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    h, w, n = GAN["hidden_dim"], GAN["width"], GAN["noise_dim"]
    return {"zeta": net([GAN["initial_noise_dim"], w, h]), "mu": net([1 + h, w, h]),
            "sigma": net([1 + h, w, h * n], 0.2),
            "ell": {"w": (rng.standard_normal((h, 1)) / np.sqrt(h)).astype(dtype),
                    "b": np.zeros(1, dtype)}}


@pytest.mark.parametrize("rtol", [1e-2, 3e-3])
def test_generator_sample_terminal_matches_jax(rtol):
    """float64, the reference's own bridge depth (24): convergence flags
    equal; samples within 2·rtol (each side's global error at tolerance
    rtol, on grids that part at this depth — see the module docstring);
    and each row's reference grid, replayed in the port, gives that
    solve's sample within the fixed-grid tolerance.  (Two compilations of
    the reference itself part the same way, so the replay is held against
    the solve whose grid it replays.)"""
    params = _gan_params("float64")
    with jax_config(x64=True):
        jcfg = jax_sde.NeuralSDEConfig(**GAN, dtype=jnp.float64)
        jkeys = jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(71), j))(
            jnp.arange(3))
        want_y, want_conv = jax.jit(lambda p, k: jax_sde.generator_sample_terminal(
            p, jcfg, k, rtol, 1e-6, max_steps=256))(params, jkeys)

        def one(k):  # the sampler's solve, for its accepted grid
            kv, kw = jax.random.split(k)
            v = jax.random.normal(kv, (jcfg.initial_noise_dim,), jcfg.dtype)
            x0 = jnn.mlp(params["zeta"], v, jnn.lipswish)
            bm = JaxBrownianPath(kw, 0.0, 1.0, (jcfg.noise_dim,), jcfg.dtype)
            xT, st = jax_solve_adaptive(jax_sde.gen_drift(jcfg), jax_sde.gen_diffusion(jcfg),
                                        params, x0, bm, 0.0, 1.0, rtol=rtol, atol=1e-6,
                                        max_steps=256, dt0=1 / 8, noise="general")
            return jnn.linear(params["ell"], xT), st

        solo_y, jst = jax.tree.map(np.array, jax.jit(jax.vmap(one))(jkeys))
        keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    cfg = sde.NeuralSDEConfig(**GAN, dtype=torch.float64)
    p = params_from_jax(params)
    y, conv, st = sde.generator_sample_terminal(p, cfg, keys, rtol, 1e-6, max_steps=256)
    assert y.shape == (3, 1) and st.iterations == int(
        (st.num_accepted + st.num_rejected).max())
    assert conv.tolist() == np.asarray(want_conv).tolist()
    torch.testing.assert_close(y, torch.from_numpy(np.array(want_y)), rtol=0.0, atol=2 * rtol)
    x0, bm = sde._generator_start(p, cfg, keys)
    for r in range(3):
        n = int(jst.num_accepted[r])
        row = BrownianPath(bm.key[r], 0.0, 1.0, (GAN["noise_dim"],), torch.float64)
        xT = solve_accepted_grid(sde.gen_drift(cfg), sde.gen_diffusion(cfg), p, x0[r], row,
                                 0.0, torch.from_numpy(jst.ts[r, :n]),
                                 torch.from_numpy(jst.dts[r, :n]), noise="general")
        torch.testing.assert_close(nn.linear(p["ell"], xT), torch.from_numpy(solo_y[r]),
                                   **REPLAY_TOL["float64"])
