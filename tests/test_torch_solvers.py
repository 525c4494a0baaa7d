"""The baseline solvers of the port (euler-maruyama, midpoint, heun and the
embedded pairs), its uniform-grid drivers (``sde_solve``, ``ode_solve``),
``solve_batched``, the solver registry and the stepper-generic adaptive
loop, against :mod:`repro.core.solvers` and :mod:`repro.core.solve` on the
CPU.  Inputs are made with numpy from fixed seeds.

Tolerances:
* one step: float32 rtol=1e-5, atol=1e-6; float64 rtol=1e-13, atol=1e-14
  (XLA contracts the step's products and sums into FMAs; the fields'
  sigmoid and tanh differ by ulps).
* trajectories: float32 rtol=2e-5, atol=2e-6; float64 rtol=1e-11,
  atol=1e-13 (tests/test_torch_solve.py's; the float64 bound holds for
  draws inside |z| < 3.3, which the tests assert).
* the adaptive loop: equal accepted and rejected counts at bridge depth 10,
  ``z_T`` within tests/test_torch_adaptive.py's tolerance.
* field times: exactly the compiled reference's, recorded in order through
  debug callbacks (every one a grid time ``k·dt`` or ``(k+½)·dt`` rounded
  once).
"""

import importlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys
from repro.core import solvers as jsolvers
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.nn.core import mlp as jax_mlp
from repro.nn.core import tcat as jax_tcat
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import BrownianPath
from repro_torch.core import solvers as tsolvers
from repro_torch.core.solve import (
    SOLVERS,
    gradient_capabilities,
    solve,
    solve_adaptive,
    solve_batched,
)
from repro_torch.nn import mlp, tcat

jsolve = importlib.import_module("repro.core.solve")  # the package exports solve()

DTYPES = ["float32", "float64"]
STEP_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-13, atol=1e-14)}
TRAJ_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
ADAPT_Z_TOL = {"float32": 2e-3, "float64": 1e-8}
D, W, WDIM, STEPS = 4, 8, 3, 8
BASELINES = ["euler_maruyama", "midpoint", "heun"]


def _params(dtype, noise="diagonal", seed=30):
    rng = np.random.default_rng(seed)

    def net(sizes):
        return {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    out = D if noise == "diagonal" else D * WDIM
    return {"mu": net([1 + D, W, D]), "sigma": net([1 + D, W, out])}


def _jax_fields(noise="diagonal"):
    drift = lambda p, t, z: jax_mlp(p["mu"], jax_tcat(t, z), final_activation=jnp.tanh)

    def diffusion(p, t, z):
        s = 0.3 * jax.nn.sigmoid(jax_mlp(p["sigma"], jax_tcat(t, z)))
        return s if noise == "diagonal" else s.reshape(z.shape[:-1] + (D, WDIM))

    return drift, diffusion


def _torch_fields(noise="diagonal"):
    drift = lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh)

    def diffusion(p, t, z):
        s = 0.3 * torch.sigmoid(mlp(p["sigma"], tcat(t, z)))
        return s if noise == "diagonal" else s.reshape(z.shape[:-1] + (D, WDIM))

    return drift, diffusion


def _to_np(x):
    return np.array(x)


# -----------------------------------------------------------------------------
# one step
# -----------------------------------------------------------------------------

STEPPERS = {
    "euler_maruyama": "_euler_maruyama_step",
    "midpoint": "_midpoint_step",
    "heun": "_heun_step",
    "midpoint_embedded": "_midpoint_embedded_step",
    "heun_embedded": "_heun_embedded_step",
}


@pytest.mark.parametrize("name,dtype,noise", [
    (name, dtype, "diagonal") for name in sorted(STEPPERS) for dtype in DTYPES]
    + [("midpoint_embedded", "float64", "general"), ("heun_embedded", "float64", "general"),
       ("euler_maruyama", "float64", "general")])
def test_stepper_matches_jax(name, dtype, noise):
    rng = np.random.default_rng(40)
    params = _params(dtype, noise)
    z = rng.standard_normal((3, D)).astype(dtype)
    t, dt = np.dtype(dtype).type(0.3), np.dtype(dtype).type(0.125)
    dw = (rng.standard_normal((3, D if noise == "diagonal" else WDIM)) * np.sqrt(dt)
          ).astype(dtype)
    fn = STEPPERS[name]
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(lambda p, z_, t_, dt_, dw_: getattr(jsolvers, fn)(
            z_, t_, dt_, dw_, *_jax_fields(noise), p, noise))(params, z, t, dt, dw)
    got = getattr(tsolvers, fn)(torch.from_numpy(z), t, dt, torch.from_numpy(dw),
                                *_torch_fields(noise), params_from_jax(params), noise)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(_to_np(w)), **STEP_TOL[dtype])


def test_fixed_grid_stepper_is_the_embedded_pair_without_its_estimate():
    params = params_from_jax(_params("float64"))
    z = torch.from_numpy(np.random.default_rng(41).standard_normal((2, D)))
    dw = torch.from_numpy(np.random.default_rng(42).standard_normal((2, D)) * 0.3)
    for step, pair in ((tsolvers._midpoint_step, tsolvers._midpoint_embedded_step),
                       (tsolvers._heun_step, tsolvers._heun_embedded_step)):
        args = (z, np.float64(0.25), np.float64(0.125), dw, *_torch_fields(), params,
                "diagonal")
        assert torch.equal(step(*args), pair(*args)[0])


# -----------------------------------------------------------------------------
# the uniform-grid drivers
# -----------------------------------------------------------------------------


def _path(words, shape, dtype):
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, shape, TORCH_DTYPES[dtype])
    draws = torch.stack([bm.increment(n, STEPS) for n in range(STEPS)]) * STEPS ** 0.5
    assert draws.abs().max() < 3.3  # inside the float64 bound's range (docstring)
    return bm


@pytest.mark.parametrize("dtype,solver,noise", [
    ("float64", s, "diagonal") for s in BASELINES + ["reversible_heun"]]
    + [("float32", "euler_maruyama", "diagonal"), ("float64", "midpoint", "general"),
       ("float64", "heun", "general")])
def test_sde_solve_matches_jax(dtype, solver, noise):
    params = _params(dtype, noise)
    z0 = np.random.default_rng(31).standard_normal((3, D)).astype(dtype)
    words = key_words(32, 1)[0]
    shape = (3, D if noise == "diagonal" else WDIM)
    bm = _path(words, shape, dtype)
    got = tsolvers.sde_solve(*_torch_fields(noise), params_from_jax(params),
                             torch.from_numpy(z0), bm, 0.0, 1.0, STEPS, solver=solver,
                             noise=noise)
    with jax_config(x64=dtype == "float64"):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, shape, jnp.dtype(dtype))
        want = jax.jit(lambda p, z: jsolvers.sde_solve(
            *_jax_fields(noise), p, z, jbm, 0.0, 1.0, STEPS, solver=solver,
            noise=noise))(params, z0)
    assert got.shape == (STEPS + 1, 3, D)
    torch.testing.assert_close(got, torch.from_numpy(_to_np(want)), **TRAJ_TOL[dtype])


@pytest.mark.parametrize("solver", ["midpoint", "heun"])
def test_ode_solve_matches_jax(solver):
    params = _params("float64")
    f = lambda p, t, z: jax_mlp(p["mu"], jax_tcat(t, z), final_activation=jnp.tanh)
    tf = lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh)
    z0 = np.random.default_rng(33).standard_normal((2, D))
    with jax_config(x64=True):
        want = jax.jit(lambda p, z: jsolvers.ode_solve(f, p, z, 0.0, 1.0, STEPS,
                                                       solver=solver))(params, z0)
    got = tsolvers.ode_solve(tf, params_from_jax(params), torch.from_numpy(z0), 0.0, 1.0,
                             STEPS, solver=solver)
    torch.testing.assert_close(got, torch.from_numpy(_to_np(want)), **TRAJ_TOL["float64"])


@pytest.mark.parametrize("solver,noise,save", [
    ("midpoint", "diagonal", True), ("reversible_heun", "general", False)])
def test_solve_batched_matches_jax(solver, noise, save):
    """One path per key row: the reference's vmap, the port's batched key
    (trajectory time-major in the port, batch-major in the reference)."""
    params = _params("float64", noise)
    words = key_words(34, 5)
    z0 = np.random.default_rng(35).standard_normal((5, D))
    kw = dict(solver=solver, noise=noise, save_trajectory=save,
              w_dim=WDIM if noise == "general" else None)
    with jax_config(x64=True):
        want = jax.jit(lambda p, z: jsolve.solve_batched(
            *_jax_fields(noise), p, z, jnp.asarray(words), 0.0, 1.0, STEPS, **kw))(params, z0)
    got = solve_batched(*_torch_fields(noise), params_from_jax(params),
                        torch.from_numpy(z0), torch_keys(words), 0.0, 1.0, STEPS, **kw)
    want = _to_np(want)
    if save:
        want = np.swapaxes(want, 0, 1)
    torch.testing.assert_close(got, torch.from_numpy(want), **TRAJ_TOL["float64"])


def test_solve_batched_validates_eagerly():
    p = params_from_jax(_params("float32", "general"))
    with pytest.raises(ValueError, match="leading"):
        solve_batched(*_torch_fields("general"), p, torch.zeros(3, D),
                      torch_keys(key_words(1, 2)), 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="w_dim"):
        solve_batched(*_torch_fields("general"), p, torch.zeros(2, D),
                      torch_keys(key_words(1, 2)), 0.0, 1.0, 4, noise="general")


@pytest.mark.parametrize("solver", ["midpoint", "heun"])
def test_field_times_are_the_compiled_references(solver):
    """Every time the fields are evaluated at, in order, forward and through
    the continuous adjoint's backsolve, equals the compiled reference's."""
    seen = {"jax": [], "torch": []}

    def jdrift(p, t, z):
        jax.debug.callback(lambda tt: seen["jax"].append(float(tt)), jnp.asarray(t),
                           ordered=True)
        return p * z * jnp.sin(t)

    def tdrift(p, t, z):
        seen["torch"].append(float(t))
        return p * z * float(np.sin(t))

    n = 23
    with jax_config(x64=False):
        z0 = jnp.ones((2,), jnp.float32)
        jbm = JaxBrownianPath(jnp.asarray(key_words(36, 1)[0]), 0.0, 1.0, (2,), jnp.float32)
        jax.grad(lambda p: jnp.sum(jsolve.solve(
            jdrift, lambda p, t, z: 0.1 * z, p, z0, jbm, 0.0, 1.0, n, solver=solver,
            gradient_mode="continuous_adjoint", save_trajectory=False)))(
                jnp.asarray(0.5, jnp.float32))
    p = torch.tensor(0.5, requires_grad=True)
    bm = BrownianPath(torch_keys(key_words(36, 1)[0]), 0.0, 1.0, (2,), torch.float32)
    zT = solve(tdrift, lambda p, t, z: 0.1 * z, p, torch.ones(2), bm, 0.0, 1.0, n,
               solver=solver, gradient_mode="continuous_adjoint", save_trajectory=False)
    torch.autograd.grad(zT.sum(), p)
    assert seen["torch"] == seen["jax"]
    dt = np.float32(1 / n)
    halves = {float(tsolvers.grid_time(0.0, Fraction(k, 2), dt)) for k in range(2 * n + 1)}
    assert set(seen["torch"]) <= halves


# -----------------------------------------------------------------------------
# the registry
# -----------------------------------------------------------------------------


def test_gradient_capabilities_are_the_references_without_srk():
    """The capability table, srk included since the srk slice: the
    reference's, mode for mode and in its order."""
    want = jsolve.gradient_capabilities()
    assert gradient_capabilities() == want
    assert list(gradient_capabilities()) == list(want)
    assert "srk" in gradient_capabilities()["checkpoint"]


@pytest.mark.parametrize("name", BASELINES + ["reversible_heun", "srk"])
def test_solver_specs_match_the_reference(name):
    got, want = SOLVERS[name], jsolve.SOLVERS[name]
    assert (got.nfe_per_step, got.strong_order, got.sde_type, got.gradient_modes,
            got.supports_pallas, got.noise_types, got.needs_levy_area, got.reversible) == (
        want.nfe_per_step, want.strong_order, want.sde_type, want.gradient_modes,
        want.supports_pallas, want.noise_types, want.needs_levy_area, want.reversible)
    assert (got.embedded_stepper is None) == (want.embedded_stepper is None)
    assert got.nfe_per_step == tsolvers.NFE_PER_STEP[name]


def test_srk_names_its_roadmap_item():
    """srk is ported (the srk slice): on a plain path it raises the
    reference's named error, on a space-time path it solves
    (tests/test_torch_srk.py holds the values against the reference)."""
    args = (*_torch_fields(), params_from_jax(_params("float32")), torch.zeros(2, D))
    key = torch_keys(key_words(37, 1)[0])
    with pytest.raises(ValueError, match="levy_area='space-time'"):
        solve(*args, BrownianPath(key, 0.0, 1.0, (2, D)), 0.0, 1.0, 4, solver="srk")
    traj = solve(*args, BrownianPath(key, 0.0, 1.0, (2, D), levy_area="space-time"), 0.0,
                 1.0, 4, solver="srk")
    assert traj.shape == (5, 2, D) and torch.isfinite(traj).all()


# -----------------------------------------------------------------------------
# the stepper-generic adaptive loop
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,solver", [("float64", "midpoint"), ("float32", "heun")])
def test_adaptive_baselines_match_jax(dtype, solver):
    params = _params(dtype)
    words, z0 = key_words(38, 1)[0], (0.5 * np.random.default_rng(39).standard_normal(
        (4, D))).astype(dtype)
    kw = dict(solver=solver, rtol=1e-2, atol=1e-4, max_steps=256, dt0=1 / 16,
              bridge_depth=10)
    with jax_config(x64=dtype == "float64"):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, (4, D), jnp.dtype(dtype))
        want_z, want = jax.device_get(jax.jit(lambda p, z: jsolve.solve_adaptive(
            *_jax_fields(), p, z, jbm, 0.0, 1.0, **kw))(params, z0))
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (4, D), TORCH_DTYPES[dtype])
    got_z, got = solve_adaptive(*_torch_fields(), params_from_jax(params),
                                torch.from_numpy(z0), bm, 0.0, 1.0, **kw)
    assert int(got.num_accepted) == int(want.num_accepted)
    assert int(got.num_rejected) == int(want.num_rejected)
    assert int(got.nfe) == int(want.nfe)  # no initial evaluation for a bare-state carry
    assert bool(got.converged) and bool(want.converged)
    torch.testing.assert_close(got_z, torch.from_numpy(_to_np(want_z)), rtol=0.0,
                               atol=ADAPT_Z_TOL[dtype])


def test_adaptive_euler_is_refused_by_name():
    with pytest.raises(ValueError, match="no embedded error estimate"):
        solve(*_torch_fields(), params_from_jax(_params("float32")), torch.zeros(2, D),
              BrownianPath(torch_keys(key_words(37, 1)[0]), 0.0, 1.0, (2, D)), 0.0, 1.0, 4,
              solver="euler_maruyama", adaptive=True, save_trajectory=False)
