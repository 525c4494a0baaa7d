"""The port's reversible-Heun solve (repro_torch.core.solve) against
repro.core.solve, fused against unfused inside the port, and the named
errors for what it refuses — on the CPU.  (The adaptive
loop's own tests are in tests/test_torch_adaptive.py.)

Tolerances: trajectories rtol=2e-5, atol=2e-6 in float32 and rtol=1e-11,
atol=1e-13 in float64.  The float64 bound holds for draws inside |z| < 3.3
(XLA's CPU float64 normal wobbles by up to 6e-11 relative beyond, see
tests/test_torch_prng.py); the test asserts its draws stay inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.core.solve import solve as jax_solve
from repro.nn.core import mlp as jax_mlp
from repro.nn.core import tcat as jax_tcat
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import BrownianPath, solve
from repro_torch.nn import mlp, tcat

TRAJ_TOL = {"float32": dict(rtol=2e-5, atol=2e-6), "float64": dict(rtol=1e-11, atol=1e-13)}
D, W, STEPS = 4, 8, 8


def _params(dtype, seed=30):
    rng = np.random.default_rng(seed)

    def net(sizes):
        return {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                            "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
                           for a, b in zip(sizes[:-1], sizes[1:])]}

    return {"mu": net([1 + D, W, D]), "sigma": net([1 + D, W, D])}


def _jax_fields():
    drift = lambda p, t, z: jax_mlp(p["mu"], jax_tcat(t, z), final_activation=jnp.tanh)
    diffusion = lambda p, t, z: 0.3 * jax.nn.sigmoid(jax_mlp(p["sigma"], jax_tcat(t, z)))
    return drift, diffusion


def _torch_fields():
    drift = lambda p, t, z: mlp(p["mu"], tcat(t, z), final_activation=torch.tanh)
    diffusion = lambda p, t, z: 0.3 * torch.sigmoid(mlp(p["sigma"], tcat(t, z)))
    return drift, diffusion


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_forward_matches_jax(dtype, fused):
    params = _params(dtype)
    z0 = np.random.default_rng(31).standard_normal((3, D)).astype(dtype)
    words = key_words(32, 1)[0]
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (3, D), TORCH_DTYPES[dtype])
    draws = torch.stack([bm.increment(n, STEPS) for n in range(STEPS)]) * STEPS ** 0.5
    assert draws.abs().max() < 3.3  # inside the float64 bound's range (docstring)
    got = solve(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0), bm, 0.0,
                1.0, STEPS, gradient_mode="reversible_adjoint", use_pallas_kernels=fused)
    with jax_config(x64=dtype == "float64"):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, (3, D), jnp.dtype(dtype))
        want = jax.jit(lambda p, z: jax_solve(
            *_jax_fields(), p, z, jbm, 0.0, 1.0, STEPS, gradient_mode="reversible_adjoint",
            use_pallas_kernels=fused))(params, z0)
    assert got.shape == (STEPS + 1, 3, D)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TRAJ_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_equals_unfused_bitwise(dtype):
    """In-port identity: the fused step (phase-1 draw in the kernel's plain
    version, phase 2) reproduces the unfused arithmetic bit for bit."""
    params = params_from_jax(_params(dtype, seed=33))
    z0 = torch.from_numpy(np.random.default_rng(34).standard_normal((5, D)).astype(dtype))
    bm = BrownianPath(torch_keys(key_words(35, 5)), 0.0, 1.0, (D,), TORCH_DTYPES[dtype])
    runs = [solve(*_torch_fields(), params, z0, bm, 0.0, 1.0, STEPS,
                  gradient_mode="reversible_adjoint", use_pallas_kernels=fused,
                  save_trajectory=save)
            for save in (True, False) for fused in (False, True)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[2], runs[3])
    assert torch.equal(runs[0][-1], runs[2])


def _solve(**kw):
    params = params_from_jax(_params("float32"))
    bm = BrownianPath(torch_keys(key_words(36, 2)), 0.0, 1.0, (D,))
    args = dict(gradient_mode="reversible_adjoint")
    args.update(kw)
    return solve(*_torch_fields(), params, torch.zeros(2, D), bm, 0.0, 1.0, 4, **args)


@pytest.mark.parametrize("kw,err,match", [
    (dict(solver="midpoint", gradient_mode="discretise", use_pallas_kernels=True), ValueError,
     "no fused kernel path"),
    (dict(solver="srk", gradient_mode="discretise"), ValueError, "space-time"),
    (dict(solver="rk4"), ValueError, "unknown solver"),
    (dict(gradient_mode="continuous_adjoint"), ValueError, "does not support"),
    (dict(gradient_mode="checkpoint"), ValueError, "terminal-value cotangent"),
    (dict(gradient_mode="bogus"), ValueError, "unknown gradient_mode"),
    (dict(adaptive=True), ValueError, "save_trajectory"),
    (dict(rtol=1e-3), ValueError, "adaptive-mode options"),
    (dict(precision="bf16"), ValueError, "unknown precision"),
    (dict(noise="general", use_pallas_kernels=True), ValueError, "diagonal noise"),
    (dict(noise="scalar"), ValueError, "unknown noise"),
])
def test_unsupported_modes_raise_named_errors(kw, err, match):
    with pytest.raises(err, match=match):
        _solve(**kw)


def test_gradients_point_at_the_training_slice():
    """The training slice landed: a solve whose inputs require grad
    differentiates through the exact adjoint (tests/test_torch_adjoint.py
    holds the values against the reference)."""
    params = params_from_jax(_params("float32"))
    w = params["mu"]["layers"][0]["w"].requires_grad_(True)
    bm = BrownianPath(torch_keys(key_words(37, 2)), 0.0, 1.0, (D,))
    out = solve(*_torch_fields(), params, torch.zeros(2, D), bm, 0.0, 1.0, 4,
                gradient_mode="reversible_adjoint")
    (g,) = torch.autograd.grad(out.square().sum(), w)
    assert g.shape == w.shape and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("kw,match", [
    (dict(save_trajectory=True), "save_trajectory"),
    (dict(bridge_depth=0), "bridge_depth must be a positive int"),
    (dict(gradient_mode="discretise", use_pallas_kernels=True), "incompatible"),
])
def test_adaptive_option_errors_are_eager_and_named(kw, match):
    args = dict(adaptive=True, save_trajectory=False)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        _solve(**args)


def test_adaptive_terminal_value_matches_jax():
    """``solve(..., adaptive=True)`` returns the adaptive terminal value of
    the reference (float64, bridge depth 10; tests/test_torch_adaptive.py
    holds the controller's counts and grid).  Tolerance rtol 1e-9, atol
    1e-10: the two accepted grids differ by ulps of dt, which the
    controller amplifies step by step (ROADMAP.md Queue 3)."""
    params = _params("float64", seed=38)
    z0 = 0.5 * np.random.default_rng(39).standard_normal((3, D))
    words = key_words(40, 1)[0]
    kw = dict(gradient_mode="reversible_adjoint", save_trajectory=False, adaptive=True,
              rtol=1e-2, atol=1e-4, bridge_depth=10)
    bm = BrownianPath(torch_keys(words), 0.0, 1.0, (3, D), torch.float64)
    got = solve(*_torch_fields(), params_from_jax(params), torch.from_numpy(z0), bm, 0.0,
                1.0, STEPS, **kw)
    with jax_config(x64=True):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, (3, D), jnp.float64)
        want = jax.jit(lambda p, z: jax_solve(*_jax_fields(), p, z, jbm, 0.0, 1.0, STEPS,
                                              **kw))(params, z0)
    assert got.shape == (3, D) and torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), rtol=1e-9, atol=1e-10)
