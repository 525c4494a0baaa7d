"""The port's exact reversible adjoint (repro_torch.core.gradients.reversible)
against the JAX package's ``custom_vjp`` and against the port's own
discretise-then-optimise oracle, on the CPU.

Tolerances, with their reasons:
* gradients vs JAX: float64 rtol=1e-9, atol=1e-12 — XLA contracts FMAs and
  has its own tanh/exp/log1p, so every field evaluation differs by ulps,
  carried through 8–23 steps forward and back; float32 rtol=1e-4, atol=1e-5.
  The float64 draws stay inside |z| < 3.3, where XLA's CPU float64 normal
  is stable (tests/test_torch_prng.py).
* exact adjoint vs discretise inside the port: ≤1e-12 relative in float64
  (the paper's "exact to floating-point error"; tests/test_adjoint.py pins
  the same bound on the JAX side).
* fused vs unfused exact adjoint: bitwise (max |Δ| = 0) in float32 and
  float64 — the backward phases keep the transpose's grouping and the ẑ₁
  cotangent takes the g_zh seed first on both paths.
* the field times and context indices of the ELBO's solve: exactly the
  compiled reference's (recorded through debug callbacks).
* reconstruction (Algorithm 2) vs JAX: the elementwise phase tolerance of
  tests/test_torch_kernels_ref.py after one field evaluation (rtol 1e-5 /
  atol 1e-6 f32, 1e-13 / 1e-14 f64).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys
from repro.core.brownian import BrownianPath as JaxBrownianPath
from repro.core.solve import solve as jax_solve
from repro.core.solvers import RevHeunState as JaxRevHeunState
from repro.core.solvers import reversible_heun_reverse_step as jax_reverse_step
from repro.nn.core import mlp as jax_mlp
from repro.nn.core import tcat as jax_tcat
from repro_torch import tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core import BrownianPath, RevHeunState, reversible_heun_reverse_step, solve
from repro_torch.core.solvers import NP_DTYPES
from repro_torch.nn import mlp, tcat

GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "float64": dict(rtol=1e-9, atol=1e-12)}
STEP_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-13, atol=1e-14)}
B, D, W, STEPS = 3, 4, 8, 8


def _params(dtype, seed=50):
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


def _loss(out, save):
    # a whole-trajectory loss: terminal value plus an interior step
    return (out ** 2).sum() + (abs(out[STEPS // 2]).sum() if save else 0.0)


def _torch_grads(dtype, mode, fused, save, seed=51):
    """Gradients of the loss w.r.t. (param leaves..., z0) in the port."""
    leaves, spec = tree.flatten(params_from_jax(_params(dtype)))
    leaves = [x.requires_grad_() for x in leaves]
    z0 = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, D)).astype(dtype))
    z0.requires_grad_()
    bm = BrownianPath(torch_keys(key_words(seed, 1)[0]), 0.0, 1.0, (B, D), TORCH_DTYPES[dtype])
    out = solve(*_torch_fields(), tree.unflatten(spec, leaves), z0, bm, 0.0, 1.0, STEPS,
                gradient_mode=mode, use_pallas_kernels=fused, save_trajectory=save)
    return torch.autograd.grad(_loss(out, save), leaves + [z0])


def _rel_err(a, b):
    num = sum((x - y).abs().sum().item() for x, y in zip(a, b))
    return num / max(sum(y.abs().sum().item() for y in b), 1e-300)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "final"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_adjoint_gradients_match_jax_custom_vjp(dtype, save, fused):
    seed = 52
    got = _torch_grads(dtype, "reversible_adjoint", fused, save, seed)
    want = _jax_grads(dtype, save, fused, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **GRAD_TOL[dtype])


def _jax_grads(dtype, save, fused, seed):
    """The JAX package's ``custom_vjp`` gradients of the same loss, in the
    order of :func:`_torch_grads`; the draws stay where the float64
    tolerance holds (module docstring)."""
    params = _params(dtype)
    z0 = np.random.default_rng(seed).standard_normal((B, D)).astype(dtype)
    words = key_words(seed, 1)[0]
    with jax_config(x64=dtype == "float64"):
        jbm = JaxBrownianPath(jnp.asarray(words), 0.0, 1.0, (B, D), jnp.dtype(dtype))

        def loss(p, z):
            out = jax_solve(*_jax_fields(), p, z, jbm, 0.0, 1.0, STEPS,
                            gradient_mode="reversible_adjoint", save_trajectory=save,
                            use_pallas_kernels=fused)
            return _loss(out, save)

        gp, gz = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, z0)
        want = [np.asarray(x) for x in jax.tree.leaves(gp)] + [np.asarray(gz)]
    draws = torch.stack([BrownianPath(torch_keys(words), 0.0, 1.0, (B, D)).increment(n, STEPS)
                         for n in range(STEPS)]) * STEPS ** 0.5
    assert draws.abs().max() < 3.3  # inside the float64 bound's range (docstring)
    return want


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "final"])
def test_exact_adjoint_matches_discretise_to_fp_error(save, fused):
    exact = _torch_grads("float64", "reversible_adjoint", fused, save)
    dto = _torch_grads("float64", "discretise", False, save)
    assert _rel_err(exact, dto) <= 1e-12


@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "final"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_adjoint_bitwise_equals_unfused(dtype, save):
    a = _torch_grads(dtype, "reversible_adjoint", False, save, seed=53)
    b = _torch_grads(dtype, "reversible_adjoint", True, save, seed=53)
    for x, y in zip(a, b):
        assert torch.equal(x, y), (x - y).abs().max().item()


@pytest.mark.parametrize("save", [True, False], ids=["trajectory", "final"])
def test_fused_backward_draws_only_through_phase1_gen(monkeypatch, save):
    """The fused exact adjoint on a ``BrownianPath`` draws every ΔW inside
    ``rev_heun_phase1_gen``: the forward's N at sign +1, the reconstruction's
    N at sign -1, and none through ``brownian_increment``.  Its float64
    gradients are the unfused route's bitwise (that route re-draws through
    ``brownian_increment``: the same bits) and the JAX package's within
    GRAD_TOL."""
    from repro_torch.kernels import ops

    signs, increments = [], []
    gen, increment = ops.rev_heun_phase1_gen, ops.brownian_increment

    def counted_gen(*args, **kw):
        signs.append(kw.get("sign", args[8] if len(args) > 8 else 1.0))
        return gen(*args, **kw)

    def counted_increment(*args, **kw):
        increments.append(args[1])
        return increment(*args, **kw)

    monkeypatch.setattr(ops, "rev_heun_phase1_gen", counted_gen)
    monkeypatch.setattr(ops, "brownian_increment", counted_increment)
    fused = _torch_grads("float64", "reversible_adjoint", True, save, seed=52)
    assert increments == [] and sorted(signs) == [-1.0] * STEPS + [1.0] * STEPS
    unfused = _torch_grads("float64", "reversible_adjoint", False, save, seed=52)
    assert len(increments) == 2 * STEPS  # the unfused route: forward and backward
    for x, y in zip(fused, unfused):
        assert torch.equal(x, y), (x - y).abs().max().item()
    want = _jax_grads("float64", save, True, 52)
    for g, w in zip(fused, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **GRAD_TOL["float64"])


def _saved_bytes(mode, num_steps):
    """Bytes autograd keeps for the backward of one solve (saved-tensor hooks)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    params = params_from_jax(_params("float64"))
    leaves = [x.requires_grad_() for x in tree.leaves(params)]
    bm = BrownianPath(torch_keys(key_words(54, 1)[0]), 0.0, 1.0, (B, D), torch.float64)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = solve(*_torch_fields(), params, torch.ones(B, D, dtype=torch.float64), bm,
                    0.0, 1.0, num_steps, gradient_mode=mode, save_trajectory=False)
    torch.autograd.grad(out.sum(), leaves)
    return total[0]


def test_exact_adjoint_saves_constant_memory_in_the_step_count():
    """Only the terminal state and the parameters are saved (paper's O(1)
    memory); discretise's saved activations grow with the step count."""
    exact = [_saved_bytes("reversible_adjoint", n) for n in (4, 16)]
    dto = [_saved_bytes("discretise", n) for n in (4, 16)]
    param_bytes = sum(x.size * 8 for x in tree.leaves(_params("float64")))
    assert exact[0] == exact[1] == param_bytes + 4 * B * D * 8
    assert dto[1] > 3 * dto[0]


def _forward_peak_state_bytes(save, num_steps):
    """Most bytes held by live state-shaped tensors at any drift evaluation
    of one exact-adjoint solve's forward (tensors are gc-tracked objects)."""
    drift, diffusion = _torch_fields()
    peak = [0]

    def counting_drift(p, t, z):
        live = sum(o.numel() * o.element_size() for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor) and o.shape == (B, D))
        peak[0] = max(peak[0], live)
        return drift(p, t, z)

    params = params_from_jax(_params("float64"))
    for x in tree.leaves(params):
        x.requires_grad_()
    bm = BrownianPath(torch_keys(key_words(56, 1)[0]), 0.0, 1.0, (B, D), torch.float64)
    solve(counting_drift, diffusion, params, torch.ones(B, D, dtype=torch.float64), bm,
          0.0, 1.0, num_steps, gradient_mode="reversible_adjoint", save_trajectory=save)
    return peak[0]


@pytest.mark.parametrize("save", [False, True], ids=["final", "trajectory"])
def test_exact_adjoint_forward_holds_states_by_form(save):
    """The terminal form keeps no per-step state in its forward (O(1) in the
    step count); the trajectory form keeps the states it returns, one per
    step (which is what shows the measure sees them)."""
    few, many = (_forward_peak_state_bytes(save, n) for n in (4, 16))
    if save:
        assert many - few >= 12 * B * D * 8
    else:
        assert many == few


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reverse_step_matches_jax(dtype, fused):
    rng = np.random.default_rng(55)
    z1, zh1, mu1 = (rng.standard_normal((B, D)).astype(dtype) for _ in range(3))
    sigma1 = (0.3 * rng.random((B, D))).astype(dtype)
    dw = (0.3 * rng.standard_normal((B, D))).astype(dtype)
    np_dtype = NP_DTYPES[TORCH_DTYPES[dtype]]
    t1, dt = np_dtype(5) * np_dtype(1 / STEPS), np_dtype(1 / STEPS)
    params = _params(dtype)
    got = reversible_heun_reverse_step(
        RevHeunState(*map(torch.from_numpy, (z1, zh1, mu1, sigma1))), t1, dt,
        torch.from_numpy(dw), *_torch_fields(), params_from_jax(params), "diagonal",
        use_pallas=fused)
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(lambda p, *s: jax_reverse_step(
            JaxRevHeunState(*s[:4]), t1, dt, s[4], *_jax_fields(), p, "diagonal",
            use_pallas=fused))(params, z1, zh1, mu1, sigma1, dw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **STEP_TOL[dtype])


def _recording(module, monkeypatch, torch_side):
    """Wrap ``module._step_index_lookup`` so every lookup records its
    ``(index, t)`` — on the JAX side through an ordered debug callback, so
    the times are the compiled program's own."""
    seen = []
    orig = module._step_index_lookup

    def lookup(t1, T, *rest):
        at = orig(t1, T, *rest)

        def recorded(p, t):
            if torch_side:
                seen.append((module._step_index(t, t1, T, *rest), float(t)))
            else:
                idx = jnp.clip(jnp.asarray(t / t1 * T).astype(jnp.int32), 0, T)
                jax.debug.callback(lambda i, tt: seen.append((int(i), float(tt))), idx,
                                   jnp.asarray(t), ordered=True)
            return at(p, t)

        return recorded

    monkeypatch.setattr(module, "_step_index_lookup", lookup)
    return seen


@pytest.mark.parametrize("num_steps,T", [(23, 23), (46, 23)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_step_index_lookup_matches_jax_at_every_solver_time(monkeypatch, dtype, num_steps, T):
    """Every time the forward and the backward of the ELBO evaluate the
    posterior fields at — and the context row each reads — equals the
    compiled reference's exactly, in order (forward, then per backward step
    the reconstruction and the local forward, then the initial state)."""
    import repro.core.sde as jsde
    import repro_torch.core.sde as tsde

    widths = dict(data_dim=2, hidden_dim=3, context_dim=3, initial_noise_dim=2, width=4,
                  num_steps=num_steps, kl_weight=0.1)
    y = np.random.default_rng(56).standard_normal((T + 1, 2, 2)).astype(dtype)
    jax_seen = _recording(jsde, monkeypatch, torch_side=False)
    with jax_config(x64=dtype == "float64"):
        cfg = jsde.LatentSDEConfig(**widths, dtype=jnp.dtype(dtype))
        params = jsde.latent_sde_init(jax.random.PRNGKey(0), cfg)
        key = jax.random.PRNGKey(1)
        jax.block_until_ready(jax.jit(jax.grad(
            lambda p: jsde.latent_sde_loss(p, cfg, key, y)[0]))(params))
        params, key = jax.device_get((params, key))
    torch_seen = _recording(tsde, monkeypatch, torch_side=True)
    leaves, spec = tree.flatten(params_from_jax(params))
    leaves = [x.requires_grad_() for x in leaves]
    loss, _ = tsde.latent_sde_loss(tree.unflatten(spec, leaves),
                                   tsde.LatentSDEConfig(**widths, dtype=TORCH_DTYPES[dtype]),
                                   torch_keys(key), torch.from_numpy(y))
    torch.autograd.grad(loss, leaves)
    assert len(torch_seen) == 1 + 3 * num_steps + 1
    assert torch_seen == jax_seen
