"""The port's SDE field MLP on the CPU against the JAX package: its plain
version (``repro_torch.kernels.ref.fused_mlp``) against
``repro.kernels.ref.fused_mlp`` and the Pallas kernel run as the JAX
package's own tests run it (interpret mode); the autograd node the kernel
launches in (built here with the plain forward in the kernel's place)
against autograd of the plain version and ``jax.vjp``; the route
``nn.mlp`` takes; the dispatch policy and the launcher's operand checks.

Tolerances: float32 rtol = atol = 2e-5 and bfloat16 6e-2, the JAX kernel
suite's (tests/test_kernels.py:18-21: the kernel accumulates in float32
and sums in another order than the plain product); float64 1e-12 (the
products sum in different orders, and XLA's CPU exp and logistic differ
from torch's by an ulp).  The backward of the node is held bitwise to the
plain version's autograd: it is that autograd, recomputed.  The CUDA
kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro.kernels import ref as jref
from repro.kernels.fused_mlp import fused_mlp as pallas_fused_mlp
from repro_torch import nn
from repro_torch.kernels import fused_mlp as fm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.vjp import PlainVJP
from repro_torch.nn import core as nn_core

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=6e-2, atol=6e-2),
       "float64": dict(rtol=1e-12, atol=1e-12)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}

# (Din, H, Dout) of every depth-1 SDE field the port runs: the Latent SDE's
# prior/posterior mu and sigma (1 + 16 -> 32 -> 16), its nu (1 + 16 + 16),
# qz0 (16 -> 2·8) and zeta (8 -> 16); the SDE-GAN generator's zeta (4 -> 16)
# and sigma (1 + 16 -> 16·4); the adaptive workload's burst (32 -> 64 -> 32).
FIELDS = [(17, 32, 16), (33, 32, 16), (16, 32, 16), (8, 32, 16), (4, 32, 16),
          (17, 32, 64), (32, 64, 32)]


def _inputs(lead, din, h, dout, seed=0):
    """The JAX suite's draws: x ~ N(0, 1), W ~ 0.3·N(0, 1), b ~ 0.1·N(0, 1)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal(tuple(lead) + (din,))
    w1 = r.standard_normal((din, h)) * 0.3
    b1 = r.standard_normal((h,)) * 0.1
    w2 = r.standard_normal((h, dout)) * 0.3
    b2 = r.standard_normal((dout,)) * 0.1
    return x, w1, b1, w2, b2


def _both(arrays, dtype):
    """The same values on both sides: float32 numpy arrays rounded to the
    dtype by each framework (round to nearest even in both)."""
    if dtype == "float64":
        return ([torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays])
    f32 = [a.astype(np.float32) for a in arrays]
    return ([torch.from_numpy(a).to(TORCH[dtype]) for a in f32],
            [jnp.asarray(a).astype(JAX[dtype]) for a in f32])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy() if dtype == "bfloat16" else got.numpy(),
                               np.asarray(want, np.float32 if dtype == "bfloat16" else None),
                               **TOL[dtype])


@pytest.mark.parametrize("shape", [(64, 32), (128, 67), (4, 8, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_mlp_matches_jax_ref_and_pallas(shape, dtype):
    """The JAX suite's shapes (tests/test_kernels.py:67-80): H 48, Dout 24."""
    with jax_config():
        (tx, *tw), (jx, *jw) = _both(_inputs(shape[:-1], shape[-1], 48, 24, seed=len(shape)),
                                     dtype)
        got = ref.fused_mlp(tx, *tw)
        assert got.dtype == TORCH[dtype] and got.shape == shape[:-1] + (24,)
        _close(got, jref.fused_mlp(jx, *jw), dtype)
        _close(got, pallas_fused_mlp(jx, *jw, interpret=True), dtype)


@pytest.mark.parametrize("din,h,dout", FIELDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_fused_mlp_matches_jax_at_the_sde_field_widths(din, h, dout, dtype):
    with jax_config(x64=dtype == "float64"):
        (tx, *tw), (jx, *jw) = _both(_inputs((37,), din, h, dout, seed=din + h), dtype)
        got = ref.fused_mlp(tx, *tw)
        _close(got, jref.fused_mlp(jx, *jw), dtype)
        if dtype == "float32":  # the Pallas kernel accumulates in float32
            _close(got, pallas_fused_mlp(jx, *jw, interpret=True), dtype)


def _node(*args):
    """The kernel's autograd node with the plain forward in the kernel's place."""
    return PlainVJP.apply(ref.fused_mlp, ref.fused_mlp, {}, *args)


def _leaves(din, h, dout, dtype=torch.float64, lead=(5,), seed=1):
    return [torch.from_numpy(a).to(dtype).requires_grad_()
            for a in _inputs(lead, din, h, dout, seed=seed)]


@pytest.mark.parametrize("din,h,dout", [(17, 32, 16), (32, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_node_backward_is_plain_autograd_bitwise(din, h, dout, dtype):
    """A loss linear in the output, and one that is not (through tanh and a
    product upstream of x): every gradient bitwise autograd's of the plain
    version."""
    leaves = _leaves(din, h, dout, dtype, lead=(3, 7))
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 7, dout))).to(dtype)

    def grads(f):
        x, *w = leaves
        out = f(torch.tanh(x * 1.5), *w)
        linear = torch.autograd.grad((out * c).sum(), leaves, retain_graph=True)
        return linear, torch.autograd.grad(torch.sin(out).pow(2).sum(), leaves)

    for got, want in zip(grads(_node), grads(ref.fused_mlp)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_node_gradcheck_and_second_derivative_float64():
    leaves = _leaves(4, 6, 3, lead=(3,))
    assert torch.autograd.gradcheck(_node, leaves)
    assert torch.autograd.gradgradcheck(_node, leaves)


def test_node_second_derivative_is_the_plain_versions_bitwise():
    """create_graph through the node: a gradient penalty's gradient (the
    SDE-GAN's, sde.py:252) is the plain version's, never silently zero."""
    def penalty_grads(f):
        x, *w = leaves
        gx, = torch.autograd.grad(f(x, *w).sum(), x, create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), leaves[:4])  # b2 drops out of gx

    leaves = _leaves(17, 32, 16, lead=(6,))
    got, want = penalty_grads(_node), penalty_grads(ref.fused_mlp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(g.abs().max() > 0 for g in got)


def test_node_vjp_matches_jax_vjp_float64():
    arrays = _inputs((9,), 17, 32, 16, seed=5)
    ct = np.random.default_rng(6).standard_normal((9, 16))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.autograd.grad(_node(*leaves), leaves, torch.from_numpy(ct))
    with jax_config(x64=True):
        out, vjp = jax.vjp(jref.fused_mlp, *map(jnp.asarray, arrays))
        want = vjp(jnp.asarray(ct))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL["float64"])


def test_route_predicate():
    """The kernel takes an MLP on the card with exactly two layers, both
    biased, and LipSwish between them; anything else runs the layer loop."""
    g = torch.Generator().manual_seed(0)
    card = types.SimpleNamespace(is_cuda=True)
    depth1 = nn.mlp_init(g, [17, 32, 16])["layers"]
    assert nn_core._fusable(depth1, card, nn.lipswish)
    assert not nn_core._fusable(depth1, torch.zeros(2, 17), nn.lipswish)
    assert not nn_core._fusable(depth1, card, nn.silu)
    assert not nn_core._fusable(nn.mlp_init(g, [17, 32, 32, 16])["layers"], card,
                                nn.lipswish)
    assert not nn_core._fusable(nn.mlp_init(g, [17, 16])["layers"], card, nn.lipswish)
    assert not nn_core._fusable(nn.mlp_init(g, [17, 32, 16], bias=False)["layers"], card,
                                nn.lipswish)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("final", [None, torch.tanh])
def test_cpu_mlp_is_the_layer_loop_bitwise(dtype, final):
    """On the CPU a depth-1 field runs the 1024-row-block linears as before."""
    params = nn.mlp_init(torch.Generator().manual_seed(2), [17, 32, 16], dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1030, 17))).to(dtype)
    l1, l2 = params["layers"]
    want = nn.linear(l2, nn.lipswish(nn.linear(l1, x)))
    want = want if final is None else final(want)
    assert torch.equal(nn.mlp(params, x, nn.lipswish, final), want)


def test_dispatch_runs_the_plain_version_on_cpu_tensors():
    x, *w = (torch.from_numpy(a).float() for a in _inputs((10,), 17, 32, 16))
    ops.reset_launch_counts()
    got = ops.fused_mlp(x, *w)
    assert torch.equal(got, ref.fused_mlp(x, *w))
    assert torch.equal(ops.fused_mlp(x, *w, use_kernel=False), got)
    assert ops.launch_counts()["fused_mlp"] == 0
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.fused_mlp(x, *w, use_kernel=True)


def test_kernel_launcher_checks_operands():
    x, w1, b1, w2, b2 = (torch.from_numpy(a).float() for a in _inputs((4,), 8, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fm_kernel.fused_mlp(x, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        fm_kernel.fused_mlp(x.half(), w1.half(), b1.half(), w2.half(), b2.half())
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x[:, :7], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x, w1, b1[:3], w2, b2)
    with pytest.raises(ValueError, match="w2 is"):
        fm_kernel.fused_mlp(x, w1, b1, w2.double(), b2)
    with pytest.raises(ValueError, match="contiguous"):
        fm_kernel.fused_mlp(x, w1.t().contiguous().t(), b1, w2, b2)
    wide = torch.empty(6000, 200, dtype=torch.float64)
    with pytest.raises(ValueError, match="Din \\+ H"):
        fm_kernel.fused_mlp(torch.empty(1, 6000, dtype=torch.float64), wide,
                            torch.empty(200, dtype=torch.float64), wide[:200, :4],
                            torch.empty(4, dtype=torch.float64))
    assert fm_kernel.LAUNCHES["fused_mlp"] == 0
