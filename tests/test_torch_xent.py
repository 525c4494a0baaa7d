"""The port's LM-loss cross entropy on the CPU against the JAX package: the
plain forward (``repro_torch.kernels.ref.fused_xent``) against
``repro.kernels.ref.fused_xent`` and the Pallas kernel run as the JAX
package's own tests run it (interpret mode); the plain backward against
``jax.vjp``; the autograd node the two kernels launch in (built here with
the plain versions in the launches' place) against autograd of the plain
forward; gradcheck; the mean against ``softmax_xent``; the dispatch policy
and the launcher's operand checks.

Tolerances: the JAX kernel suite's (tests/test_kernels.py:167-181): the
loss rtol = atol = 1e-5 in float32 and 3e-2 in bfloat16, the mean against
``softmax_xent`` rtol 1e-6; the backward against ``jax.vjp`` rtol 1e-6,
atol 1e-7 in float32 (torch's and XLA's exp differ by an ulp).  The node
against autograd of the plain forward: 1e-6 relative (autograd's
logsumexp backward divides by the sum, the node's plain backward
subtracts the log-sum-exp).  The CUDA kernels themselves are held to the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

from repro.kernels import ref as jref
from repro.kernels.xent import fused_xent as pallas_fused_xent
from repro.models.transformer import softmax_xent as jax_softmax_xent
from repro_torch.kernels import ops, ref
from repro_torch.kernels import xent as xent_kernel
from repro_torch.models import transformer as T

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (R, V, Pallas row block, Pallas vocab block): the JAX suite's shapes.
SHAPES = [(64, 1024, 32, 256), (128, 512, 256, 2048), (32, 1000, 8, 125)]


def _inputs(R, V, seed=0):
    """The JAX suite's draws: logits 3·N(0, 1), labels uniform over V."""
    r = np.random.default_rng(seed)
    logits = (3.0 * r.standard_normal((R, V))).astype(np.float32)
    labels = r.integers(0, V, (R,)).astype(np.int32)
    return logits, labels


def _pair(logits, dtype):
    """The same values on both sides, rounded once to ``dtype`` by JAX."""
    j = jnp.asarray(logits).astype(JAX[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


@pytest.mark.parametrize("R,V,br,bv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax_ref_and_pallas_kernel(R, V, br, bv, dtype):
    logits, labels = _inputs(R, V)
    jl, tl = _pair(logits, dtype)
    got = ref.fused_xent(tl, torch.from_numpy(labels)).numpy()
    want = np.asarray(jref.fused_xent(jl, jnp.asarray(labels)))
    kern = np.asarray(pallas_fused_xent(jl, jnp.asarray(labels), block_rows=br,
                                        block_vocab=bv, interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(got, kern, **TOL[dtype])


def test_plain_forward_returns_the_log_sum_exp():
    logits, labels = _inputs(16, 300, seed=1)
    loss, lse = ref.fused_xent_fwd(torch.from_numpy(logits), torch.from_numpy(labels))
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), want - logits[np.arange(16), labels],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,V", [(64, 1024), (32, 1000), (1, 7), (5, 1)])
def test_plain_backward_matches_jax_vjp(R, V):
    logits, labels = _inputs(R, V, seed=2)
    g = np.random.default_rng(3).standard_normal(R).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jref.fused_xent(x, jnp.asarray(labels)), jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(g))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    _, lse = ref.fused_xent_fwd(tl, tlab)
    got = ref.fused_xent_bwd(tl, tlab, lse, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (R, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_plain_backward_rounds_once_to_bfloat16():
    logits, labels = _inputs(8, 300, seed=4)
    x = torch.from_numpy(logits).to(torch.bfloat16)
    lab, g = torch.from_numpy(labels), torch.full((8,), 0.5)
    _, lse = ref.fused_xent_fwd(x, lab)
    got = ref.fused_xent_bwd(x, lab, lse, g)
    want = ref.fused_xent_bwd(x.float(), lab, lse, g).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _node(logits, labels):
    return xent_kernel.XentFunction.apply(ref.fused_xent_fwd, ref.fused_xent_bwd, logits,
                                          labels)


@pytest.mark.parametrize("shape", [(4, 16, 256), (37, 1000), (3, 1)])
def test_node_gradients_match_autograd_of_the_plain_forward(shape):
    r = np.random.default_rng(5)
    logits = torch.from_numpy((3 * r.standard_normal(shape)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, shape[-1], shape[:-1]))
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    loss_node = _node(a, labels)
    loss_plain = ref.fused_xent(b, labels)
    assert torch.equal(loss_node, loss_plain)
    c = torch.from_numpy(r.standard_normal(shape[:-1]).astype(np.float32))
    (ga,) = torch.autograd.grad((loss_node * c).sum(), a)
    (gb,) = torch.autograd.grad((loss_plain * c).sum(), b)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6, atol=1e-6)


def test_node_gradcheck_float64_plain_launches():
    """gradcheck of the node in float64 (the plain launches take any float
    dtype; the kernels take float32 and bfloat16)."""
    r = np.random.default_rng(6)
    logits = torch.from_numpy(r.standard_normal((5, 11))).requires_grad_()
    labels = torch.from_numpy(r.integers(-11, 11, (5,)))
    assert torch.autograd.gradcheck(lambda x: _node(x, labels), (logits,))


def test_node_refuses_a_second_derivative():
    x = torch.randn(4, 9, dtype=torch.float64, requires_grad=True)
    loss = _node(x, torch.tensor([0, 3, 8, 1])).sum()
    with pytest.raises(xent_kernel.XentDoubleBackwardError):
        torch.autograd.grad(loss, x, create_graph=True)


def test_labels_index_as_the_reference_gathers():
    """A label in [-V, 0) counts from the end; outside [-V, V) the loss is
    NaN, as the reference's gather fills it."""
    logits = np.random.default_rng(7).standard_normal((4, 5)).astype(np.float32)
    labels = np.array([0, -1, 5, -6], np.int32)
    want = np.asarray(jref.fused_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = ref.fused_xent(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got[2]) and np.isnan(got[3]) and np.isnan(want[2])


def test_mean_equals_softmax_xent():
    logits, labels = _inputs(64, 256, seed=8)
    logits, labels = logits.reshape(4, 16, 256), labels.reshape(4, 16)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    mean = float(torch.mean(ref.fused_xent(tl, tlab)))
    np.testing.assert_allclose(mean, float(T.softmax_xent(tl, tlab)), rtol=1e-6)
    np.testing.assert_allclose(mean, float(jax_softmax_xent(jnp.asarray(logits),
                                                            jnp.asarray(labels))), rtol=1e-6)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    logits, labels = _inputs(8, 64, seed=9)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    xent_kernel.LAUNCHES["fused_xent"] = 0
    assert torch.equal(ops.fused_xent(tl, tlab), ref.fused_xent(tl, tlab))
    assert torch.equal(ops.fused_xent(tl, tlab, use_kernel=False), ref.fused_xent(tl, tlab))
    assert xent_kernel.LAUNCHES["fused_xent"] == 0
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        ops.fused_xent(tl, tlab, use_kernel=True)
    assert {"fused_xent", "fused_xent_bwd"} <= set(ops.launch_counts())


def test_launcher_checks_operands():
    x = torch.randn(4, 10)
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        xent_kernel.check_operands(x.double(), lab)
    with pytest.raises(ValueError, match="leading shape"):
        xent_kernel.check_operands(x, lab[:3])
    with pytest.raises(TypeError, match="integers"):
        xent_kernel.check_operands(x, lab.float())
    with pytest.raises(ValueError, match="contiguous"):
        xent_kernel.check_operands(torch.randn(10, 4).T, lab)
    with pytest.raises(ValueError, match="V >= 1"):
        xent_kernel.check_operands(torch.randn(4, 0), lab)
    with pytest.raises(ValueError, match="CUDA tensors"):
        xent_kernel.check_operands(x, lab)
