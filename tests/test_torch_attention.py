"""The port's GQA attention on the CPU against the JAX package: its plain
version (``repro_torch.kernels.ref.flash_attention``) against the Pallas
kernel run as the JAX package's own tests run it (interpret mode) and
against ``repro.kernels.ref.flash_attention``; and the dispatch policy.

Tolerances are those of the JAX package's kernel suite
(tests/test_kernels.py:18-21): float32 rtol = atol = 2e-5 (the Pallas
kernel's online softmax sums in another order than the plain softmax);
bfloat16 6e-2 (8 mantissa bits; P is rounded to bf16 before P·V in every
version, at different points of the sum).  The CUDA kernel itself is held
to its plain version on the card (tests/test_torch_cuda.py, chip_smoke.py);
its autograd node's backward is the plain version's autograd, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.vjp import PlainVJP

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)

SHAPES = [
    (1, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 256, 64),      # GQA 4:1
    (1, 4, 1, 128, 128),     # MQA
    (2, 4, 4, 64, 32),       # S below the Pallas block
    (1, 10, 2, 200, 128),    # group 5 (qwen2.5-14b's), S no power-of-two block divides
]


def _inputs(B, Hq, Hkv, S, D, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, S, D), dtype=np.float32)
    k = r.standard_normal((B, Hkv, S, D), dtype=np.float32)
    v = r.standard_normal((B, Hkv, S, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", SHAPES)
def test_plain_attention_matches_pallas_and_jax_ref_f32(B, Hq, Hkv, S, D, causal):
    q, k, v = _inputs(B, Hq, Hkv, S, D)
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = pallas_flash_attention(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention(jq, jk, jv, causal=causal)),
                               **F32_TOL)


def test_plain_attention_matches_pallas_and_jax_ref_bf16():
    q, k, v = _inputs(1, 10, 2, 200, 128, seed=1)
    got = ref.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for want in (pallas_flash_attention(jq, jk, jv, interpret=True),
                 jref.flash_attention(jq, jk, jv)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_TOL)


def test_plain_default_scale_is_rounded_to_the_dtype():
    """ref.py rounds 1/sqrt(D) to the input dtype; the Pallas kernel (and the
    CUDA kernel) take the float — so an explicit float scale gives the
    plain version the kernel's scale."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 2, 1, 16, 128))
    rounded = ref.flash_attention(q, k, v, scale=torch.tensor(0.08837890625))
    assert torch.equal(ref.flash_attention(q, k, v), rounded)
    assert not torch.equal(ref.flash_attention(q, k, v, scale=1 / 128 ** 0.5), rounded)


def test_dispatch_runs_the_plain_version_on_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(2, 8, 2, 40, 16))
    ops.reset_launch_counts()
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, ref.flash_attention(q, k, v, causal=causal))
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal, use_kernel=False), got)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.flash_attention(q, k, v, use_kernel=True)


def test_kernel_launcher_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(1, 4, 1, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.double(), k.double(), v.double())
    assert fa_kernel.LAUNCHES["flash_attention"] == 0


def _attention_node(q, k, v, causal, scale):
    """The kernel's autograd node with the plain forward in the kernel's place."""
    return PlainVJP.apply(ref.flash_attention, ref.flash_attention,
                          {"causal": causal, "scale": scale}, q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 4, 1, 33, 16), (2, 10, 2, 40, 64)])
def test_attention_node_gradients_equal_plain_autograd_bitwise(B, Hq, Hkv, S, D, causal):
    """The launch's autograd node (backward: the plain version's VJP at the
    saved q, k, v and float scale) gives autograd's gradients of the plain
    version bit for bit, for a loss linear in the output and one through a
    projection upstream of q."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(B, Hq, Hkv, S, D, seed=S))
    c = torch.from_numpy(np.random.default_rng(9).standard_normal((B, Hq, S, D),
                                                                  dtype=np.float32))
    scale = 1 / D ** 0.5

    def grads(f):
        out = f(torch.tanh(q) * 2.0, k, v, causal, scale)
        return torch.autograd.grad((out * c).sum(), (q, k, v))

    got, want = grads(_attention_node), grads(ref.flash_attention)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(g.abs().max() > 0 for g in got)


def test_attention_node_second_derivative_is_the_plain_versions():
    """create_graph through the node, a first loss linear in the output: the
    second derivative is the plain version's, bit for bit."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(1, 2, 1, 9, 16, seed=4))
    c = torch.linspace(-1.0, 1.0, q.numel()).reshape(q.shape)

    def grads(f):
        gq, = torch.autograd.grad((f(q, k, v, True, 0.25) * c).sum(), q, create_graph=True)
        return torch.autograd.grad(gq.pow(2).sum(), (q, k, v))

    got, want = grads(_attention_node), grads(ref.flash_attention)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
