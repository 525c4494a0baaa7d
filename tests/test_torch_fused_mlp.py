"""The port's SDE field MLP on the CPU against the JAX package: its plain
version (``repro_torch.kernels.ref.fused_mlp``) against
``repro.kernels.ref.fused_mlp`` and the Pallas kernel run as the JAX
package's own tests run it (interpret mode); the plain backward
(``ref.fused_mlp_bwd``) against ``jax.vjp``; the autograd node the kernels
launch in (built here with the plain forward and backward in the kernels'
place) against autograd of the plain version and ``jax.vjp``; the route
``nn.mlp`` takes; the dispatch policy, the launcher's routing and its
operand checks.

Tolerances: float32 rtol = atol = 2e-5 and bfloat16 6e-2, the JAX kernel
suite's (tests/test_kernels.py:18-21: the kernel accumulates in float32
and sums in another order than the plain product); float64 1e-12 (the
products sum in different orders, and XLA's CPU exp and logistic differ
from torch's by an ulp).  The node's first derivative is the backward
launch (here ``ref.fused_mlp_bwd``) bitwise, and autograd of the plain
version within those tolerances; its second derivative is the plain
version's, bitwise.  The backward kernel's arithmetic (split-TF32 products,
its tile and cluster sums) is emulated here and held to ``jax.vjp``; its
launch plan's Python mirror is held to its rules.  The CUDA kernels
themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _fused_mlp_plan as plan_mirror
from _torch_parity import jax_config
from repro.kernels import ref as jref
from repro.kernels.fused_mlp import fused_mlp as pallas_fused_mlp
from repro_torch import nn
from repro_torch.kernels import fused_mlp as fm_kernel
from repro_torch.kernels import ops, ref, vjp
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
          (17, 32, 64), (32, 64, 32), (2, 32, 16), (17, 32, 32)]


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


def _node(*args, bwd=ref.fused_mlp_bwd):
    """The kernels' autograd node with the plain forward and backward in the
    kernels' place."""
    return fm_kernel.MLPFunction.apply(ref.fused_mlp, bwd, *args)


def _leaves(din, h, dout, dtype=torch.float64, lead=(5,), seed=1):
    return [torch.from_numpy(a).to(dtype).requires_grad_()
            for a in _inputs(lead, din, h, dout, seed=seed)]


@pytest.mark.parametrize("din,h,dout", FIELDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_backward_matches_jax_vjp(din, h, dout, dtype):
    """``ref.fused_mlp_bwd`` against ``jax.vjp`` of the reference's plain
    MLP at every SDE field width."""
    arrays = _inputs((37,), din, h, dout, seed=din + 2 * h)
    ct = np.random.default_rng(dout).standard_normal((37, dout))
    with jax_config(x64=dtype == "float64"):
        (tx, *tw), (jx, *jw) = _both(arrays, dtype)
        (tg,), (jg,) = _both([ct], dtype)
        got = ref.fused_mlp_bwd(tx, *tw, tg)
        _, vjp = jax.vjp(jref.fused_mlp, jx, *jw)
        want = vjp(jg)
        for t, a, w in zip((tx, *tw), got, want):
            assert a.dtype == t.dtype and a.shape == t.shape
            _close(a, w, dtype)


def _pallas_body(x, w1, b1, w2, b2):
    """The Pallas kernel's arithmetic (src/repro/kernels/fused_mlp.py:26-32)
    as plain JAX, which jax.vjp differentiates: float32 products, the hidden
    activation rounded to x's dtype."""
    h = jnp.dot(x, w1, preferred_element_type=jnp.float32) + b1
    h = 0.909 * h * jax.nn.sigmoid(h)
    o = jnp.dot(h.astype(x.dtype), w2, preferred_element_type=jnp.float32)
    return (o + b2).astype(x.dtype)


@pytest.mark.parametrize("din,h,dout", [(17, 32, 16), (32, 64, 32), (96, 48, 24)])
def test_plain_backward_bf16_matches_jax_vjp_of_the_kernel_arithmetic(din, h, dout):
    """bfloat16: float32 arithmetic with ``a`` rounded, as the Pallas kernel
    computes the forward, against jax.vjp of that arithmetic (6e-2)."""
    arrays = _inputs((37,), din, h, dout, seed=h)
    ct = np.random.default_rng(5).standard_normal((37, dout))
    with jax_config():
        (tx, *tw), (jx, *jw) = _both(arrays, "bfloat16")
        (tg,), (jg,) = _both([ct], "bfloat16")
        got = ref.fused_mlp_bwd(tx, *tw, tg)
        _, vjp = jax.vjp(_pallas_body, jx, *jw)
        for t, a, w in zip((tx, *tw), got, vjp(jg)):
            assert a.dtype == torch.bfloat16 and a.shape == t.shape
            _close(a, w, "bfloat16")


@pytest.mark.parametrize("din,h,dout", [(17, 32, 16), (32, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_node_backward_is_the_launch_bitwise_and_plain_autograd_within_tol(din, h, dout, dtype):
    """A loss linear in the output, and one that is not (through tanh and a
    product upstream of x): every gradient is the backward launch's at the
    cotangent autograd delivers, bitwise, and autograd of the plain version's
    within the tolerances (the backward kernel has its own sum order, so
    the node no longer recomputes the plain version's autograd)."""
    leaves = _leaves(din, h, dout, dtype, lead=(3, 7))
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 7, dout))).to(dtype)
    losses = (lambda out: (out * c).sum(), lambda out: torch.sin(out).pow(2).sum())

    def grads(f):
        x, *w = leaves
        return [torch.autograd.grad(loss(f(torch.tanh(x * 1.5), *w)), leaves)
                for loss in losses]

    def by_hand():
        """The same chain with the backward called by hand."""
        x, *w = leaves
        xin = torch.tanh(x * 1.5)
        out = ref.fused_mlp(xin.detach(), *(t.detach() for t in w))
        for loss in losses:
            o = out.detach().requires_grad_()
            g, = torch.autograd.grad(loss(o), o)
            dxin, *dw = ref.fused_mlp_bwd(xin.detach(), *(t.detach() for t in w), g)
            dx, = torch.autograd.grad(xin, x, dxin, retain_graph=True)
            yield [dx, *dw]

    tol = TOL["float32" if dtype == torch.float32 else "float64"]
    for got, hand, want in zip(grads(_node), by_hand(), grads(ref.fused_mlp)):
        assert all(torch.equal(a, b) for a, b in zip(got, hand))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **tol)


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


def _chain(f, x, w, depth):
    """``depth`` field evaluations sharing one set of weights, as a solve
    chains a field through its steps (a tanh between, as the CDE's)."""
    for _ in range(depth):
        x = torch.tanh(f(x, *w))
    return x


def test_node_create_graph_vjp_is_partial_through_shared_weights():
    """Under create_graph a node's VJP is its own partial derivative: with
    the weights shared by a chain of nodes (a solve's steps), the gradient
    w.r.t. the weights and the penalty's second derivative are the plain
    chain's.  Differentiating the recomputation by the saved tensors
    themselves took the weights' total derivative through the history
    instead: 590.47 for 752.94 at depth 2 here, and exponential cost."""
    x, *w = _leaves(4, 6, 4)
    runs = []
    for f in (_node, ref.fused_mlp):
        y = _chain(f, x, w, 2)
        gw1, gx = torch.autograd.grad((y ** 2).sum(), [w[0], x], create_graph=True)
        runs.append((gw1, gx, *torch.autograd.grad((gx ** 2).sum() + gw1.sum(), w[:3])))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_node_create_graph_vjp_runs_once_a_node(monkeypatch):
    """A create_graph gradient through a chain of 12 nodes recomputes each
    node's plain version once (it was 2^depth)."""
    calls = []

    def counted(plain, *args):
        calls.append(1)
        return vjp.plain_vjp(plain, *args)

    monkeypatch.setattr(fm_kernel, "plain_vjp", counted)
    x, *w = _leaves(4, 6, 4)
    torch.autograd.grad(_chain(_node, x, w, 12).sum(), x, create_graph=True)
    assert len(calls) == 12


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
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x[0, 0], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x, w1[0], b1, w2, b2)
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x, w1, b1, w2, b2[:3])
    with pytest.raises(ValueError, match="want x"):
        fm_kernel.fused_mlp(x[:, :0], w1[:0], b1, w2, b2)
    with pytest.raises(ValueError, match="b1 is"):
        fm_kernel.fused_mlp(x, w1, b1.double(), w2, b2)
    with pytest.raises(ValueError, match="x must be contiguous"):
        fm_kernel.fused_mlp(x.t().contiguous().t(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="b2 must be contiguous"):
        fm_kernel.fused_mlp(x, w1, b1, w2, torch.zeros(8)[::2])
    with pytest.raises(ValueError, match="CUDA tensors"):  # checked before any node
        fm_kernel.fused_mlp(x.requires_grad_(), w1, b1, w2, b2)
    wide = torch.empty(6000, 200, dtype=torch.float64)
    with pytest.raises(ValueError, match="Din \\+ H"):
        fm_kernel.fused_mlp(torch.empty(1, 6000, dtype=torch.float64), wide,
                            torch.empty(200, dtype=torch.float64), wide[:200, :4],
                            torch.empty(4, dtype=torch.float64))
    assert fm_kernel.LAUNCHES == {"fused_mlp": 0, "fused_mlp_bwd": 0}


def _spied(calls):
    """``ref.fused_mlp_bwd`` counting its calls."""
    def bwd(*args):
        calls.append(len(args))
        return ref.fused_mlp_bwd(*args)
    return bwd


@pytest.mark.parametrize("need", [(0,), (1, 2), (3, 4), (0, 3), (0, 1, 2, 3, 4)])
def test_node_honours_needs_input_grad(need):
    """Only the inputs that require a gradient get one (None for the rest,
    from one backward launch); with none, backward is never reached."""
    arrays = _inputs((6,), 17, 32, 16, seed=7)
    leaves = [torch.from_numpy(a).requires_grad_(i in need) for i, a in enumerate(arrays)]
    calls = []
    out = _node(*leaves, bwd=_spied(calls))
    grads = torch.autograd.grad(out.sum(), [leaves[i] for i in need], retain_graph=True)
    want = ref.fused_mlp_bwd(*leaves, torch.ones_like(out))
    assert calls == [6]
    for i, gr in zip(need, grads):
        assert torch.equal(gr, want[i])
    with torch.no_grad():  # the node's own return: None where no gradient is needed
        full = fm_kernel.MLPFunction.backward(out.grad_fn, torch.ones_like(out))[2:]
    assert [i for i, gr in enumerate(full) if gr is not None] == list(need)
    with torch.no_grad():
        assert _node(*leaves).grad_fn is None


def _routed(monkeypatch, calls):
    """The launcher with the plain versions in the kernels' place (counted):
    the routing between a launch with a node and one without."""
    monkeypatch.setattr(fm_kernel, "check_operands", lambda *a: None)
    monkeypatch.setattr(fm_kernel, "_launch", lambda *a: (calls.append("fwd"),
                                                          ref.fused_mlp(*a))[1])
    monkeypatch.setattr(fm_kernel, "_launch_bwd", lambda *a: (calls.append("bwd"),
                                                              ref.fused_mlp_bwd(*a))[1])


def test_launcher_routes_one_backward_launch_per_node(monkeypatch):
    """A launch that can carry a gradient is one node whose backward is one
    launch of the backward kernel; under create_graph it is the plain VJP
    (no launch); a launch nothing differentiates makes no node."""
    calls = []
    _routed(monkeypatch, calls)
    x, *w = _leaves(17, 32, 16, lead=(4,))
    out = fm_kernel.fused_mlp(x, *w)
    assert type(out.grad_fn).__name__ == "MLPFunctionBackward"
    out.sum().backward()
    assert calls == ["fwd", "bwd"]
    calls.clear()
    gx, = torch.autograd.grad(fm_kernel.fused_mlp(x, *w).sum(), x, create_graph=True)
    assert calls == ["fwd"] and gx.grad_fn is not None
    calls.clear()
    plain = [t.detach() for t in (x, *w)]
    assert fm_kernel.fused_mlp(*plain).grad_fn is None
    with torch.no_grad():
        assert fm_kernel.fused_mlp(x, *w).grad_fn is None
    assert calls == ["fwd", "fwd"]


# ---- the backward kernel's arithmetic, emulated ---------------------------
#
# csrc/fused_mlp.cu's fused_mlp_bwd runs every product on mma.sync tensor
# cores in split TF32 (float32): each operand x = big + small with big =
# x rounded to TF32 (nearest, ties away: tensor_core.cuh tf32_rna) and
# small = x − big, which the tensor core reads truncated to TF32; each
# product is small·big, big·small and big·big in three accumulators, added
# as big + (small ones) after at most 64 of depth, the 64-deep pieces added
# in order.  The sums over rows add each tile's product to the block's
# running sum, and the cluster adds the blocks' sums in ascending rank.
# The emulation rounds each MMA once (its 8 products summed exactly, then
# to float32) and takes σ as torch computes it: the card's tensor core may
# sum with fewer bits, and the kernel's float32 σ (ex2/rcp.approx) is a few
# ulp off, which the card tests measure.


def _tf32_bits(v: torch.Tensor, mask_only: bool) -> torch.Tensor:
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits if mask_only else bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _split(v: torch.Tensor):
    """(big, small as the tensor core reads it) of float32 ``v``."""
    big = _tf32_bits(v, mask_only=False)
    return big, _tf32_bits(v - big, mask_only=True)


def _mma_chain(a, b, k0, k1, step=8):
    """float32 c accumulated over k-steps of ``step``, each MMA rounded once."""
    c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k in range(k0, k1, step):
        c = (c + a[:, k:k + step].double() @ b[k:k + step].double()).float().double()
    return c.float()


def _tc_product(a, b, split=True):
    """A (M, K) · B (K, N), float32, as the kernel's warp_product sums it
    (K zero-padded to a multiple of 8); ``split=False``: one TF32 rounding
    of each operand, one accumulator (the precision split TF32 buys)."""
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ab, as_), (bb, bs) = _split(a), _split(b)
    out = None
    for k0 in range(0, a.shape[1], 64):
        k1 = min(k0 + 64, a.shape[1])
        if split:
            d = _mma_chain(ab, bb, k0, k1) + (_mma_chain(as_, bb, k0, k1)
                                              + _mma_chain(ab, bs, k0, k1))
        else:
            d = _mma_chain(ab, bb, k0, k1)
        out = d if out is None else out + d
    return out


def _emulated_bwd(x, w1, b1, w2, g, split=True):
    """fused_mlp_bwd's float32 arithmetic, tile by tile and block by block
    as the plan (its mirror, ``_fused_mlp_plan.bwd_plan``) lays the rows out
    -> (dx, dW1, db1, dW2, db2)."""
    rows, din = x.shape
    hidden, dout = w2.shape
    plan = plan_mirror.bwd_plan(0, rows, din, hidden, dout)
    tile, tpb = plan["tile"], plan["tiles_per_block"]
    tiles = -(-rows // tile)
    ones = torch.ones(rows, 1)
    pre = _tc_product(x, w1, split) + b1
    sg = 1.0 / (1.0 + torch.exp(-pre))
    ps = pre * sg
    a = 0.909 * ps
    dpre = _tc_product(g, w2.T.contiguous(), split) * (0.909 * (sg + ps * (1.0 - sg)))
    dx = _tc_product(dpre, w1.T.contiguous(), split)
    xa, aa = torch.cat([x, ones], 1), torch.cat([a, ones], 1)
    blocks = []
    for b0 in range(0, tiles, tpb):
        acc1 = acc2 = None
        for t in range(b0, min(b0 + tpb, tiles)):
            r = slice(t * tile, min((t + 1) * tile, rows))
            c1 = _tc_product(dpre[r].T.contiguous(), xa[r], split)  # (H, Din + 1)
            c2 = _tc_product(g[r].T.contiguous(), aa[r], split)     # (Dout, H + 1)
            acc1 = c1 if acc1 is None else acc1 + c1
            acc2 = c2 if acc2 is None else acc2 + c2
        blocks.append((acc1, acc2))
    s1, s2 = blocks[0]
    for acc1, acc2 in blocks[1:]:  # the cluster's ascending rank order
        s1, s2 = s1 + acc1, s2 + acc2
    return dx, s1[:, :din].T, s1[:, din], s2[:, :hidden].T, s2[:, hidden]


def _fan_in_inputs(rows, din, h, dout, seed):
    """x, g ~ N(0, 1), W ~ N(0, 1/fan_in), b ~ 0.1·N(0, 1): the card tests'
    draws (a 512-wide layer's sums stay O(1))."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((rows, din)), r.standard_normal((din, h)) / np.sqrt(din),
            0.1 * r.standard_normal(h), r.standard_normal((h, dout)) / np.sqrt(h),
            0.1 * r.standard_normal(dout), r.standard_normal((rows, dout)))


def _bwd_margins(rows, din, h, dout, split):
    """Worst |Δ| − tolerance of each emulated gradient against jax.vjp of
    the reference MLP (float32; dW and db held within MLP_TOL of their
    largest as well, as on the card)."""
    *arrays, ct = _fan_in_inputs(rows, din, h, dout, seed=rows + din)
    with jax_config():
        (tx, *tw), (jx, *jw) = _both(arrays, "float32")
        (tg,), (jg,) = _both([ct], "float32")
        got = _emulated_bwd(tx, tw[0], tw[1], tw[2], tg, split)
        _, vjp = jax.vjp(jref.fused_mlp, jx, *jw)
        want = [torch.from_numpy(np.array(w)) for w in vjp(jg)]
    out = {}
    for name, a, w in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        atol = 2e-5 if name == "dx" else max(2e-5, 2e-5 * w.abs().max().item())
        assert a.shape == w.shape
        out[name] = ((a - w).abs() - (atol + 2e-5 * w.abs())).max().item()
    return out


@pytest.mark.parametrize("rows,din,h,dout", [(64, 17, 32, 16), (1024, 17, 32, 16),
                                             (4096, 17, 32, 16), (300, 512, 512, 512),
                                             (128, 2, 32, 16), (1024, 17, 32, 32)])
def test_emulated_backward_kernel_holds_the_f32_tolerance(rows, din, h, dout):
    """The kernel's split-TF32 products, tile and cluster sums hold MLP_TOL
    against jax.vjp at the ELBO shape (R 64, 1024 and 4096: several tiles
    a block), at 512 -> 512 -> 512, R = 300, and at the SDE-GAN
    discriminator's xi (2 -> 32 -> 16, R 128) and g (17 -> 32 -> 32, R
    1024); the margins are printed (``-s``) for PERF.md."""
    got = _bwd_margins(rows, din, h, dout, split=True)
    print(f"fused_mlp_bwd emulated split TF32 {(rows, din, h, dout)}, worst |Δ| − tol:", got)
    assert all(m < 0 for m in got.values()), got


def test_emulated_backward_needs_split_tf32():
    """One TF32 rounding of each operand misses the float32 tolerance at the
    ELBO shape: the products need the split."""
    got = _bwd_margins(1024, 17, 32, 16, split=False)
    print("fused_mlp_bwd emulated one-TF32 (1024, 17, 32, 16), worst |Δ| − tol:", got)
    assert max(got.values()) > 0, got


@pytest.mark.parametrize("code", [0, 1, 2])
def test_backward_plan_is_a_function_of_dtype_rows_and_widths(code):
    """The plan (``_fused_mlp_plan.bwd_plan``, the mirror of the kernel's
    ``plan_bwd`` that a card test holds to ``rt_fused_mlp_bwd_plan``):
    one cluster of 16 blocks; tiles of a multiple of the product's M rows
    that cover R; every SDE field's sums in shared memory (no partials),
    the 512-wide MLP's in global partials; several tiles a block at R =
    4096; the same plan for the same arguments, whatever was asked before."""
    m = 8 if code == 2 else 16
    shapes = FIELDS + [(96, 48, 24), (512, 512, 512)]
    first = {(r, s): plan_mirror.bwd_plan(code, r, *s) for r in (1, 64, 300, 1024, 4096)
             for s in shapes}
    for (rows, shape), p in reversed(list(first.items())):
        assert p == plan_mirror.bwd_plan(code, rows, *shape)
        assert p["blocks"] == plan_mirror.BWD_CLUSTER == 16
        assert p["tile"] % m == 0 and p["tile"] <= plan_mirror.BWD_TILE_MAX
        assert p["tile"] * p["tiles_per_block"] * 16 >= rows
        assert p["smem_bytes"] <= plan_mirror.BWD_SMEM_MAX
        assert (p["partial_bytes"] == 0) == (shape != (512, 512, 512)) == p["smem"]
    elbo = {r: first[(r, (17, 32, 16))] for r in (1, 64, 1024, 4096)}
    assert [(p["tile"], p["tiles_per_block"]) for p in elbo.values()] == (
        [(8, 1), (8, 1), (64, 1), (128, 2)] if code == 2 else
        [(16, 1), (16, 1), (64, 1), (128, 2)])
    assert plan_mirror.bwd_plan(code, 300, 512, 512, 512)["partial_bytes"] == (
        16 * (2 * 512 * 512 + 1024) * (8 if code == 2 else 4))
    # the sums and weights of the SDE fields stay in shared memory at every R
    assert all(first[(r, s)]["smem"] for r in (1, 64, 300, 1024, 4096) for s in FIELDS)
