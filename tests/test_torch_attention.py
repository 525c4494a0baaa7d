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

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

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


# --- the kernel's operand layouts (a pure function of shapes, strides, dtypes
# and addresses, so it runs here) and the LM reading them in place ---------

LAYOUT_SHAPES = [(2, 8, 2, 40, 64), (1, 10, 2, 129, 128), (1, 4, 1, 1, 16), (2, 4, 4, 33, 16)]


def _layout(t):
    return t.shape, t.stride(), t.dtype, t.data_ptr()


def _metadata(*ts):
    return [list(x) for x in zip(*map(_layout, ts))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bshd", [False, True], ids=["contiguous", "bshd_views"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", LAYOUT_SHAPES)
def test_kernel_strides_accept_views_and_contiguous(B, Hq, Hkv, S, D, bshd, dtype):
    """(B, S, H, D) buffers' transposed views and contiguous (B, H, S, D)
    tensors both go in; the strides come back as the tensors have them,
    a size-1 axis's as a contiguous tensor's would be."""
    if bshd:
        q, k, v = (torch.zeros(B, S, h, D, dtype=dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    else:
        q, k, v = (torch.zeros(B, h, S, D, dtype=dtype) for h in (Hq, Hkv, Hkv))
    got = fa_kernel.kernel_strides(*_metadata(q, k, v))
    want = tuple(tuple(c if n == 1 else st for n, st, c in
                       zip(t.shape[:3], t.stride()[:3], (t.shape[1] * S * D, S * D, D)))
                 for t in (q, k, v))
    assert got == want
    if bshd and S > 1:
        assert got[0] == (S * Hq * D, D, Hq * D)


def _refused(case):
    """Metadata of q, k, v (B 2, Hq 8, Hkv 2, S 40, D 64, bf16 at 0x1000)
    with one fault."""
    shapes = [(2, 8, 40, 64), (2, 2, 40, 64), (2, 2, 40, 64)]
    strides = [(20480, 2560, 64, 1), (5120, 2560, 64, 1), (5120, 2560, 64, 1)]
    dtypes = [torch.bfloat16] * 3
    addresses = [0x1000, 0x40000, 0x80000]
    if case == "last_stride":
        strides[1] = (5120, 2560, 64, 2)
    elif case == "misaligned_base":
        addresses[2] = 0x80000 + 2
    elif case == "row_stride":
        strides[0] = (20480, 2560, 68, 1)
    elif case == "mixed_dtypes":
        dtypes[2] = torch.float32
    elif case == "heads":
        shapes[1] = shapes[2] = (2, 3, 40, 64)
    return shapes, strides, dtypes, addresses


@pytest.mark.parametrize("case,match", [
    ("last_stride", "k's last stride must be 1"),
    ("misaligned_base", "v's base address 0x80002 is not 16-byte aligned"),
    ("row_stride", "q's batch, head and row strides must be positive multiples of 8"),
    ("mixed_dtypes", "mixed dtypes"),
    ("heads", "Hq % Hkv == 0"),
])
def test_kernel_strides_refuse_what_the_kernel_cannot_read(case, match):
    fa_kernel.kernel_strides(*_refused(None))  # the faultless layout goes in
    with pytest.raises(ValueError, match=match):
        fa_kernel.kernel_strides(*_refused(case))


def test_kernel_launcher_checks_layouts_before_the_device():
    """A misaligned view is refused by name on any device; a good layout on
    the CPU then meets the device check."""
    q, k, v = map(torch.from_numpy, _inputs(1, 4, 1, 16, 64))
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # 4 bytes past an aligned base
    with pytest.raises(ValueError, match="q's base address .* is not 16-byte aligned"):
        fa_kernel.check_operands(shifted, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.check_operands(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 8, 2, 40, 64), (1, 10, 2, 129, 128),
                                          (2, 4, 4, 33, 16)])
def test_plain_attention_on_bshd_views_is_bitwise_the_contiguous(B, Hq, Hkv, S, D, causal,
                                                                 dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(B, Hq, Hkv, S, D, seed=S))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(ref.flash_attention(*views, causal=causal),
                       ref.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "tinyllama-1.1b"])
def test_gqa_attend_is_bitwise_unchanged_without_the_copies(arch, dtype, monkeypatch):
    """The LM's attention on the CPU, reading the (B, S, H, D) projections
    in place, gives the bits it gave on contiguous copies."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    params = layers.gqa_init(torch.Generator().manual_seed(3), cfg)
    x = torch.randn(2, 37, cfg.d_model, generator=torch.Generator().manual_seed(4)).to(dtype)
    out, (k, v) = layers.gqa_attend(params, cfg, x)
    monkeypatch.setattr(layers, "_attend_dispatch", lambda cfg, q, k, v, causal:
                        ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=causal))
    out_copies, (k_copies, v_copies) = layers.gqa_attend(params, cfg, x)
    assert out.dtype == dtype
    assert torch.equal(out, out_copies) and torch.equal(k, k_copies) and torch.equal(v, v_copies)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, on the bits: the CUDA kernel's ``tf32_rna``."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part the tensor core reads from float32 bits (the low 13
    bits dropped: toward zero)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's split: big = rna(x), small = x - big (exact), of which
    the tensor core reads the TF32 part."""
    big = _tf32_rna(x)
    return big, _tf32_trunc(x - big)


def _matmul_3xtf32(a, b):
    """a @ b in f32 accumulation from the split halves: a_small·b_big +
    a_big·b_small, then + a_big·b_big, as the kernel issues them."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _matmul_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _emulated_attention(q, k, v, matmul):
    """Causal GQA attention with both products through ``matmul`` and the
    softmax in f32; P stays f32 before P·V (``p.astype(v.dtype)`` is a
    no-op in f32)."""
    group = q.shape[1] // k.shape[1]
    kk, vv = (x.repeat_interleave(group, dim=1) for x in (k, v))
    s = matmul(q, kk.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    S = q.shape[2]
    s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool).tril(), -np.inf)
    return matmul(torch.softmax(s, dim=-1), vv)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 4, 1, 200, 64), (1, 4, 1, 200, 128)])
def test_split_tf32_products_hold_the_f32_tolerance(B, Hq, Hkv, S, D):
    """The f32 CUDA kernel's arithmetic (csrc/flash_attention.cu: each
    product as three TF32 products of split halves, f32 accumulators),
    emulated in torch: within the f32 tolerance (2e-5) of the plain f32
    attention, where one TF32 product alone is not.  The two errors are
    printed (``-s``) for PERF.md."""
    q, k, v = map(torch.from_numpy, _inputs(B, Hq, Hkv, S, D, seed=5))
    want = ref.flash_attention(q, k, v, causal=True, scale=1 / np.sqrt(D))
    split = _emulated_attention(q, k, v, _matmul_3xtf32)
    single = _emulated_attention(q, k, v, _matmul_1xtf32)
    err_split = (split - want).abs().max().item()
    err_single = (single - want).abs().max().item()
    print(f"attention {(B, Hq, Hkv, S, D)} causal: split TF32 max |Δ| {err_split:.3g}, "
          f"one TF32 product {err_single:.3g}")
    torch.testing.assert_close(split, want, **F32_TOL)
    assert not torch.allclose(single, want, **F32_TOL)
    # the split is exact: big + small gives back x, and big keeps 11 bits
    x = q.flatten()
    big, _ = _split(x)
    assert torch.equal(big + (x - big), x)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
