"""The port's Mamba2 SSD scan on the CPU against the JAX package: its plain
version (``repro_torch.kernels.ref.ssd_chunk``) against the sequential
definition ``repro.kernels.ref.ssd_scan``, the Pallas kernel run as the
JAX package's own tests run it (interpret mode), and the terminal state of
``repro.models.layers.ssd_chunked_dense``; the dispatch policy; the
launcher's operand checks; the CUDA kernel's arithmetic (its chunked form
at its chunk length with its operand roundings: bf16 tensor-core products,
or split TF32) emulated in torch and held to the same tolerances.

Tolerances are those of the JAX package's SSD tests
(tests/test_kernels.py:96, :120-122): rtol = atol = 2e-4 in float32 (the
chunked forms sum in another order than the recurrence); the terminal
state within 2e-4 of its largest magnitude; bfloat16 outputs 6e-2
(tests/test_kernels.py:21: 8 mantissa bits).  The CUDA kernel itself is
held to its plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py); its autograd node's backward is the plain version's
autograd, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.models.layers import ssd_chunked_dense
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd_kernel
from repro_torch.kernels.vjp import PlainVJP

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)

# (B, H, S, P, N, Pallas chunk): the JAX suite's three shapes
# (tests/test_kernels.py:83-87), a ragged S and S = 1.
SHAPES = [
    (1, 2, 128, 64, 32, 64),
    (2, 4, 256, 32, 16, 128),
    (1, 1, 64, 64, 64, 64),
    (2, 3, 100, 16, 16, 64),
    (2, 2, 1, 16, 16, 64),
]


def _inputs(B, H, S, P, N, seed=0):
    """The JAX suite's distributions: x ~ N(0, 1), a = −0.1|N(0, 1)|,
    b, c ~ 0.5·N(0, 1)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, S, P), dtype=np.float32)
    a = -np.abs(r.standard_normal((B, H, S), dtype=np.float32)) * np.float32(0.1)
    b = r.standard_normal((B, H, S, N), dtype=np.float32) * np.float32(0.5)
    c = r.standard_normal((B, H, S, N), dtype=np.float32) * np.float32(0.5)
    return x, a, b, c


def _seq_final(x, a, b):
    """Terminal state of the recurrence, in float64 with numpy."""
    x, a, b = (np.asarray(v, np.float64) for v in (x, a, b))
    h = np.zeros(b.shape[:2] + (b.shape[-1], x.shape[-1]))
    for t in range(x.shape[2]):
        h = np.exp(a[:, :, t])[..., None, None] * h + b[:, :, t, :, None] * x[:, :, t, None, :]
    return h


def _close_to_largest(got, want, rel=2e-4):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("B,H,S,P,N,chunk", SHAPES)
def test_plain_ssd_matches_jax_scan_and_pallas_f32(B, H, S, P, N, chunk):
    x, a, b, c = _inputs(B, H, S, P, N)
    y, h = ref.ssd_chunk(*map(torch.from_numpy, (x, a, b, c)))
    assert y.dtype == torch.float32 and y.shape == (B, H, S, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    jx, ja, jb, jc = map(jnp.asarray, (x, a, b, c))
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.ssd_scan(jx, ja, jb, jc)), **TOL)
    pallas = pallas_ssd_chunk(jx, ja, jb, jc, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **TOL)
    _close_to_largest(h.numpy(), _seq_final(x, a, b))


@pytest.mark.parametrize("S", [128, 100, 1])
def test_terminal_state_matches_ssd_chunked_dense(S):
    """The second output of the reference's ``ssd_chunked_dense`` (the
    state the mixer hands its decode cache), and its y."""
    x, a, b, c = _inputs(2, 2, S, 32, 16, seed=S)
    y, h = ref.ssd_chunk(*map(torch.from_numpy, (x, a, b, c)))
    jy, jh = ssd_chunked_dense(*map(jnp.asarray, (x, a, b, c)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _close_to_largest(h.numpy(), jh)


def test_plain_ssd_bf16_inputs():
    """bfloat16 x, b, c (float32 a, as the mixer gives): y comes back in
    bfloat16 within the bf16 tolerance of the JAX scan on the same bf16
    inputs; the state, float32 in both, within 2e-4 of its largest."""
    x, a, b, c = _inputs(2, 3, 100, 16, 16, seed=7)
    tx, tb, tc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    y, h = ref.ssd_chunk(tx, torch.from_numpy(a), tb, tc)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jx, jb, jc = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, b, c))
    want = jref.ssd_scan(jx, jnp.asarray(a), jb, jc)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)
    _close_to_largest(h.numpy(), _seq_final(tx.float(), a, tb.float()))


def test_plain_ssd_reads_head_broadcast_views():
    """b and c expanded over the heads with stride 0 (the mixer's layout)
    give what materialised copies give, bitwise."""
    x, a, b, c = map(torch.from_numpy, _inputs(2, 4, 37, 16, 16, seed=3))
    bv, cv = b[:, :1].expand(2, 4, 37, 16), c[:, :1].expand(2, 4, 37, 16)
    assert bv.stride(1) == 0
    y, h = ref.ssd_chunk(x, a, bv, cv)
    y2, h2 = ref.ssd_chunk(x, a, bv.contiguous(), cv.contiguous())
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_dispatch_runs_the_plain_version_on_cpu_tensors():
    x, a, b, c = map(torch.from_numpy, _inputs(1, 2, 40, 16, 16, seed=2))
    ops.reset_launch_counts()
    y, h = ops.ssd_chunk(x, a, b, c)
    y_ref, h_ref = ref.ssd_chunk(x, a, b, c)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    y2, h2 = ops.ssd_chunk(x, a, b, c, use_kernel=False)
    assert torch.equal(y2, y) and torch.equal(h2, h)
    assert ops.launch_counts()["ssd_chunk"] == 0
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.ssd_chunk(x, a, b, c, use_kernel=True)


def test_kernel_launcher_checks_operands():
    x, a, b, c = map(torch.from_numpy, _inputs(1, 2, 8, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_chunk(x, a, b, c)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_kernel.ssd_chunk(x.double(), a, b.double(), c.double())
    # shapes and layouts are checked before the device
    meta = dict(device="meta")
    mx = torch.empty(1, 2, 8, 64, **meta)
    ma = torch.empty(1, 2, 8, **meta)
    mb = torch.empty(1, 2, 8, 128, **meta)
    checks = [
        ((mx, ma, torch.empty(1, 2, 8, 32, **meta), torch.empty(1, 2, 8, 32, **meta)),
         ValueError, "state size N"),
        ((torch.empty(1, 2, 8, 32, **meta), ma, mb, mb), ValueError, "head dim P"),
        ((mx, ma[:, :, :4], mb, mb), ValueError, "want x"),
        ((mx, ma.double(), mb, mb), TypeError, "a must be float32"),
        ((mx, ma, mb.bfloat16(), mb), ValueError, "share x's dtype"),
        ((mx, ma, torch.empty(1, 2, 128, 8, **meta).transpose(2, 3), mb), ValueError,
         "contiguous"),
    ]
    for args, err, msg in checks:
        with pytest.raises(err, match=msg):
            ssd_kernel.check_operands(*args)
    assert ssd_kernel.LAUNCHES["ssd_chunk"] == 0


def _ssd_node(x, a, b, c):
    """The kernel's autograd node with the plain forward in the kernel's place."""
    return PlainVJP.apply(ref.ssd_chunk, ref.ssd_chunk, {}, x, a, b, c)


@pytest.mark.parametrize("outputs", ["both", "y", "h"])
def test_ssd_node_gradients_equal_plain_autograd_bitwise(outputs):
    """The mixer's layout — x and a transposed views of (B, S, H, ·) leaves,
    b and c (B, S, N) leaves expanded over the heads with stride 0 — into
    the launch's autograd node (backward: the plain recurrence's VJP at the
    saved views) gives autograd's gradients of the plain version bit for
    bit, for a loss linear in y, in the terminal state, or in both."""
    B, H, S, P, N = 2, 3, 21, 16, 16
    x, a, b, c = _inputs(B, H, S, P, N, seed=11)
    leaves = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))),
              torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))),
              torch.from_numpy(b[:, 0]), torch.from_numpy(c[:, 0])]
    leaves = [t.requires_grad_() for t in leaves]
    r = np.random.default_rng(12)
    cy = torch.from_numpy(r.standard_normal((B, H, S, P), dtype=np.float32))
    ch = torch.from_numpy(r.standard_normal((B, H, N, P), dtype=np.float32))

    def grads(f):
        xl, al, bl, cl = leaves
        bv, cv = (t[:, None].expand(B, H, S, N) for t in (bl, cl))
        assert bv.stride(1) == 0
        y, h = f(xl.transpose(1, 2), al.transpose(1, 2), bv, cv)
        loss = {"both": (y * cy).sum() + (h * ch).sum(), "y": (y * cy).sum(),
                "h": (h * ch).sum()}[outputs]
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    got, want = grads(_ssd_node), grads(ref.ssd_chunk)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert got[0].shape == leaves[0].shape and got[2].shape == (B, S, N)


# --- the CUDA kernel's arithmetic, emulated (csrc/ssd_chunk.cu) -----------

KERNEL_CHUNK = ssd_kernel.CHUNK  # kL in csrc/ssd_chunk.cu


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, on the bits: the kernel's ``tf32_rna``."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part a tensor core reads from float32 bits (toward zero)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_split_tf32(a, b):
    """a @ b from split halves (big = rna(x), small = x − big read as TF32):
    small·big + big·small + big·big, f32 accumulation."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _mm_one_tf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mm_bf16(a, b):
    """Both operands rounded to bf16, the products exact, f32 accumulation."""
    return _bf16(a) @ _bf16(b)


def _mm_bf16_hi_lo(a, b):
    """a split into bf16 hi + lo (two products), b rounded to bf16."""
    hi = _bf16(a)
    return _bf16(a - hi) @ _bf16(b) + hi @ _bf16(b)


def _mm_bf16_b_hi_lo(a, b):
    """a rounded to bf16, b split into bf16 hi + lo (two products)."""
    hi = _bf16(b)
    return _bf16(a) @ _bf16(b - hi) + _bf16(a) @ hi


SCHEMES = {
    # bf16 inputs: C·Bᵀ exact; G·decay, the H operand of C·H and B ⊙ w each
    # as bf16 hi + lo (one rounding of G or H misses y's 6e-2 at S = 2048,
    # one of B ⊙ w the state's 2e-4)
    "bf16": dict(cb=_mm_bf16, gx=_mm_bf16_hi_lo, ch=_mm_bf16_b_hi_lo, state=_mm_bf16_hi_lo),
    "split_tf32": dict(cb=_mm_split_tf32, gx=_mm_split_tf32, ch=_mm_split_tf32,
                       state=_mm_split_tf32),
    "one_tf32": dict(cb=_mm_one_tf32, gx=_mm_one_tf32, ch=_mm_one_tf32, state=_mm_one_tf32),
    "bf16_one_rounding": dict(cb=_mm_bf16, gx=_mm_bf16, ch=_mm_bf16, state=_mm_bf16),
}


def _emulated_ssd(x, a, b, c, scheme, L=KERNEL_CHUNK):
    """The kernel's chunked form at chunk L with its operand roundings, f32
    accumulators: per chunk G = (C·Bᵀ) ⊙ exp(cum_t − cum_s) on s ≤ t,
    Y = exp(cum_t)·(C·H) + G·X, H ← exp(cum_L)·H + (B ⊙ exp(cum_L −
    cum_s))ᵀ·X; the ragged last chunk padded with x = b = c = a = 0."""
    mm = SCHEMES[scheme]
    B, H, S, P = x.shape
    N = b.shape[-1]
    pad = -S % L
    xf, bf, cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in (x, b, c))
    af = torch.nn.functional.pad(a.float(), (0, pad))
    h = torch.zeros(B, H, N, P)
    ys = []
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    for t0 in range(0, S + pad, L):
        xc, bc, cc = (t[:, :, t0:t0 + L] for t in (xf, bf, cf))
        cum = torch.cumsum(af[:, :, t0:t0 + L], -1)
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, 0.0)
        g = torch.where(causal, mm["cb"](cc, bc.transpose(-1, -2)) * torch.exp(diff), 0.0)
        y = torch.exp(cum)[..., None] * mm["ch"](cc, h) + mm["gx"](g, xc)
        w = torch.exp(cum[..., -1:] - cum)
        h = torch.exp(cum[..., -1])[..., None, None] * h + mm["state"](
            (bc * w[..., None]).transpose(-1, -2), xc)
        ys.append(y)
    return torch.cat(ys, 2)[:, :, :S].to(x.dtype), h


# (B, H, S, P, N, a's scale): mamba2-1.3b's widths, the smoke config's, and
# a strong decay (a = −5|N(0, 1)|: exp(cum) underflows within a chunk)
EMULATED = [(1, 2, 512, 64, 128, 0.1), (2, 8, 100, 16, 16, 0.1), (1, 2, 300, 64, 128, 5.0)]


def test_emulated_bf16_needs_g_and_h_split():
    """At mamba2-1.3b's prefill length (S = 2048, 16 heads) one bf16 rounding
    of G or of the H operand puts bf16 outputs past the 6e-2 tolerance; with
    both split into hi + lo (the kernel's scheme) every output holds it.
    The worst margins (|Δ| − tolerance) are printed (``-s``) for PERF.md."""
    x, a, b, c = map(torch.from_numpy, _inputs(1, 16, 2048, 64, 128, seed=1))
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    want = ref.ssd_chunk(x, a, b, c)[0].float()
    single = dict(SCHEMES["bf16"], gx=_mm_bf16, ch=_mm_bf16)

    def margin(scheme):
        SCHEMES["_probe"] = scheme
        try:
            y = _emulated_ssd(x, a, b, c, "_probe")[0].float()
        finally:
            del SCHEMES["_probe"]
        return ((y - want).abs() - 6e-2 * (1 + want.abs())).max().item()

    got = {name: margin(scheme) for name, scheme in (
        ("bf16 (G, H split)", SCHEMES["bf16"]), ("G, H rounded once", single),
        ("G split, H once", dict(single, gx=_mm_bf16_hi_lo)),
        ("H split, G once", dict(single, ch=_mm_bf16_b_hi_lo)))}
    print("ssd (1, 16, 2048, 64, 128) bf16, worst |Δ| − tolerance:", got)
    assert got["bf16 (G, H split)"] < 0 < got["G, H rounded once"]
    assert got["H split, G once"] > 0


def _decay_inputs(B, H, S, P, N, scale, seed):
    x, a, b, c = _inputs(B, H, S, P, N, seed=seed)
    return x, a * np.float32(scale / 0.1), b, c


def _errors(got, want):
    (y, h), (y_ref, h_ref) = got, want
    return ((y.float() - y_ref.float()).abs().max().item(),
            (h - h_ref).abs().max().item() / h_ref.abs().max().item())


@pytest.mark.parametrize("B,H,S,P,N,scale", EMULATED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_kernel_arithmetic_holds_the_tolerances(B, H, S, P, N, scale, dtype):
    """The CUDA kernel's numeric scheme at its chunk (64), emulated in torch
    with its operand roundings — bf16 inputs: bf16 tensor-core products,
    B ⊙ w as hi + lo; f32 inputs: split TF32 — against the plain recurrence:
    y within rtol = atol = 2e-4 (f32) / 6e-2 (bf16), the state within 2e-4
    of its largest magnitude, finite at strong decay.  The errors of one TF32
    product and of one bf16 rounding of B ⊙ w are printed (``-s``) for
    PERF.md; each misses a tolerance the scheme holds, which is why the
    kernel splits."""
    x, a, b, c = map(torch.from_numpy, _decay_inputs(B, H, S, P, N, scale, seed=S))
    if dtype == "bfloat16":
        x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    want = ref.ssd_chunk(x, a, b, c)
    scheme, other = ("bf16", "bf16_one_rounding") if dtype == "bfloat16" else (
        "split_tf32", "one_tf32")
    y, h = _emulated_ssd(x, a, b, c, scheme)
    d_y, d_h = _errors((y, h), want)
    o_y, o_h = _errors(_emulated_ssd(x, a, b, c, other), want)
    print(f"ssd {(B, H, S, P, N)} a scale {scale} {dtype}: {scheme} y max |Δ| {d_y:.3g}, "
          f"state {d_h:.3g} of its largest; {other} y {o_y:.3g}, state {o_h:.3g}")
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    tol = 6e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(y.float(), want[0].float(), rtol=tol, atol=tol)
    assert d_h <= 2e-4
    assert o_h > 2e-4  # one rounding of B ⊙ w, or one TF32 product, misses the state's
