"""The port's plain kernel versions (repro_torch.kernels.ref, reached
through repro_torch.kernels.ops on CPU tensors) against repro.kernels.ref
and the Pallas kernels in interpret mode, on the CPU.

Tolerances (stated per the port's parity rules):
* elementwise phases: rtol=1e-6, atol=1e-7 in float32; rtol=1e-14,
  atol=1e-15 in float64.  XLA contracts the phases' multiply-adds into FMAs;
  the port rounds every op (as its CUDA kernels do with -fmad=false).
* Brownian point values (``brownian_value``) sum ``depth + 1`` scaled
  normals: rtol 1e-5, atol 1e-6 in float32, atol 1e-10 in float64 (the
  normal bounds, and XLA's FMA-contracted combine).
* Brownian increments are normals scaled by sqrt(dt): in float32 the phase
  tolerance holds (normals within 4 ulp); in float64 they carry the normal
  bound of tests/test_torch_prng.py (2**19 ulp: XLA's CPU float64 normal
  wobbles by up to 6e-11 relative at |z| > 3.3).  ``rev_heun_phase1_gen``'s
  state update is then checked at the phase tolerance on the reference's ΔW.
"""

import functools
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from _torch_parity import TORCH_DTYPES, jax_config, key_words, torch_keys, ulp_distance
from repro.kernels import brownian as jbk
from repro.kernels import ref as jref
from repro.kernels import reversible_heun_step as jrh
from repro_torch.kernels import ops, prng, ref

TOL = {"float32": dict(rtol=1e-6, atol=1e-7), "float64": dict(rtol=1e-14, atol=1e-15)}
NORMAL_ULP = {"float32": 4, "float64": 2 ** 19}
CASES = [("float32", (1, 16)), ("float32", (8, 17)), ("float64", (1, 17)),
         ("float64", (8, 16))]
# The redesigned kernels' plain versions also at the training path's one-key
# draw (one row of 64·17) and an odd width (the last counter pair's zero pad).
ONE_KEY_CASES = [("float32", (1, 1088)), ("float64", (1, 1088)), ("float32", (4, 3)),
                 ("float64", (4, 3))]


def _state(seed, shape, dtype, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _close(got, want, dtype):
    torch.testing.assert_close(torch.as_tensor(np.array(got)),
                               torch.as_tensor(np.array(want)), **TOL[dtype])


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype,shape", CASES + ONE_KEY_CASES)
def test_rev_heun_phase2_matches_ref_and_pallas(dtype, shape, sign):
    args = _state(10, shape, dtype, 6)
    got = ops.rev_heun_phase2(*map(torch.from_numpy, args), 0.3, sign=sign)
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(functools.partial(jref.rev_heun_phase2, sign=sign))(*args, 0.3)
        pallas = jax.jit(lambda *a: jrh.rev_heun_phase2(*a, sign=sign, interpret=True))(
            *args, 0.3)
    _close(got, want, dtype)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype,shape", CASES)
def test_rev_heun_phase1_matches_ref_and_pallas(dtype, shape, sign):
    args = _state(11, shape, dtype, 5)
    got = ops.rev_heun_phase1(*map(torch.from_numpy, args), 0.01, sign=sign)
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(functools.partial(jref.rev_heun_phase1, sign=sign))(*args, 0.01)
        pallas = jax.jit(lambda *a: jrh.rev_heun_phase1(*a, sign=sign, interpret=True))(
            *args, 0.01)
    _close(got, want, dtype)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype,shape", CASES + ONE_KEY_CASES)
def test_rev_heun_phase1_equals_the_op_by_op_ref_bitwise(dtype, shape, sign):
    """ẑ₁ rounds every op, so it is bitwise the JAX ref run op by op (each
    primitive its own XLA computation, so nothing is contracted into an
    FMA).  The jitted ref and the Pallas kernel contract ``μ·(sign·Δt)`` and
    ``(sign·σ)·ΔW`` into FMAs; where the terms (|2z − ẑ| up to ~6) cancel to
    a small ẑ₁, one such rounding exceeds the phase tolerance's atol (float32
    (1, 1088) at sign -1: 1.19e-7 at |ẑ₁| = 0.016), so the one-key cases are
    held here, bitwise."""
    args = _state(11, shape, dtype, 5)
    got = ops.rev_heun_phase1(*map(torch.from_numpy, args), 0.01, sign=sign)
    with jax_config(x64=dtype == "float64"):
        want = np.asarray(jref.rev_heun_phase1(*args, 0.01, sign=sign))
    assert got.numpy().tobytes() == want.tobytes()


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded once to float32, to nearest, ties to even: the nearest of
    the float32 rounding of ``float(x)`` and its two neighbours."""
    c = np.float32(float(x))
    near = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.uint32)) & 1))


def _fma_f32(a, b, c) -> np.float32:
    """``fma(a, b, c)`` in float32: ``a·b + c`` exact, rounded once."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _phase1_fma_model(z, zh, mu, sigma, dw, dt, sign):
    """XLA's float32 phase 1: ``fma(sign·σ, ΔW, fma(μ, sign·Δt, 2z − ẑ))``.
    ``2z − ẑ``, ``sign·Δt`` and ``sign·σ`` round once in float32 (the
    latter two exactly: sign is ±1); each FMA forms ``a·b + c`` exactly as
    a ``Fraction`` and rounds it once to float32 (``_round_f32``), with no
    float64 step between (which could round twice)."""
    a = np.float32(2.0) * z - zh
    sdt = np.float32(sign) * np.float32(dt)
    out = np.empty_like(z)
    for i in np.ndindex(z.shape):
        inner = _fma_f32(mu[i], sdt, a[i])
        out[i] = _fma_f32(np.float32(sign) * sigma[i], dw[i], inner)
    return out


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("shape", sorted({shape for _, shape in CASES + ONE_KEY_CASES}))
def test_rev_heun_phase1_jit_and_pallas_are_the_fma_model_bitwise(shape, sign):
    """The jitted JAX ref and the Pallas kernel (interpret mode) of phase 1
    are, in float32, bitwise ``fma(sign·σ, ΔW, fma(μ, sign·Δt, 2z − ẑ))``
    (``_phase1_fma_model``) at every shape of ``CASES + ONE_KEY_CASES``:
    where they differ from the port (which rounds every op, as its CUDA
    kernel does), it is by those two contractions and nothing else."""
    args = _state(11, shape, "float32", 5)
    with jax_config(x64=False):
        want = np.asarray(jax.jit(functools.partial(jref.rev_heun_phase1, sign=sign))(
            *args, 0.01))
        pallas = np.asarray(jax.jit(lambda *a: jrh.rev_heun_phase1(
            *a, sign=sign, interpret=True))(*args, 0.01))
    model = _phase1_fma_model(*args, 0.01, sign)
    assert want.tobytes() == model.tobytes()
    assert pallas.tobytes() == model.tobytes()


@pytest.mark.parametrize("dtype,shape", CASES + ONE_KEY_CASES)
def test_rev_heun_bwd_phase1_matches_ref_and_pallas(dtype, shape):
    args = _state(15, shape, dtype, 4)
    got = ops.rev_heun_bwd_phase1(*map(torch.from_numpy, args), 0.01)
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(jref.rev_heun_bwd_phase1)(*args, 0.01)
        pallas = jax.jit(lambda *a: jrh.rev_heun_bwd_phase1(*a, interpret=True))(*args, 0.01)
    assert len(got) == 2
    for g, w, p in zip(got, want, pallas):
        _close(g, w, dtype)
        _close(g, p, dtype)


@pytest.mark.parametrize("dtype,shape", CASES + ONE_KEY_CASES)
def test_rev_heun_bwd_phase2_matches_ref_and_pallas(dtype, shape):
    args = _state(16, shape, dtype, 3)
    got = ops.rev_heun_bwd_phase2(*map(torch.from_numpy, args), 0.01)
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(jref.rev_heun_bwd_phase2)(*args, 0.01)
        pallas = jax.jit(lambda *a: jrh.rev_heun_bwd_phase2(*a, interpret=True))(*args, 0.01)
    assert len(got) == 4
    for g, w, p in zip(got, want, pallas):
        _close(g, w, dtype)
        _close(g, p, dtype)


def test_backward_phases_equal_autograd_of_the_unfused_step_bitwise():
    """In-port identity the fused adjoint rests on: with the field VJP
    stubbed by the identity, the two phases are autograd's transpose of the
    step's elementwise algebra, bit for bit (float64)."""
    rng = np.random.default_rng(17)
    z, zh, mu, sg, mu1, sg1, dw, g_z, g_zh, g_mu, g_sg = (
        torch.from_numpy(rng.standard_normal((5, 17))) for _ in range(11))
    dt = 0.03
    leaves = [x.clone().requires_grad_() for x in (z, zh, mu, sg, mu1, sg1)]
    z_, zh_, mu_, sg_, mu1_, sg1_ = leaves
    zh1 = 2.0 * z_ - zh_ + mu_ * dt + sg_ * dw
    z1 = z_ + 0.5 * (mu_ + mu1_) * dt + (0.5 * (sg_ + sg1_)) * dw
    grads = torch.autograd.grad((z1, zh1, mu1_, sg1_), leaves, (g_z, g_zh, g_mu, g_sg))
    c_mu1, c_sig1 = ops.rev_heun_bwd_phase1(g_z, g_mu, g_sg, dw, dt)
    assert torch.equal(c_mu1, grads[4]) and torch.equal(c_sig1, grads[5])
    d = ops.rev_heun_bwd_phase2(g_z, g_zh, dw, dt)  # ĝ = g_zh: no field term
    for got, want in zip(d, grads[:4]):
        assert torch.equal(got, want)


def _assert_increment_close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    if dtype == "float32":
        _close(got, want, dtype)
    assert ulp_distance(got, want).max() <= NORMAL_ULP[dtype]


@pytest.mark.parametrize("n", [7])
@pytest.mark.parametrize("dtype,shape", CASES)
def test_brownian_increment_matches_ref_and_pallas(dtype, shape, n):
    words = key_words(12, shape[0])
    dt = 1.0 / 23
    got = ops.brownian_increment(torch_keys(words), n, shape[1:], TORCH_DTYPES[dtype], dt)
    assert got.shape == shape and got.dtype == TORCH_DTYPES[dtype]
    with jax_config(x64=dtype == "float64"):
        want = jax.jit(jax.vmap(lambda k1, k2, d: jref.brownian_increment(
            k1, k2, n, shape[1:], dtype, d), in_axes=(0, 0, None)))(*words.T, dt)
        pallas = jax.jit(jax.vmap(lambda k1, k2, d: jbk.brownian_increment(
            k1, k2, n, shape[1:], dtype, d, interpret=True), in_axes=(0, 0, None)))(
            *words.T, dt)
    _assert_increment_close(got, want, dtype)
    _assert_increment_close(got, pallas, dtype)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype,shape", CASES + ONE_KEY_CASES)
def test_rev_heun_phase1_gen_matches_pallas(dtype, shape, sign):
    """Both directions: +1 is the forward's draw, -1 the exact adjoint's
    reconstruction, which draws its ΔW in the same launch."""
    words = key_words(13, shape[0])
    z, zh, mu, sigma = _state(14, shape, dtype, 4)
    dt = 1.0 / 23
    zh1, dw = ops.rev_heun_phase1_gen(*map(torch.from_numpy, (z, zh, mu, sigma)),
                                      torch_keys(words), 3, dt, dt, sign)
    with jax_config(x64=dtype == "float64"):
        j_zh1, j_dw = jax.jit(jax.vmap(lambda z_, zh_, mu_, s_, k1, k2: jbk.rev_heun_phase1_gen(
            z_, zh_, mu_, s_, k1, k2, 3, dt, dt, sign=sign, interpret=True)))(
            z, zh, mu, sigma, *words.T)
    _assert_increment_close(dw, j_dw, dtype)
    on_ref_dw = ref.rev_heun_phase1(*map(torch.from_numpy, (z, zh, mu, sigma)),
                                    torch.from_numpy(np.array(j_dw)), dt, sign)
    _close(on_ref_dw, j_zh1, dtype)
    # in-port identity: the in-kernel ΔW is BrownianPath.increment's
    inc = ops.brownian_increment(torch_keys(words), 3, shape[1:], TORCH_DTYPES[dtype], dt)
    assert torch.equal(dw, inc)
    assert torch.equal(zh1, ref.rev_heun_phase1(*map(torch.from_numpy, (z, zh, mu, sigma)),
                                                inc, dt, sign))


def test_dispatch_policy_on_cpu():
    """CPU tensors run the plain version; use_kernel=True needs CUDA tensors,
    and no launch is counted."""
    ops.reset_launch_counts()
    x = torch.zeros(2, 3)
    assert torch.equal(ops.rev_heun_phase2(x, x, x, x, x, x, 0.1), x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.rev_heun_phase2(x, x, x, x, x, x, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.rev_heun_phase1(x, x, x, x, x, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.rev_heun_bwd_phase1(x, x, x, x, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.rev_heun_bwd_phase2(x, x, x, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.brownian_increment(torch.zeros(2, 2, dtype=torch.int64), 0, (3,),
                               torch.float32, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.brownian_value(torch.zeros(2, 2, dtype=torch.int64), torch.zeros(2), 0.0, 1.0,
                           (3,), torch.float32, use_kernel=True)
    assert torch.equal(ops.brownian_value(torch.zeros(2, 2, dtype=torch.int64),
                                          torch.zeros(2), 0.0, 1.0, (3,), torch.float32),
                       torch.zeros(2, 3))
    assert set(ops.launch_counts().values()) == {0}


VALUE_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=0.0, atol=1e-10)}


@pytest.mark.parametrize("depth", [10, 24])
@pytest.mark.parametrize("dtype,shape", [("float32", (5, 4)), ("float64", (5, 3))])
def test_brownian_value_matches_ref_and_pallas(dtype, shape, depth):
    """Per-row keys and per-row times (t0, t1, a dyadic point, random
    points); tolerance as tests/test_torch_brownian.py states for values."""
    words = key_words(18, shape[0])
    ts = np.concatenate([[0.0, 1.0, 0.375], np.random.default_rng(19).random(shape[0] - 3)])
    got = ops.brownian_value(torch_keys(words), torch.from_numpy(ts).to(TORCH_DTYPES[dtype]),
                             0.0, 1.0, shape[1:], TORCH_DTYPES[dtype], depth)
    assert got.shape == shape and got.dtype == TORCH_DTYPES[dtype]
    with jax_config(x64=dtype == "float64"):
        t = ts.astype(dtype)
        want = jax.jit(jax.vmap(lambda k1, k2, tt: jref.brownian_value(
            k1, k2, tt, 0.0, 1.0, shape[1:], dtype, depth)))(*words.T, t)
        pallas = jax.jit(jax.vmap(lambda k1, k2, tt: jbk.brownian_value(
            k1, k2, tt, 0.0, 1.0, shape[1:], dtype, depth, interpret=True)))(*words.T, t)
    for w in (want, pallas):
        torch.testing.assert_close(got, torch.from_numpy(np.array(w)), **VALUE_TOL[dtype])
    assert torch.equal(got[0], torch.zeros(shape[1:], dtype=TORCH_DTYPES[dtype]))


def _normals_of_bits(y1, y2, dtype):
    """``jax.random.normal``'s transform of one hash's two output words:
    float32 -> the two normals of the counter pair's elements; float64 ->
    the one element whose 64-bit draw is ``y1 << 32 | y2``."""
    if dtype == torch.float32:
        f = torch.stack([((y >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
                         for y in (y1, y2)]) - 1.0
    else:
        f = (((y1 << 20) | (y2 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(np.array(-1.0, np_dtype), np.array(0.0, np_dtype))
    scale = float(np.array(1.0, np_dtype) - lo)  # rounds to 2 in both types
    u = torch.maximum(torch.tensor(float(lo), dtype=dtype), f * scale + float(lo))
    return prng.erf_inv(u) * float(np.array(np.sqrt(2), np_dtype))


def _draws_by_unit(k1, k2, d, dtype):
    """``normal(key, (d,))`` for each row's key, one hash per draw unit as
    the CUDA kernel's stage 2 takes them: in float32 the counter pair
    ``(u, u + half)`` gives elements u and u + half (for odd d the last
    pair's second counter is JAX's zero pad); in float64 the pair
    ``(i, i + d)`` gives element i."""
    rows = k1.shape[0]
    out = torch.empty((rows, d), dtype=dtype)
    if dtype == torch.float32:
        half = (d + 1) // 2
        for u in range(half):
            x1 = 0 if d % 2 and u == half - 1 else u + half
            y1, y2 = prng.threefry2x32(k1, k2, torch.full_like(k1, u), torch.full_like(k1, x1))
            z = _normals_of_bits(y1, y2, dtype)
            out[:, u] = z[0]
            if u + half < d:
                out[:, u + half] = z[1]
    else:
        for i in range(d):
            y1, y2 = prng.threefry2x32(k1, k2, torch.full_like(k1, i),
                                       torch.full_like(k1, i + d))
            out[:, i] = _normals_of_bits(y1, y2, dtype)
    return out


@pytest.mark.parametrize("d", [4, 5])
@pytest.mark.parametrize("rows", [1, 1000])
@pytest.mark.parametrize("depth", [0, 1, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_brownian_value_rebuilt_stage_by_stage_is_bitwise_the_plain_version(dtype, depth,
                                                                            rows, d):
    """The CUDA kernel's three stages, in plain PyTorch: the walk
    (``bridge_descent``: chain, midpoint keys, bits, intervals, stds), the
    draws one hash per (level, unit) with the kernel's counter pairing, and
    the combine level by level, then the tail — bitwise
    ``ref.brownian_value``, so the kernel's order of independent work
    changes no bit."""
    g = torch.Generator().manual_seed(rows + depth + d)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64)
    t = torch.rand(rows, generator=g, dtype=torch.float64)
    t[:3] = torch.tensor([0.0, 1.0, 0.375])[:rows]
    t = t.to(dtype)
    k1, k2 = keys[:, 0], keys[:, 1]
    # 1. walk
    stds, gos, km1, km2, a, b = ref.bridge_descent(k1, k2, t, 0.0, 1.0, depth)
    r1, r2 = prng.fold_in(k1, k2, 0xB0B)
    # 2. draws: the root, then every level
    z_root = _draws_by_unit(r1, r2, d, dtype)
    z_levels = [_draws_by_unit(km1[lv], km2[lv], d, dtype) for lv in range(depth)]
    # 3. combine, then the tail
    sqrt_span = torch.sqrt(torch.tensor(1.0, dtype=dtype))
    wb = z_root * sqrt_span
    wa = torch.zeros_like(wb)
    for lv in range(depth):
        wm = 0.5 * (wa + wb) + stds[lv][:, None] * z_levels[lv]
        left = gos[lv][:, None]
        wa, wb = torch.where(left, wa, wm), torch.where(left, wm, wb)
    frac = torch.clamp((t - a) / torch.clamp(b - a, min=torch.finfo(dtype).tiny), 0.0, 1.0)
    staged = wa + frac[:, None] * (wb - wa)
    want = ref.brownian_value(k1, k2, t, 0.0, 1.0, (d,), dtype, depth)
    assert staged.dtype == want.dtype and torch.equal(staged, want)
