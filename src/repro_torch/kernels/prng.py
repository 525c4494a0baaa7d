"""Counter-based PRNG in plain PyTorch, bitwise ``jax.random`` (Threefry-2x32).

Port of :mod:`repro.kernels.prng`, op for op, plus the two key helpers the
reference takes from ``jax.random`` itself: :func:`PRNGKey` and
:func:`split` (``jax.random.split`` under ``jax_threefry_partitionable=
False``, the layout ``repro.kernels.prng`` transcribes).

These are the plain versions of the device functions in
``csrc/threefry.cuh``; the CUDA kernels and the CPU path both follow them.
:func:`randint` is ``jax.random.randint``'s algorithm (two ``random_bits``
draws from a split key, combined modulo the span), bitwise.

Representation: every 32-bit word is an ``int64`` tensor holding a value in
``[0, 2**32)``.  On the CPU, torch's ``uint32`` has no ``+``, ``<<`` or
``>>``, so additions are masked back to 32 bits and the right shift of a
non-negative ``int64`` is the logical shift Threefry needs.  A key is an
``int64`` tensor of shape ``(..., 2)``; the functions taking ``(k1, k2)``
broadcast over any leading batch shape, so one call draws a row per key.

Floats: bits, counters and keys are exact.  The normal transform copies
XLA's ``erf_inv`` polynomials for float32 and float64 (coefficients and op
order read from the compiled HLO of ``jax.lax.erf_inv``), written as
separate multiplies and adds.  XLA on the CPU contracts them into FMAs and
its ``log1p`` differs from torch's, so normals agree with ``jax.random``
within a few ulp, not bitwise; tests/test_torch_prng.py states the bound.
bfloat16 draws follow ``jax.random``'s: a 7-bit mantissa takes 8-bit words
(``rng_bits = 8`` where ``nmant < 8``), the uniform is exact, the
``erf_inv`` runs in float32 and is rounded to bfloat16 before the product
with bfloat16 ``sqrt(2)``; tests/test_torch_lm_zoo.py states the ulp bound.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# XLA's ErfInv for float32: 9 coefficients, branch on w < 5.
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)

# XLA's ErfInv for float64: three branches on w (< 6.25, < 16, >= 16) with
# 23, 19 and 17 coefficients.
_ERFINV64_LT625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027)
_ERFINV64_LT16 = (
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208)
_ERFINV64_GE16 = (
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _words(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash; words broadcast like tensors."""
    k1 = _words(k1)
    k2 = _words(k2, k1.device)
    x1 = _words(x1, k1.device)
    x2 = _words(x2, k1.device)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    schedule = ((_ROT_A, 1, 2), (_ROT_B, 2, 0), (_ROT_A, 0, 1),
                (_ROT_B, 1, 2), (_ROT_A, 2, 0))
    for i, (rots, ka, kb) in enumerate(schedule):
        for r in rots:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[ka]) & MASK
        x2 = (x2 + ks[kb] + (i + 1)) & MASK
    return x1, x2


def seed_pair(data) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` words of a non-negative integer counter."""
    data = torch.as_tensor(data, dtype=torch.int64)
    return (data >> 32) & MASK, data & MASK


def fold_in(k1, k2, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """New key words, bitwise ``jax.random.fold_in(key, data)``."""
    k1 = _words(k1)
    hi, lo = seed_pair(data)
    return threefry2x32(k1, k2, hi.to(k1.device), lo.to(k1.device))


def _hash_counters(k1, k2, max_count: int):
    """Hash ``iota(max_count)`` split in halves (JAX's odd-size zero pad).

    Returns ``(y1, y2, half, odd)`` with ``y1, y2`` of shape
    ``(*key_shape, half)``."""
    k1 = _words(k1)
    k2 = _words(k2, k1.device)
    odd = max_count % 2
    half = (max_count + odd) // 2
    counts = torch.arange(half, dtype=torch.int64, device=k1.device)
    x2 = counts + half
    if odd:
        x2[half - 1] = 0
    return (*threefry2x32(k1[..., None], k2[..., None], counts, x2), half, odd)


def _bits64_halves(k1, k2, size: int):
    """``(hi, lo)`` words of the 64-bit stream: element i is ``hi << 32 | lo``."""
    y1, y2, _, _ = _hash_counters(k1, k2, 2 * size)
    return y1, y2


def random_bits(k1, k2, bit_width: int, size: int) -> torch.Tensor:
    """``(*key_shape, size)`` draws, bitwise ``_threefry_random_bits``.

    32-bit words come back as ``int64`` in ``[0, 2**32)``; 64-bit words as
    the ``int64`` with the same bit pattern as JAX's ``uint64``; 8- and
    16-bit words as ``int64`` in ``[0, 2**bit_width)``: the 32-bit stream of
    ``ceil(bit_width·size / 32)`` words cut into its sub-words, the low ones
    first (``bits.view(uint8 or uint16)[:size]``)."""
    if bit_width in (8, 16):
        per = 32 // bit_width
        words = random_bits(k1, k2, 32, -(-size // per))
        shifts = torch.arange(0, 32, bit_width, dtype=torch.int64, device=words.device)
        subs = (words[..., None] >> shifts) & ((1 << bit_width) - 1)
        return subs.flatten(-2)[..., :size]
    if bit_width == 32:
        y1, y2, half, odd = _hash_counters(k1, k2, size)
        return torch.cat([y1, y2[..., :half - odd]], -1)
    if bit_width == 64:
        hi, lo = _bits64_halves(k1, k2, size)
        hi_signed = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi)
        return (hi_signed * 2 ** 32) | lo
    raise ValueError(f"bit_width must be 8, 16, 32 or 64, got {bit_width}")


def _window_hash(k1, k2, size: int, window, dtype):
    """The words of elements ``[e0, e0 + count)`` of a ``size``-element
    draw, ``window = (e0, count)``: in float32 element ``e`` is lane 0 of
    counter pair ``e`` (``e < half``) or lane 1 of pair ``e − half``, the
    odd pad's second counter 0; in float64 the 64-bit element ``e`` is its
    own pair ``(e, e + size)`` -> ``(hi, lo)`` words."""
    e0, count = window
    if e0 < 0 or count < 0 or e0 + count > size:
        raise ValueError(f"window ({e0}, {count}) is not inside a draw of {size}")
    k1 = _words(k1)
    k2 = _words(k2, k1.device)
    e = torch.arange(e0, e0 + count, dtype=torch.int64, device=k1.device)
    if dtype == torch.float64:
        return threefry2x32(k1[..., None], k2[..., None], e, e + size)
    half = (size + 1) // 2
    second = e >= half
    j = torch.where(second, e - half, e)
    x2 = torch.where(j + half < size, j + half, torch.zeros_like(j))
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], j, x2)
    return torch.where(second, y2, y1), None


def uniform(k1, k2, size: int, dtype, window=None) -> torch.Tensor:
    """Unit uniforms ``bitcast(mantissa | 1.0) - 1`` in ``[0, 1)``; with
    ``window = (e0, count)`` only elements ``[e0, e0 + count)`` of the
    ``size``-element draw, bitwise that slice of it (a data-parallel rank's
    rows of a one-key draw).  bfloat16 draws 8-bit words, as ``jax.random``
    does for a mantissa of fewer than 8 bits, and takes no window."""
    if dtype == torch.bfloat16 and window is None:
        bits = random_bits(k1, k2, 8, size) >> 1       # 7 mantissa bits
        return (bits | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"uniform draws float32, float64 or (without a window) bfloat16, "
                         f"got {dtype}")
    if window is not None:
        hi, lo = _window_hash(k1, k2, size, window, dtype)
    elif dtype == torch.float32:
        hi, lo = random_bits(k1, k2, 32, size), None
    else:
        hi, lo = _bits64_halves(k1, k2, size)
    if dtype == torch.float32:
        f = ((hi >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    else:
        f = ((hi << 20) | (lo >> 12) | 0x3FF0000000000000).view(torch.float64)
    return f - 1.0


def uniform_range(k1, k2, size: int, dtype, minval, maxval, window=None) -> torch.Tensor:
    """``jax.random.uniform(key, (size,), dtype, minval, maxval)`` (its
    ``window`` slice, as :func:`uniform`)."""
    np_dtype = _NP_DTYPES[dtype]
    lo = np.array(minval, np_dtype)
    scale = np.array(maxval, np_dtype) - lo
    floats = uniform(k1, k2, size, dtype, window)
    lo_t = torch.full((), float(lo), dtype=dtype, device=floats.device)
    return torch.maximum(lo_t, floats * float(scale) + float(lo))


def _erf_inv32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * (-x))
    lt = w < 5.0
    ww = torch.where(lt, w + (-2.5), torch.sqrt(w) + (-3.0))

    def coef(a, b):
        return torch.where(lt, torch.full((), a, dtype=x.dtype, device=x.device),
                           torch.full((), b, dtype=x.dtype, device=x.device))

    p = coef(_ERFINV32_LT5[0], _ERFINV32_GE5[0])
    for a, b in zip(_ERFINV32_LT5[1:], _ERFINV32_GE5[1:]):
        p = coef(a, b) + p * ww
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def _erf_inv64(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * (-x))
    lt625 = w < 6.25
    lt16 = w < 16.0

    def c(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    ww = torch.where(lt625, w + (-3.125),
                     torch.sqrt(w) - torch.where(lt16, c(3.25), c(5.0)))

    def coef(i):
        if i >= 19:
            return c(_ERFINV64_LT625[i])
        k = torch.where(lt625, c(_ERFINV64_LT625[i]), c(_ERFINV64_LT16[i]))
        return torch.where(lt16, k, c(_ERFINV64_GE16[i])) if i < 17 else k

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * ww
    for i in (17, 18):
        p = torch.where(lt16, coef(i) + p * ww, p)
    for i in range(19, 23):
        p = torch.where(lt625, p * ww + coef(i), p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv``'s polynomial, op for op (not ``torch.erfinv``)."""
    if x.dtype == torch.float32:
        return _erf_inv32(x)
    if x.dtype == torch.float64:
        return _erf_inv64(x)
    raise ValueError(f"erf_inv takes float32 or float64, got {x.dtype}")


def normal(k1, k2, size: int, dtype, window=None) -> torch.Tensor:
    """``(*key_shape, size)`` standard normals, ``jax.random.normal``'s
    transform: ``sqrt(2)·erf_inv(uniform(nextafter(-1, 0), 1))``; with
    ``window = (e0, count)`` the ``(*key_shape, count)`` elements ``[e0, e0
    + count)`` of that draw, bitwise (:func:`uniform`)."""
    if dtype == torch.bfloat16:
        return _normal_bf16(k1, k2, size, window)
    np_dtype = _NP_DTYPES[dtype]
    lo = np.nextafter(np.array(-1.0, np_dtype), np.array(0.0, np_dtype),
                      dtype=np_dtype)
    u = uniform_range(k1, k2, size, dtype, lo, np.array(1.0, np_dtype), window)
    return erf_inv(u) * float(np.array(np.sqrt(2), np_dtype))


def _normal_bf16(k1, k2, size: int, window=None) -> torch.Tensor:
    """bfloat16 normals, ``jax.random.normal``'s arithmetic: the uniform on
    ``[nextafter(-1, 0), 1)`` in bfloat16 (every op exact there: 8-bit
    words on a grid of 2^-8), ``erf_inv`` in float32 rounded to bfloat16,
    times bfloat16 ``sqrt(2)`` rounded.  No window (no caller shards one)."""
    if window is not None:
        raise ValueError("bfloat16 normals take no window")
    bf16 = torch.bfloat16
    floats = uniform(k1, k2, size, bf16)
    one = torch.ones((), dtype=bf16, device=floats.device)
    lo = torch.nextafter(-one, torch.zeros_like(one))
    u = torch.maximum(lo, floats * (one - lo) + lo)
    sqrt2 = torch.full((), math.sqrt(2), dtype=bf16, device=floats.device)
    return erf_inv(u.float()).to(bf16) * sqrt2


def normal_like(k1, k2, shape: Tuple[int, ...], dtype, window=None) -> torch.Tensor:
    """Shaped normals, ``(*key_shape, *shape)``.  With ``window = (e0,
    size)``, ``shape`` is the local block: elements ``[e0, e0 +
    prod(shape))`` of a ``size``-element draw."""
    if window is None:
        z = normal(k1, k2, math.prod(shape), dtype)
    else:
        z = normal(k1, k2, window[1], dtype, (window[0], math.prod(shape)))
    return z.reshape(z.shape[:-1] + tuple(shape))


# -----------------------------------------------------------------------------
# key helpers (jax.random's, in the partitionable=False layout)
# -----------------------------------------------------------------------------


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the ``(2,)`` key ``[seed >> 32, seed & mask]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in_key(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on ``(..., 2)`` keys -> ``(..., 2)``;
    ``data`` broadcasts against the key batch."""
    return torch.stack(fold_in(key[..., 0], key[..., 1], data), -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., 2)`` -> ``(..., num, 2)``.

    ``_threefry_split_original``: hash ``iota(2·num)`` and read the flat
    output as ``num`` key pairs — the 32-bit stream of ``2·num`` words."""
    bits = random_bits(key[..., 0], key[..., 1], 32, 2 * num)
    return bits.reshape(bits.shape[:-1] + (num, 2))



def randint(key: torch.Tensor, size: int, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint(key, (size,), minval, maxval, dtype)``, bitwise;
    a ``(*K, 2)`` batch of keys draws ``(*K, size)``, one row per key.

    ``dtype`` int32 draws 32-bit words, int64 64-bit words — JAX's default
    ``int`` is int32 without x64 and int64 with it.  JAX's unsigned modular
    arithmetic is carried on int64 words: 32-bit products are masked back
    to 32 bits, and 64-bit ones wrap as two's complement, the same bits as
    ``uint64`` wrapping."""
    nbits = {torch.int32: 32, torch.int64: 64}.get(dtype)
    if nbits is None:
        raise TypeError(f"randint draws int32 or int64, got {dtype}")
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else maxval - minval
    if span >= 2 ** 63:
        raise ValueError(f"randint: span {span} does not fit the int64 words")
    mult = pow(2, nbits // 2, span) ** 2 % 2 ** nbits % span  # uint product wraps
    k = split(key)
    hi_bits = random_bits(k[..., 0, 0], k[..., 0, 1], nbits, size)
    lo_bits = random_bits(k[..., 1, 0], k[..., 1, 1], nbits, size)
    if nbits == 32:
        off = ((hi_bits % span) * mult + lo_bits % span) & MASK
    else:
        off = _urem64(hi_bits, span) * mult + _urem64(lo_bits, span)
    off = _urem64(off, span) if nbits == 64 else off % span
    return (minval + off).to(dtype)


def _urem64(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of the uint64 bit patterns held in int64 ``x``."""
    r = torch.remainder(x, m)  # of the signed value; a negative one is u - 2**64
    return torch.where(x < 0, (r + 2 ** 64 % m) % m, r)
