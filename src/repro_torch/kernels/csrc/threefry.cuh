// Threefry-2x32 and the normal transform of jax.random, as device functions.
//
// Replaces the in-kernel PRNG of the TPU kernels, src/repro/kernels/prng.py
// (threefry2x32 :58, fold_in :95, random_bits :101, uniform :130,
// normal :155).  The plain version is src/repro_torch/kernels/prng.py; both
// follow JAX's partitionable=False layout:
//
//   * a row of `size` 32-bit draws hashes the counters iota(size), split in
//     halves: element i reads lane 1 of counter pair i (i < half) or lane 2
//     of pair i - half, where pair j is (j, j + half) and, for odd size, the
//     last pair's second counter is JAX's zero pad;
//   * a row of `size` 64-bit draws hashes pairs (i, i + size): element i is
//     (lane1 << 32) | lane2.
//
// So every element is a pure function of (key, i): a grid of one thread per
// element needs no communication.  Float arithmetic goes through the
// __f*_rn / __d*_rn intrinsics, which are never contracted into FMAs, in
// the order of the plain version (each torch op rounds once).  log1p and
// sqrt are the CUDA math library's, as torch's own kernels call them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define RT_ROUND4(x0, x1, a, b, c, d) \
  x0 += x1; x1 = rotl32(x1, a) ^ x0;  \
  x0 += x1; x1 = rotl32(x1, b) ^ x0;  \
  x0 += x1; x1 = rotl32(x1, c) ^ x0;  \
  x0 += x1; x1 = rotl32(x1, d) ^ x0;

// The 20-round hash: key (k0, k1), counters (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  RT_ROUND4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  RT_ROUND4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  RT_ROUND4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  RT_ROUND4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  RT_ROUND4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

#undef RT_ROUND4

// jax.random.fold_in(key, n): hash the counter pair (n >> 32, n & mask).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, int64_t n) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(n) >> 32);
  uint32_t x1 = static_cast<uint32_t>(static_cast<uint64_t>(n));
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// ---------------------------------------------------------------------------
// float32: 32-bit draws, mantissa bitcast, XLA's ErfInv32
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1, int64_t i,
                                           int64_t size) {
  const int64_t odd = size & 1;
  const int64_t half = (size + odd) / 2;
  const int64_t j = i < half ? i : i - half;
  uint32_t x0 = static_cast<uint32_t>(j);
  uint32_t x1 = (odd && j == half - 1) ? 0u : static_cast<uint32_t>(j + half);
  threefry2x32(k0, k1, x0, x1);
  return i < half ? x0 : x1;
}

__device__ __forceinline__ float erf_inv(float x) {
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float ww = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = __fadd_rn(lt ? 3.43273939e-07f : 0.000100950558f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? -3.5233877e-06f : 0.00134934322f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? -4.39150654e-06f : -0.00367342844f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? 0.00021858087f : 0.00573950773f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? -0.00125372503f : -0.0076224613f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? -0.00417768164f : 0.00943887047f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? 0.246640727f : 1.00167406f, __fmul_rn(p, ww));
  p = __fadd_rn(lt ? 1.50140941f : 2.83297682f, __fmul_rn(p, ww));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// The float32 normal of one 32-bit draw b.
__device__ __forceinline__ float normal_f32_bits(uint32_t b) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  // uniform on [nextafter(-1, 0), 1): scale (1 - lo) rounds to 2 in float32
  const float lo = __uint_as_float(0xBF7FFFFFu);  // nextafter(-1, 0)
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  return __fmul_rn(erf_inv(u), __uint_as_float(0x3FB504F3u));  // float32(sqrt 2)
}

// Element i of normal(key, (size,)) in float32.
__device__ __forceinline__ float normal_f32(uint32_t k0, uint32_t k1, int64_t i,
                                            int64_t size) {
  return normal_f32_bits(bits32(k0, k1, i, size));
}

// ---------------------------------------------------------------------------
// float64: 64-bit draws, mantissa bitcast, XLA's ErfInv64
// ---------------------------------------------------------------------------

__device__ __constant__ double kErfInv64Lt625[23] = {
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027};
__device__ __constant__ double kErfInv64Lt16[19] = {
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208};
__device__ __constant__ double kErfInv64Ge16[17] = {
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844};

__device__ __forceinline__ double erf_inv(double x) {
  const double w = -log1p(__dmul_rn(x, -x));
  const bool lt625 = w < 6.25;
  const bool lt16 = w < 16.0;
  const double ww = lt625 ? __dadd_rn(w, -3.125)
                          : __dsub_rn(sqrt(w), lt16 ? 3.25 : 5.0);
  const double* tab = lt625 ? kErfInv64Lt625 : (lt16 ? kErfInv64Lt16 : kErfInv64Ge16);
  double p = tab[0];
#pragma unroll
  for (int i = 1; i < 17; ++i) p = __dadd_rn(tab[i], __dmul_rn(p, ww));
  if (lt16) {
    p = __dadd_rn(tab[17], __dmul_rn(p, ww));
    p = __dadd_rn(tab[18], __dmul_rn(p, ww));
  }
  if (lt625) {
#pragma unroll
    for (int i = 19; i < 23; ++i) p = __dadd_rn(__dmul_rn(p, ww), tab[i]);
  }
  return fabs(x) == 1.0 ? __dmul_rn(x, __longlong_as_double(0x7ff0000000000000LL))
                        : __dmul_rn(p, x);
}

// Element i of normal(key, (size,)) in float64.
__device__ __forceinline__ double normal_f64(uint32_t k0, uint32_t k1, int64_t i,
                                             int64_t size) {
  uint32_t hi = static_cast<uint32_t>(i);
  uint32_t lo = static_cast<uint32_t>(i + size);
  threefry2x32(k0, k1, hi, lo);
  // (hi << 32 | lo) >> 12, under the exponent of 1.0
  const uint64_t m = (static_cast<uint64_t>(hi) << 20) | (lo >> 12) |
                     0x3FF0000000000000ull;
  const double f = __dsub_rn(__longlong_as_double(static_cast<long long>(m)), 1.0);
  // uniform on [nextafter(-1, 0), 1): scale (1 - lo) rounds to 2 in float64
  const double lo_v = __longlong_as_double(0xBFEFFFFFFFFFFFFFLL);  // nextafter(-1, 0)
  const double u = fmax(lo_v, __dadd_rn(__dmul_rn(f, 2.0), lo_v));
  return __dmul_rn(erf_inv(u), __longlong_as_double(0x3FF6A09E667F3BCDLL));  // sqrt 2
}

__device__ __forceinline__ float normal_elem(float, uint32_t k0, uint32_t k1,
                                             int64_t i, int64_t size) {
  return normal_f32(k0, k1, i, size);
}

__device__ __forceinline__ double normal_elem(double, uint32_t k0, uint32_t k1,
                                              int64_t i, int64_t size) {
  return normal_f64(k0, k1, i, size);
}

}  // namespace repro_torch
