// Reversible-Heun state updates, their hand-derived backward phases, and
// in-kernel Brownian draws for Hopper.
//
// Replaces six Pallas kernels of the JAX package:
//   rev_heun_phase1      src/repro/kernels/reversible_heun_step.py:152 (body :66)
//   rev_heun_phase2      src/repro/kernels/reversible_heun_step.py:161 (body :76)
//   rev_heun_bwd_phase1  src/repro/kernels/reversible_heun_step.py:170 (body :86)
//   rev_heun_bwd_phase2  src/repro/kernels/reversible_heun_step.py:180 (body :94)
//   brownian_increment   src/repro/kernels/brownian.py:71
//   rev_heun_phase1_gen  src/repro/kernels/brownian.py:132
//   brownian_value       src/repro/kernels/brownian.py:101
// The plain versions are src/repro_torch/kernels/ref.py; each kernel here
// computes the same function with the same op order, bitwise.  The backward
// pair's grouping (c_mu1 = g_mu1 + 0.5*(g_z1*dt), d_mu = 0.5*(g_z1*dt) +
// ghat*dt, ...) is the transpose's own, which is what makes the fused exact
// adjoint bitwise equal to autograd through the unfused step.
//
// Design.  All six are elementwise over a (rows, d) state, one thread per
// element in a grid-stride loop.  The TPU kernels held the whole state in
// VMEM as one block; here no element needs another, so there is nothing to
// stage in shared memory.  The draws are per row: row b's key is keys[b]
// (the JAX package got per-row keys from jax.vmap), folded with the step
// counter n inside the kernel, so the Brownian increment never goes through
// device memory between generation and use in rev_heun_phase1_gen.  Step
// size and sign are runtime scalars, so one compiled kernel serves every
// step size and both directions (forward +1, reconstruction -1).
//
// Bound.  The non-drawing kernels move 6 (phase 1, bwd phase 1) or 7
// (phase 2, bwd phase 2) state-sized tensors and do a handful of flops per
// element: HBM-bound, bytes / 3.35 TB/s.  At the training shapes (B <= 1024
// rows, d = 17) that is at most ~0.15 us, far under the ~2.5 us launch
// floor, so each launch costs its launch; only fusing phases (fewer
// launches) would move the time.  The ~0.5 KFLOP-equivalent of integer
// hashing per drawn element is far under the compute peak.  Each thread
// recomputes its row's fold_in and, in float32, the counter pair it shares
// with one other element: redundant integer work that costs no memory
// traffic.
//
// brownian_value (the adaptive loop's point query W(t) - W(t0)) is
// bound by operations, not bytes: each element pays `depth` levels of two
// key-chain hashes plus one midpoint normal (~3 Threefry hashes and an
// erf_inv per level), and writes one value.  Its design is in the comment
// above brownian_value_kernel.
//
// Interface: plain C functions (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = float64.  Each launches on the given stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace repro_torch {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sqrt_ieee(float a) { return sqrtf(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double sqrt_ieee(double a) { return sqrt(a); }
__device__ __forceinline__ float divide(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double divide(double a, double b) { return __ddiv_rn(a, b); }
// the smallest normal number, finfo(dtype).tiny
__device__ __forceinline__ float tiny(float) { return __int_as_float(0x00800000); }
__device__ __forceinline__ double tiny(double) {
  return __longlong_as_double(0x0010000000000000LL);
}

// ΔW of element (b, i): normal(fold_in(keys[b], n), (d,))[i] · sqrt(dt_grid)
template <typename T>
__device__ __forceinline__ T increment(const int64_t* __restrict__ keys, int64_t n,
                                       T sqrt_dt, int64_t b, int64_t i, int64_t d) {
  uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
  uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
  fold_in(k0, k1, n);
  return mul(normal_elem(T(), k0, k1, i, d), sqrt_dt);
}

template <typename T>
__global__ void brownian_increment_kernel(const int64_t* __restrict__ keys, int64_t n,
                                          T dt, T* __restrict__ out, int64_t rows,
                                          int64_t d) {
  const T sqrt_dt = sqrt_ieee(dt);
  const int64_t total = rows * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = e / d;
    out[e] = increment(keys, n, sqrt_dt, b, e - b * d, d);
  }
}

// ẑ₁ = 2z − ẑ + μ·(sign·Δt) + (sign·σ)·ΔW, with ΔW drawn here
template <typename T>
__global__ void phase1_gen_kernel(const T* __restrict__ z, const T* __restrict__ zh,
                                  const T* __restrict__ mu, const T* __restrict__ sigma,
                                  const int64_t* __restrict__ keys, int64_t n,
                                  T dt_grid, T dt, T sign, T* __restrict__ zh1,
                                  T* __restrict__ dw, int64_t rows, int64_t d) {
  const T sqrt_dt = sqrt_ieee(dt_grid);
  const T sdt = mul(sign, dt);
  const int64_t total = rows * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = e / d;
    const T w = increment(keys, n, sqrt_dt, b, e - b * d, d);
    const T a = sub(mul(T(2), z[e]), zh[e]);
    zh1[e] = add(add(a, mul(mu[e], sdt)), mul(mul(sign, sigma[e]), w));
    dw[e] = w;
  }
}

// ẑ₁ = 2z − ẑ + μ·(sign·Δt) + (sign·σ)·ΔW, with ΔW given.
// Replaces _phase1_kernel (src/repro/kernels/reversible_heun_step.py:66).
// Bound: 6 state-sized tensors through HBM (5 read, 1 written).
template <typename T>
__global__ void phase1_kernel(const T* __restrict__ z, const T* __restrict__ zh,
                              const T* __restrict__ mu, const T* __restrict__ sigma,
                              const T* __restrict__ dw, T dt, T sign,
                              T* __restrict__ zh1, int64_t total) {
  const T sdt = mul(sign, dt);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T a = sub(mul(T(2), z[e]), zh[e]);
    zh1[e] = add(add(a, mul(mu[e], sdt)), mul(mul(sign, sigma[e]), dw[e]));
  }
}

// z₁ = z + (sign·½Δt)(μ+μ′) + (sign·½)(σ+σ′)ΔW
template <typename T>
__global__ void phase2_kernel(const T* __restrict__ z, const T* __restrict__ mu,
                              const T* __restrict__ mu1, const T* __restrict__ sigma,
                              const T* __restrict__ sigma1, const T* __restrict__ dw,
                              T dt, T sign, T* __restrict__ out, int64_t total) {
  const T half_sign = mul(sign, T(0.5));
  const T hdt = mul(half_sign, dt);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T drift = mul(hdt, add(mu[e], mu1[e]));
    const T noise = mul(mul(half_sign, add(sigma[e], sigma1[e])), dw[e]);
    out[e] = add(add(z[e], drift), noise);
  }
}

// Field-VJP seeds: c_mu1 = ḡ_mu1 + ½(ḡ_z1·Δt), c_sig1 = ḡ_sig1 + ½(ḡ_z1·ΔW).
// Replaces _bwd_phase1_kernel (src/repro/kernels/reversible_heun_step.py:86).
// Bound: 6 state-sized tensors through HBM (4 read, 2 written).
template <typename T>
__global__ void bwd_phase1_kernel(const T* __restrict__ g_z1, const T* __restrict__ g_mu1,
                                  const T* __restrict__ g_sig1, const T* __restrict__ dw,
                                  T dt, T* __restrict__ c_mu1, T* __restrict__ c_sig1,
                                  int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T g = g_z1[e];
    c_mu1[e] = add(g_mu1[e], mul(T(0.5), mul(g, dt)));
    c_sig1[e] = add(g_sig1[e], mul(T(0.5), mul(g, dw[e])));
  }
}

// Step-n cotangents from ĝ (the total ẑ₁ cotangent):
// d_z = ḡ_z1 + 2ĝ, d_zh = −ĝ, d_μ = ½(ḡ_z1·Δt) + ĝΔt, d_σ = ½(ḡ_z1·ΔW) + ĝΔW.
// Replaces _bwd_phase2_kernel (src/repro/kernels/reversible_heun_step.py:94).
// Bound: 7 state-sized tensors through HBM (3 read, 4 written).
template <typename T>
__global__ void bwd_phase2_kernel(const T* __restrict__ g_z1, const T* __restrict__ ghat,
                                  const T* __restrict__ dw, T dt, T* __restrict__ d_z,
                                  T* __restrict__ d_zh, T* __restrict__ d_mu,
                                  T* __restrict__ d_sigma, int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T g = g_z1[e];
    const T h = ghat[e];
    const T w = dw[e];
    d_z[e] = add(g, mul(T(2), h));
    d_zh[e] = -h;
    d_mu[e] = add(mul(T(0.5), mul(g, dt)), mul(h, dt));
    d_sigma[e] = add(mul(T(0.5), mul(g, w)), mul(h, w));
  }
}

// W(t_b) - W(t0) of row b by Lévy-bridge descent to `depth` levels, one
// thread per element (b, i) of the (rows, d) output.
// Replaces _value_kernel / brownian_value (src/repro/kernels/brownian.py:101,
// pallas_call :106), whose plain version is repro.kernels.ref.brownian_value
// (here src/repro_torch/kernels/ref.py:brownian_value, bitwise).
//
// The Pallas kernel walked the row's intervals and keys once as scalars,
// drew all `depth` midpoints in one batched call, then combined: a layout
// for the TPU's one core and its large VMEM.  Here each thread repeats its
// row's scalar walk (interval (a, b), bridge std, go-left bit, the key
// chain) and draws only its own element's midpoint normal at each level,
// combining as it goes: no per-level arrays, no shared memory, no
// communication between threads.  The walk is redundant across a row's d
// threads, which is integer work on registers; the kernel is bound by
// those operations (see the file comment), and making it fast (sharing
// the walk through a warp) is later work.  Each row has its own time t[b]
// read from device memory, so the adaptive loop never copies a time to
// the host.  The counter layout of the draws is that of normal(key, (d,)):
// it depends on the per-row size d, not on rows*d.
template <typename T>
__global__ void brownian_value_kernel(const int64_t* __restrict__ keys,
                                      const T* __restrict__ t, T t0, T t1,
                                      T sqrt_span, int depth, T* __restrict__ out,
                                      int64_t rows, int64_t d) {
  const int64_t total = rows * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = e / d;
    const int64_t i = e - b * d;
    uint32_t c0 = static_cast<uint32_t>(keys[2 * b]);
    uint32_t c1 = static_cast<uint32_t>(keys[2 * b + 1]);
    fold_in(c0, c1, 0xB0B);
    const T tb = t[b];
    T wa = T(0);
    T wb = mul(normal_elem(T(), c0, c1, i, d), sqrt_span);
    T lo = t0;
    T hi = t1;
    for (int level = 0; level < depth; ++level) {
      const T m = mul(T(0.5), add(lo, hi));
      const T std_ = sqrt_ieee(divide(mul(sub(hi, m), sub(m, lo)), sub(hi, lo)));
      const bool go_left = tb <= m;
      uint32_t f0 = c0, f1 = c1;
      fold_in(f0, f1, 1);
      fold_in(c0, c1, go_left ? 2 : 3);
      const T wm = add(mul(T(0.5), add(wa, wb)), mul(std_, normal_elem(T(), f0, f1, i, d)));
      if (go_left) {
        wb = wm;
        hi = m;
      } else {
        wa = wm;
        lo = m;
      }
    }
    const T span = sub(hi, lo);
    T frac = divide(sub(tb, lo), span > tiny(T()) ? span : tiny(T()));
    frac = frac < T(0) ? T(0) : (frac > T(1) ? T(1) : frac);
    out[e] = add(wa, mul(frac, sub(wb, wa)));
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t total) {
  const int64_t cap = 132 * 16;  // enough resident blocks to fill 132 SMs
  int64_t b = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace repro_torch

using repro_torch::blocks_for;
using repro_torch::kThreads;

extern "C" int rt_brownian_increment(int dtype, const int64_t* keys, int64_t n,
                                     double dt, void* out, int64_t rows, int64_t d,
                                     void* stream) {
  const int64_t total = rows * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::brownian_increment_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          keys, n, static_cast<float>(dt), static_cast<float*>(out), rows, d);
    } else {
      repro_torch::brownian_increment_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          keys, n, dt, static_cast<double*>(out), rows, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_rev_heun_phase1_gen(int dtype, const void* z, const void* zh,
                                      const void* mu, const void* sigma,
                                      const int64_t* keys, int64_t n, double dt_grid,
                                      double dt, double sign, void* zh1, void* dw,
                                      int64_t rows, int64_t d, void* stream) {
  const int64_t total = rows * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::phase1_gen_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(z), static_cast<const float*>(zh),
          static_cast<const float*>(mu), static_cast<const float*>(sigma), keys, n,
          static_cast<float>(dt_grid), static_cast<float>(dt), static_cast<float>(sign),
          static_cast<float*>(zh1), static_cast<float*>(dw), rows, d);
    } else {
      repro_torch::phase1_gen_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const double*>(z), static_cast<const double*>(zh),
          static_cast<const double*>(mu), static_cast<const double*>(sigma), keys, n,
          dt_grid, dt, sign, static_cast<double*>(zh1), static_cast<double*>(dw), rows, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_rev_heun_phase2(int dtype, const void* z, const void* mu,
                                  const void* mu1, const void* sigma, const void* sigma1,
                                  const void* dw, double dt, double sign, void* out,
                                  int64_t total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::phase2_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(z), static_cast<const float*>(mu),
          static_cast<const float*>(mu1), static_cast<const float*>(sigma),
          static_cast<const float*>(sigma1), static_cast<const float*>(dw),
          static_cast<float>(dt), static_cast<float>(sign), static_cast<float*>(out), total);
    } else {
      repro_torch::phase2_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const double*>(z), static_cast<const double*>(mu),
          static_cast<const double*>(mu1), static_cast<const double*>(sigma),
          static_cast<const double*>(sigma1), static_cast<const double*>(dw), dt, sign,
          static_cast<double*>(out), total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_rev_heun_phase1(int dtype, const void* z, const void* zh, const void* mu,
                                  const void* sigma, const void* dw, double dt, double sign,
                                  void* zh1, int64_t total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::phase1_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(z), static_cast<const float*>(zh),
          static_cast<const float*>(mu), static_cast<const float*>(sigma),
          static_cast<const float*>(dw), static_cast<float>(dt), static_cast<float>(sign),
          static_cast<float*>(zh1), total);
    } else {
      repro_torch::phase1_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const double*>(z), static_cast<const double*>(zh),
          static_cast<const double*>(mu), static_cast<const double*>(sigma),
          static_cast<const double*>(dw), dt, sign, static_cast<double*>(zh1), total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_rev_heun_bwd_phase1(int dtype, const void* g_z1, const void* g_mu1,
                                      const void* g_sig1, const void* dw, double dt,
                                      void* c_mu1, void* c_sig1, int64_t total,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::bwd_phase1_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(g_z1), static_cast<const float*>(g_mu1),
          static_cast<const float*>(g_sig1), static_cast<const float*>(dw),
          static_cast<float>(dt), static_cast<float*>(c_mu1), static_cast<float*>(c_sig1),
          total);
    } else {
      repro_torch::bwd_phase1_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const double*>(g_z1), static_cast<const double*>(g_mu1),
          static_cast<const double*>(g_sig1), static_cast<const double*>(dw), dt,
          static_cast<double*>(c_mu1), static_cast<double*>(c_sig1), total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_rev_heun_bwd_phase2(int dtype, const void* g_z1, const void* ghat,
                                      const void* dw, double dt, void* d_z, void* d_zh,
                                      void* d_mu, void* d_sigma, int64_t total,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0) {
      repro_torch::bwd_phase2_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(g_z1), static_cast<const float*>(ghat),
          static_cast<const float*>(dw), static_cast<float>(dt), static_cast<float*>(d_z),
          static_cast<float*>(d_zh), static_cast<float*>(d_mu), static_cast<float*>(d_sigma),
          total);
    } else {
      repro_torch::bwd_phase2_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          static_cast<const double*>(g_z1), static_cast<const double*>(ghat),
          static_cast<const double*>(dw), dt, static_cast<double*>(d_z),
          static_cast<double*>(d_zh), static_cast<double*>(d_mu),
          static_cast<double*>(d_sigma), total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_brownian_value(int dtype, const int64_t* keys, const void* t,
                                 double t0, double t1, int depth, void* out,
                                 int64_t rows, int64_t d, void* stream) {
  const int64_t total = rows * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    // the span and its sqrt in the state dtype, as the plain version rounds them
    if (dtype == 0) {
      const float sqrt_span = sqrtf(static_cast<float>(t1 - t0));
      repro_torch::brownian_value_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          keys, static_cast<const float*>(t), static_cast<float>(t0),
          static_cast<float>(t1), sqrt_span, depth, static_cast<float*>(out), rows, d);
    } else {
      repro_torch::brownian_value_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          keys, static_cast<const double*>(t), t0, t1, sqrt(t1 - t0), depth,
          static_cast<double*>(out), rows, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
