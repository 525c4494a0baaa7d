// Reversible-Heun state updates, their hand-derived backward phases, and
// in-kernel Brownian draws for Hopper.
//
// Replaces seven Pallas kernels of the JAX package:
//   rev_heun_phase1      src/repro/kernels/reversible_heun_step.py:152 (body :66)
//   rev_heun_phase2      src/repro/kernels/reversible_heun_step.py:161 (body :76)
//   rev_heun_bwd_phase1  src/repro/kernels/reversible_heun_step.py:170 (body :86)
//   rev_heun_bwd_phase2  src/repro/kernels/reversible_heun_step.py:180 (body :94)
//   brownian_increment   src/repro/kernels/brownian.py:71
//   rev_heun_phase1_gen  src/repro/kernels/brownian.py:132
//   brownian_value       src/repro/kernels/brownian.py:101
// and holds two kernels of the port's own, the srk solver's (W, H) draws,
// which the reference writes as jax.random ops with no Pallas kernel:
//   space_time_increment src/repro/core/brownian.py:175-177, 548-562
//   space_time_value     src/repro/core/brownian.py:238-314 (BrownianPath._wh)
// brownian_increment, rev_heun_phase1_gen and space_time_increment also have
// row-windowed variants (a data-parallel rank's elements of a one-key draw;
// below space_time_increment_kernel).
// The plain versions are src/repro_torch/kernels/ref.py; each kernel here
// computes the same function with the same op order, bitwise.  The backward
// pair's grouping (c_mu1 = g_mu1 + 0.5*(g_z1*dt), d_mu = 0.5*(g_z1*dt) +
// ghat*dt, ...) is the transpose's own, which is what makes the fused exact
// adjoint bitwise equal to autograd through the unfused step.
//
// Design.  All six are elementwise over a (rows, d) state.  The TPU kernels
// held the whole state in VMEM as one block; here no element needs another,
// so there is nothing to stage in shared memory.  The draws are per row: row
// b's key is keys[b] (the JAX package got per-row keys from jax.vmap),
// folded with the step counter n inside the kernel, so the Brownian
// increment never goes through device memory between generation and use in
// rev_heun_phase1_gen.  Step size and sign are runtime scalars, so one
// compiled kernel serves every step size and both directions (forward +1,
// reconstruction -1).
//
// Bound.  The non-drawing kernels move 6 (phase 1, bwd phase 1) or 7
// (phase 2, bwd phase 2) state-sized tensors and do a handful of flops per
// element: HBM-bound, bytes / 3.35 TB/s.  At the training shapes (B <= 1024
// rows, d = 17) that is at most ~0.15 us, far under the ~1.7 us launch
// floor, so each launch costs its launch and its blocks' start and tail.
// The ~0.5 KFLOP-equivalent of integer hashing per drawn element is far
// under the compute peak; what a draw costs is one thread's dependent
// chain: key load -> fold_in (20 rounds) -> the pair's hash -> erf_inv ->
// store.
//
// All six elementwise and drawing kernels and the space-time increment
// (space_time_increment_kernel) are laid out for that: launch and chain, not
// bytes or operations.
//   * All seven launch through launch_dependent (a programmatic dependent
//     launch, sm_90): the kernel is scheduled while its predecessor's blocks
//     drain, runs its index arithmetic and scalar setup, and then waits in
//     griddepcontrol.wait until the predecessor's memory is visible.  Every
//     global read and write comes after the wait, the keys included (the
//     serving Scheduler folds the rows' keys on the card just before its
//     draws), and each block issues griddepcontrol.launch_dependents as it
//     starts, so a successor launched the same way can start in turn.  A
//     wait without a programmatic predecessor returns at once.
//   * The three drawing kernels run one thread per draw unit (draw_pair): in
//     float32 one counter pair, whose one hash gives elements j and j + half
//     of the row (normal(key, (d,)) pairs them so), in float64 one element
//     (a float64 draw uses a whole pair).  The unit index is split into
//     (row, unit) by one 32-bit division (unit_coords); only where
//     rows·d >= 2^31 does a 64-bit path run.  At B 1024 (one key over 17,408
//     float32 elements) that is 8,704 threads in 34 blocks, each one fold_in
//     and one pair hash (the space-time increment: one fold_in, one split
//     and a pair hash for each of W and H).  The key load and fold_in stay
//     per thread: they sit on the dependent chain either way, and a
//     shared-memory broadcast would add a barrier to it.
//     rev_heun_phase1_gen issues its state loads before the hash, so their
//     latency hides under the chain.
//   * rev_heun_phase2 and rev_heun_bwd_phase1 are one pass with no loop: a
//     thread takes 16 bytes of each operand (float4 / double2) when every
//     pointer is 16-byte aligned, the last thread the scalar tail; otherwise
//     (a contiguous view off a 16-byte boundary: a slice of g_out, a 1 x 17
//     state) a thread an element.  At B 1024 in float32: 4,352 threads in 17
//     blocks.
//   * rev_heun_phase1 and rev_heun_bwd_phase2 are one pass of one element a
//     thread on every operand layout (17,408 threads in 68 blocks at B 1024
//     in float32): with the packs of the two above they spanned 0.10-0.21 us
//     more on an idle card and ran slower back to back, so they have no pack
//     path.
//   Each computes through one element helper (phase1_elem, phase2_elem,
//   bwd_phase1_elem, bwd_phase2_elem), so a formula is written once in the
//   file.
// Every element keeps the plain version's op order, so each gives its bits.
//
// brownian_value (the adaptive loop's point query W(t) - W(t0)) is
// bound by latency: each row's key chain is depth + 1 dependent Threefry
// hashes, while its draws and combine spread over the block.  Its design
// and what bounds it are in the comment above brownian_value_kernel; the
// space-time kernels' are above space_time_increment_kernel and
// space_time_value_kernel.
//
// Interface: plain C functions (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = float64.  Each launches on the given stream and
// returns cudaGetLastError().

#include <cstdint>
#include <vector>

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

// The programmatic dependent launch's two halves (sm_90).  The memory
// clobber keeps every load and store of the kernel after the wait.
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

constexpr int kThreads = 256;

// Draw unit u of a (rows, units) grid -> (row, unit in the row): one
// division in the index type I (uint32_t, or uint64_t where rows·d >= 2^31).
template <typename I>
__host__ __device__ __forceinline__ void unit_coords(I u, I units, I& row, I& j) {
  row = u / units;
  j = u - row * units;
}

// The float32 counter pair of draw unit j of a draw of `size` elements,
// `units` = ceil(size / 2): (j, j + units), whose one hash gives elements j
// (lane 0) and j + units (lane 1); for odd size the last pair's second
// counter is 0 (the pad).  The one statement of the layout (draw_pair,
// draw_element; the plain version's is kernels/prng.py).
template <typename I>
__device__ __forceinline__ void pair_counters(I j, I units, I size, uint32_t& x0,
                                              uint32_t& x1) {
  const I second = j + units;
  x0 = static_cast<uint32_t>(j);
  x1 = second < size ? static_cast<uint32_t>(second) : 0u;
}

// Draw unit j of normal(key, (d,))·scale, `units` a row: in float32 the
// counter pair (j, j + units), whose one hash gives elements j (w0) and
// j + units (w1; for odd d the last pair's second counter is 0 and w1 the
// pad's draw); in float64 element j (w0; w1 is 0).  Both float32 normals
// are drawn unconditionally, the pad's too: two independent chains in
// straight-line code interleave, where a branch between them would run them
// one after the other (0.05 us of a launch's span on an H100).
template <typename T, typename I>
__device__ __forceinline__ void draw_pair(uint32_t k0, uint32_t k1, I j, I units, I d, T scale,
                                          T& w0, T& w1) {
  if constexpr (sizeof(T) == 4) {
    uint32_t x0, x1;
    pair_counters(j, units, d, x0, x1);
    threefry2x32(k0, k1, x0, x1);
    w0 = mul(normal_f32_bits(x0), scale);
    w1 = mul(normal_f32_bits(x1), scale);
  } else {
    w0 = mul(normal_f64(k0, k1, static_cast<int64_t>(j), static_cast<int64_t>(d)), scale);
    w1 = T(0);
  }
}

// Whether draw unit j's second draw is an element of the row (float32, j +
// units < d).
template <typename T, typename I>
__device__ __forceinline__ bool unit_has_pair(I j, I units, I d) {
  return sizeof(T) == 4 && j + units < d;
}

// The step-n increments normal(fold_in(keys[b], n), (d,))·sqrt(dt) of draw
// unit j of row b (draw_pair).  Returns whether w1 is an element of the row.
template <typename T, typename I>
__device__ __forceinline__ bool draw_unit(const int64_t* __restrict__ keys, int64_t n, I b,
                                          I j, I units, I d, T sqrt_dt, T& w0, T& w1) {
  uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
  uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
  fold_in(k0, k1, n);
  draw_pair(k0, k1, j, units, d, sqrt_dt, w0, w1);
  return unit_has_pair<T>(j, units, d);
}

// Row b's step-n increment normal(fold_in(keys[b], n), (d,))·sqrt(dt), one
// thread a draw unit (a counter pair in float32, an element in float64;
// `units` a row).  Replaces src/repro/kernels/brownian.py:71.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
brownian_increment_kernel(const int64_t* __restrict__ keys, int64_t n, T dt,
                          T* __restrict__ out, I total, I units, I d) {
  const T sqrt_dt = sqrt_ieee(dt);
  const I u = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  I b = 0, j = 0;
  unit_coords(u, units, b, j);
  release_dependents();
  wait_for_predecessor();
  if (u >= total) return;
  T* row = out + static_cast<size_t>(b) * d;
  T w0, w1;
  const bool two = draw_unit(keys, n, b, j, units, d, sqrt_dt, w0, w1);
  row[j] = w0;
  if (two) row[j + units] = w1;
}

// ẑ₁ = 2z − ẑ + μ·(sign·Δt) + (sign·σ)·ΔW of one element, ΔW = w.
template <typename T>
__device__ __forceinline__ T phase1_elem(T z, T zh, T mu, T sigma, T w, T sdt, T sign) {
  const T a = sub(mul(T(2), z), zh);
  return add(add(a, mul(mu, sdt)), mul(mul(sign, sigma), w));
}

// ẑ₁ = 2z − ẑ + μ·(sign·Δt) + (sign·σ)·ΔW, with ΔW drawn here: one thread a
// draw unit, as brownian_increment_kernel (draw_unit), which updates the
// unit's one or two elements.  The state loads come before the hash, off
// its dependent chain.  Replaces src/repro/kernels/brownian.py:132.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
phase1_gen_kernel(const T* __restrict__ z, const T* __restrict__ zh,
                  const T* __restrict__ mu, const T* __restrict__ sigma,
                  const int64_t* __restrict__ keys, int64_t n, T dt_grid, T dt, T sign,
                  T* __restrict__ zh1, T* __restrict__ dw, I total, I units, I d) {
  const T sqrt_dt = sqrt_ieee(dt_grid);
  const T sdt = mul(sign, dt);
  const I u = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  I b = 0, j = 0;
  unit_coords(u, units, b, j);
  const size_t e0 = static_cast<size_t>(b) * d + j;
  const size_t e1 = e0 + units;
  const bool pair = unit_has_pair<T>(j, units, d);
  release_dependents();
  wait_for_predecessor();
  if (u >= total) return;
  const T z0 = z[e0], zh0 = zh[e0], mu0 = mu[e0], s0 = sigma[e0];
  T z1 = T(0), zh_1 = T(0), mu1 = T(0), s1 = T(0);
  if (pair) {
    z1 = z[e1];
    zh_1 = zh[e1];
    mu1 = mu[e1];
    s1 = sigma[e1];
  }
  T w0, w1;
  const bool two = draw_unit(keys, n, b, j, units, d, sqrt_dt, w0, w1);
  zh1[e0] = phase1_elem(z0, zh0, mu0, s0, w0, sdt, sign);
  dw[e0] = w0;
  if (two) {
    zh1[e1] = phase1_elem(z1, zh_1, mu1, s1, w1, sdt, sign);
    dw[e1] = w1;
  }
}

// ẑ₁ = 2z − ẑ + μ·(sign·Δt) + (sign·σ)·ΔW, with ΔW given.
// Replaces _phase1_kernel (src/repro/kernels/reversible_heun_step.py:66).
// Bound: 6 state-sized tensors through HBM (5 read, 1 written).  Thread t
// takes element t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
phase1_kernel(const T* __restrict__ z, const T* __restrict__ zh, const T* __restrict__ mu,
              const T* __restrict__ sigma, const T* __restrict__ dw, T dt, T sign,
              T* __restrict__ zh1, int64_t total) {
  const T sdt = mul(sign, dt);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  release_dependents();
  wait_for_predecessor();
  if (e < total) zh1[e] = phase1_elem(z[e], zh[e], mu[e], sigma[e], dw[e], sdt, sign);
}

// z₁ = z + (sign·½Δt)(μ+μ′) + (sign·½)(σ+σ′)ΔW, element e.
template <typename T>
__device__ __forceinline__ T phase2_elem(T z, T mu, T mu1, T sigma, T sigma1, T dw,
                                         T hdt, T half_sign) {
  const T drift = mul(hdt, add(mu, mu1));
  const T noise = mul(mul(half_sign, add(sigma, sigma1)), dw);
  return add(add(z, drift), noise);
}

// 16 bytes of one operand: four float32 or two float64 elements.
template <typename T>
struct alignas(16) Pack16 {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// Replaces _phase2_kernel (src/repro/kernels/reversible_heun_step.py:76).
// kVector: thread t takes elements [t·N, t·N + N) as one 16-byte load of
// each operand and one store (all pointers 16-byte aligned), the thread past
// the last whole pack the scalar tail; otherwise thread t takes element t.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
rev_heun_phase2_kernel(const T* __restrict__ z, const T* __restrict__ mu,
                       const T* __restrict__ mu1, const T* __restrict__ sigma,
                       const T* __restrict__ sigma1, const T* __restrict__ dw, T dt, T sign,
                       T* __restrict__ out, int64_t total) {
  const T half_sign = mul(sign, T(0.5));
  const T hdt = mul(half_sign, dt);
  constexpr int kN = kVector ? Pack16<T>::kN : 1;
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kN;
  release_dependents();
  wait_for_predecessor();
  if constexpr (kVector) {
    if (e0 + kN <= total) {
      using P = Pack16<T>;
      const P a = *reinterpret_cast<const P*>(z + e0);
      const P m = *reinterpret_cast<const P*>(mu + e0);
      const P m1 = *reinterpret_cast<const P*>(mu1 + e0);
      const P s = *reinterpret_cast<const P*>(sigma + e0);
      const P s1 = *reinterpret_cast<const P*>(sigma1 + e0);
      const P w = *reinterpret_cast<const P*>(dw + e0);
      P o;
  #pragma unroll
      for (int i = 0; i < kN; ++i) {
        o.v[i] = phase2_elem(a.v[i], m.v[i], m1.v[i], s.v[i], s1.v[i], w.v[i], hdt, half_sign);
      }
      *reinterpret_cast<P*>(out + e0) = o;
      return;
    }
  }
  for (int64_t e = e0; e < total && e < e0 + kN; ++e) {
    out[e] = phase2_elem(z[e], mu[e], mu1[e], sigma[e], sigma1[e], dw[e], hdt, half_sign);
  }
}

// Field-VJP seeds of one element: c_mu1 = ḡ_mu1 + ½(ḡ_z1·Δt),
// c_sig1 = ḡ_sig1 + ½(ḡ_z1·ΔW).
template <typename T>
__device__ __forceinline__ void bwd_phase1_elem(T g, T g_mu1, T g_sig1, T w, T dt, T& c_mu1,
                                                T& c_sig1) {
  c_mu1 = add(g_mu1, mul(T(0.5), mul(g, dt)));
  c_sig1 = add(g_sig1, mul(T(0.5), mul(g, w)));
}

// Replaces _bwd_phase1_kernel (src/repro/kernels/reversible_heun_step.py:86).
// Bound: 6 state-sized tensors through HBM (4 read, 2 written).  kVector:
// thread t takes elements [t·N, t·N + N) as one 16-byte load of each operand
// and one store of each output (all six pointers 16-byte aligned), the
// thread past the last whole pack the scalar tail; otherwise thread t takes
// element t.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
bwd_phase1_kernel(const T* __restrict__ g_z1, const T* __restrict__ g_mu1,
                  const T* __restrict__ g_sig1, const T* __restrict__ dw, T dt,
                  T* __restrict__ c_mu1, T* __restrict__ c_sig1, int64_t total) {
  constexpr int kN = kVector ? Pack16<T>::kN : 1;
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kN;
  release_dependents();
  wait_for_predecessor();
  if constexpr (kVector) {
    if (e0 + kN <= total) {
      using P = Pack16<T>;
      const P g = *reinterpret_cast<const P*>(g_z1 + e0);
      const P m = *reinterpret_cast<const P*>(g_mu1 + e0);
      const P s = *reinterpret_cast<const P*>(g_sig1 + e0);
      const P w = *reinterpret_cast<const P*>(dw + e0);
      P cm, cs;
  #pragma unroll
      for (int i = 0; i < kN; ++i) {
        bwd_phase1_elem(g.v[i], m.v[i], s.v[i], w.v[i], dt, cm.v[i], cs.v[i]);
      }
      *reinterpret_cast<P*>(c_mu1 + e0) = cm;
      *reinterpret_cast<P*>(c_sig1 + e0) = cs;
      return;
    }
  }
  for (int64_t e = e0; e < total && e < e0 + kN; ++e) {
    bwd_phase1_elem(g_z1[e], g_mu1[e], g_sig1[e], dw[e], dt, c_mu1[e], c_sig1[e]);
  }
}

// Step-n cotangents of one element from ĝ (the total ẑ₁ cotangent):
// d_z = ḡ_z1 + 2ĝ, d_zh = −ĝ, d_μ = ½(ḡ_z1·Δt) + ĝΔt, d_σ = ½(ḡ_z1·ΔW) + ĝΔW.
template <typename T>
__device__ __forceinline__ void bwd_phase2_elem(T g, T h, T w, T dt, T& d_z, T& d_zh, T& d_mu,
                                                T& d_sigma) {
  d_z = add(g, mul(T(2), h));
  d_zh = -h;
  d_mu = add(mul(T(0.5), mul(g, dt)), mul(h, dt));
  d_sigma = add(mul(T(0.5), mul(g, w)), mul(h, w));
}

// Replaces _bwd_phase2_kernel (src/repro/kernels/reversible_heun_step.py:94).
// Bound: 7 state-sized tensors through HBM (3 read, 4 written).  Thread t
// takes element t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_phase2_kernel(const T* __restrict__ g_z1, const T* __restrict__ ghat,
                  const T* __restrict__ dw, T dt, T* __restrict__ d_z, T* __restrict__ d_zh,
                  T* __restrict__ d_mu, T* __restrict__ d_sigma, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  release_dependents();
  wait_for_predecessor();
  if (e < total) {
    bwd_phase2_elem(g_z1[e], ghat[e], dw[e], dt, d_z[e], d_zh[e], d_mu[e], d_sigma[e]);
  }
}

// W(t_b) - W(t0) of row b by Lévy-bridge descent to `depth` levels.
// Replaces _value_kernel / brownian_value (src/repro/kernels/brownian.py:101,
// pallas_call :106), whose plain version is repro.kernels.ref.brownian_value
// (here src/repro_torch/kernels/ref.py:brownian_value, bitwise).
//
// Structure: the plain version's and the Pallas kernel's, in three stages
// inside one launch.  A block owns up to kValueRows rows and a slice of
// `units` draw units of each (a unit is a counter pair in float32, whose one
// hash gives elements j and j + half, as normal(key, (d,)) pairs them; an
// element in float64).  Per chunk of ValueTile<T>::kLevels levels (24 in
// float32, 12 in float64; shared memory holds one chunk):
//   1. walk (warp 0, one lane per row): the row's interval (lo, hi),
//      go-left bit and key chain c -> fold_in(c, 2|3), and, off the chain,
//      each level's midpoint key fold_in(c, 1), into shared memory; the
//      first chunk starts from the root key fold_in(key, 0xB0B).  This is
//      the only serial part; the bridge std is left to stage 2;
//   2. draw (warps 1-7): (row, level, unit) items, each a normal pair (one
//      hash; an element in float64) from the level's midpoint key, scaled
//      by the level's bridge std (std·z, the plain version's product), or
//      from the root key, scaled by sqrt(t1 - t0), for the root slot, so a
//      row's draws run in parallel across levels and elements (1024 rows x
//      d = 4 at depth 24: 100 draws a row, 50 hashes); the drawers decode
//      their items while warp 0 walks, and the owners of stage 3 take the
//      tail's fraction from the last interval;
//   3. combine (warps 1-7, one thread per element): the plain version's op
//      sequence level by level (wm = 0.5(wa + wb) + std·z, then the go-left
//      branch), carrying (wa, wb) in registers across chunks; the next
//      level's wa + wb is taken as (the kept one) + wm, the same sum, so
//      the select is off the dependent path; after the last chunk the
//      clamped linear tail writes the value.
// Any depth the plain version takes runs, 0 included: deeper walks take
// more chunks.  Each row reads its own time t[b] from device memory, so the
// adaptive loop never copies a time to the host.
//
// Grid (brownian_value_grid): kValueThreads threads a block, at most
// kDrawThreads elements and kValueRows rows, aiming at kTargetBlocks blocks
// (two an SM, so the draws take one round).  With rows >= kTargetBlocks a
// block takes all of a row's units (up to the element cap) and
// ceil(rows / kTargetBlocks) rows (1024 rows: 4 a block, 256 blocks); with
// fewer rows a block takes one row and 1/ceil(kTargetBlocks / rows) of its
// units, each block redoing its row's walk (one key over (256, 32) in
// float32: 16 pairs a block, 256 blocks); small work gets as many blocks as
// it has units.
//
// Bound.  Before: one thread per element, each repeating its row's whole
// walk and drawing its own midpoint level by level, so each level cost two
// dependent hashes plus an erf_inv on every thread's critical path, and
// 1024 x 4 elements filled 16 of 132 SMs.  Now the critical path is the
// walk's depth + 1 dependent fold_in hashes (~45 dependent integer ops
// each), then one round of draws (a hash and the normals) and the combine;
// the throughput bound (all hashes and normals over the card's integer
// rate) is far shorter than that chain, so the chain, not the operations,
// bounds the kernel (chip_smoke.py:value_bound, chain_floor).  Measured on
// the H100 (PERF.md): a chain step is ~165 ns, so at the serving shape the
// chain takes ~4.1 of the kernel's ~8.1 us, the launch about as much as
// the elementwise kernels' whole ~2.4 us, and the rest is the block's
// start, one round of draws and the combine.  Tried and dropped:
// signalling the drawers every 4 levels through named barriers, to run the
// draws and the combine behind the walk, lengthened each walk step by ~35%
// and the kernel by ~15%.  ptxas (-Xptxas -v):
// float32 56 registers, 36,128 bytes of static shared memory, float64 64
// and 33,952; no spills.
template <typename T>
struct ValueTile {
  static constexpr int kLevels = sizeof(T) == 4 ? 24 : 12;  // levels per chunk
  static constexpr bool kPairs = sizeof(T) == 4;  // float32 draws share a hash by twos
};
constexpr int kValueThreads = 256;
constexpr int kDrawThreads = kValueThreads - 32;  // warps 1-7
constexpr int kValueRows = 32;                    // the walker warp's lanes
constexpr int kTargetBlocks = 2 * 132;  // two blocks on each of the H100's SMs

template <typename T>
__global__ void __launch_bounds__(kValueThreads)
brownian_value_kernel(const int64_t* __restrict__ keys, const T* __restrict__ t, T t0, T t1,
                      T sqrt_span, int depth, T* __restrict__ out, int64_t rows, int64_t d,
                      int rows_per_block, int units_per_block) {
  constexpr int kLevels = ValueTile<T>::kLevels, kSlots = kLevels + 1;
  constexpr bool kPairs = ValueTile<T>::kPairs;
  // slot 0 is the root draw (first chunk only), slot s the chunk's level s - 1
  __shared__ uint32_t key0[kValueRows][kSlots], key1[kValueRows][kSlots];
  __shared__ T lo_s[kValueRows][kSlots], hi_s[kValueRows][kSlots];
  __shared__ bool left_s[kValueRows][kSlots];
  __shared__ T t_s[kValueRows];
  __shared__ T term[kDrawThreads * kSlots];  // std·z of each (row, slot, element)

  const int tid = threadIdx.x;
  const bool walker = tid < 32;
  const int64_t units = kPairs ? (d + 1) / 2 : d;  // a row's draw units (half in float32)
  // the grid has < 2^31 blocks, so its decomposition is 32-bit arithmetic
  const int slices = static_cast<int>((units + units_per_block - 1) / units_per_block);
  const int bx = static_cast<int>(blockIdx.x);
  const int64_t r0 = static_cast<int64_t>(bx / slices) * rows_per_block;
  const int64_t u0 = static_cast<int64_t>(bx % slices) * units_per_block;
  const int nr = static_cast<int>(rows - r0 < rows_per_block ? rows - r0 : rows_per_block);
  const int nu = static_cast<int>(units - u0 < units_per_block ? units - u0 : units_per_block);
  // element e of a block row: unit u0 + e % U, half e / U (float32)
  const int row_elems = (kPairs ? 2 : 1) * units_per_block;

  // the walker's state (lane tid < nr walks row r0 + tid)
  uint32_t c0 = 0, c1 = 0;
  T lo = t0, hi = t1, tb = T(0);
  if (tid < nr) {
    c0 = static_cast<uint32_t>(keys[2 * (r0 + tid)]);
    c1 = static_cast<uint32_t>(keys[2 * (r0 + tid) + 1]);
    fold_in(c0, c1, 0xB0B);
    tb = t[r0 + tid];
    t_s[tid] = tb;
  }
  // the drawers' state: draw index dt; as combiner, element (cr, ce)
  const int dt = tid - 32;
  const int cr = dt / row_elems, ce = dt % row_elems;
  const int64_t cu = u0 + ce % units_per_block;
  const int64_t cg = cu + (ce / units_per_block) * units;  // its index in the row
  const bool owner = !walker && cr < nr && ce % units_per_block < nu && cg < d;
  T wa = T(0), wb = T(0), sum = T(0), frac = T(0);

  for (int l0 = 0;; l0 += kLevels) {
    const int nl = depth - l0 < kLevels ? depth - l0 : kLevels;
    const int s0 = l0 == 0 ? 0 : 1;
    const bool last = l0 + nl == depth;
    const int n_slots = nl + 1 - s0;
    const int items = nr * n_slots * nu;
    int ul = 0, sl = 0, rl = 0;  // the first item's (unit, slot, row), decoded during the walk
    if (walker) {
      // 1. walk: the chain, and the midpoint keys beside it
      if (tid < nr) {
        if (l0 == 0) {
          key0[tid][0] = c0;
          key1[tid][0] = c1;
        }
#pragma unroll 4
        for (int s = 1; s <= nl; ++s) {
          const T m = mul(T(0.5), add(lo, hi));
          const bool go_left = tb <= m;
          uint32_t f0 = c0, f1 = c1;
          fold_in(f0, f1, 1);
          key0[tid][s] = f0;
          key1[tid][s] = f1;
          lo_s[tid][s] = lo;
          hi_s[tid][s] = hi;
          left_s[tid][s] = go_left;
          fold_in(c0, c1, go_left ? 2 : 3);
          if (go_left) hi = m; else lo = m;
        }
        if (last) {  // the last interval, for the tail
          lo_s[tid][0] = lo;
          hi_s[tid][0] = hi;
        }
      }
    } else if (dt < items) {
      ul = dt % nu;
      sl = s0 + dt / nu % n_slots;
      rl = dt / nu / n_slots;
    }
    __syncthreads();
    if (owner && last) {  // the tail's fraction of the last interval
      const T lo_r = lo_s[cr][0], span = sub(hi_s[cr][0], lo_r);
      frac = divide(sub(t_s[cr], lo_r), span > tiny(T()) ? span : tiny(T()));
      frac = frac < T(0) ? T(0) : (frac > T(1) ? T(1) : frac);
    }
    // 2. draw every (row, slot, unit) of the chunk, scaled
    for (int it = dt; !walker && it < items; it += kDrawThreads) {
      if (it != dt) {
        ul = it % nu;
        sl = s0 + it / nu % n_slots;
        rl = it / nu / n_slots;
      }
      const uint32_t k0 = key0[rl][sl], k1 = key1[rl][sl];
      T scale = sqrt_span;
      if (sl > 0) {  // the level's bridge std
        const T a = lo_s[rl][sl], b = hi_s[rl][sl];
        const T m = mul(T(0.5), add(a, b));
        scale = sqrt_ieee(divide(mul(sub(b, m), sub(m, a)), sub(b, a)));
      }
      const int64_t u = u0 + ul;
      T* ts = term + (rl * kSlots + sl) * row_elems;
      // the root is normal·sqrt_span, a level std·normal (the plain version's
      // operand orders; a product commutes bitwise)
      if constexpr (kPairs) {
        // counter pair (u, u + half), the odd size's last second counter 0
        uint32_t x0 = static_cast<uint32_t>(u);
        uint32_t x1 = (d & 1) && u == units - 1 ? 0u : static_cast<uint32_t>(u + units);
        threefry2x32(k0, k1, x0, x1);
        ts[ul] = mul(scale, normal_f32_bits(x0));
        if (u + units < d) ts[units_per_block + ul] = mul(scale, normal_f32_bits(x1));
      } else {
        ts[ul] = mul(scale, normal_elem(T(), k0, k1, u, d));
      }
    }
    __syncthreads();
    // 3. combine, the plain version's op order
    if (owner) {
      const T* tr = term + cr * kSlots * row_elems + ce;
      int s = s0;
      if (s == 0) {
        wb = tr[0];
        sum = add(wa, wb);
        s = 1;
      }
#pragma unroll 4
      for (; s <= nl; ++s) {
        const T wm = add(mul(T(0.5), sum), tr[s * row_elems]);
        const bool go_left = left_s[cr][s];
        sum = add(go_left ? wa : wb, wm);  // the next wa + wb
        if (go_left) wb = wm; else wa = wm;
      }
    }
    if (last) break;
    __syncthreads();  // the next chunk's walk and draws overwrite shared memory
  }
  if (owner) out[(r0 + cr) * d + cg] = add(wa, mul(frac, sub(wb, wa)));
}

// ---------------------------------------------------------------------------
// Space-time Lévy area: (W, H) draws of the srk solver.  No TPU kernel: the
// reference draws these with jax.random ops that XLA fuses
// (src/repro/core/brownian.py:175-177, 238-314, 548-562); the plain versions
// are src/repro_torch/kernels/ref.py:space_time_increment and
// space_time_value, bitwise.
// ---------------------------------------------------------------------------

// jax.random.split(key): the two keys of counter pairs (0, 2) and (1, 3),
// (a0, a1) from the pairs' first lanes and (b0, b1) from their second.
__device__ __forceinline__ void split2(uint32_t k0, uint32_t k1, uint32_t& a0, uint32_t& a1,
                                       uint32_t& b0, uint32_t& b1) {
  uint32_t x0 = 0u, x1 = 2u, y0 = 1u, y1 = 3u;
  threefry2x32(k0, k1, x0, x1);
  threefry2x32(k0, k1, y0, y1);
  a0 = x0;
  a1 = y0;
  b0 = x1;
  b1 = y1;
}

// (W, H) of grid step n, draw unit j of row b: kw, kh = split(fold_in(keys[b],
// n)), W = normal(kw)·sqrt(dt), H = normal(kh)·sqrt(dt/12), the scales
// rounded on the host.  One pass with no loop, one thread a draw unit, as
// brownian_increment_kernel: in float32 the counter pair (j, j + units),
// whose one hash gives two elements, in float64 an element; the unit index
// split by unit_coords (32-bit unless rows·d >= 2^31).  A thread loads its
// row's key once and runs fold_in and split2 once (three hashes a unit),
// then the two pair draws (draw_pair), W's and H's, independent chains that
// interleave; in float32 all four normals are drawn, the pad's too, and the
// second lane stored where j + units < d.  A programmatic dependent launch:
// index arithmetic, then release and wait, then every global access.
//
// The first design held it back: one thread an element, each redoing its
// row's key load, fold_in and split (three hashes an element), in float32
// each counter pair hashed twice (once for each of its two elements' lanes,
// bits32), a 64-bit division e / d for the row, and a plain launch of a
// grid-stride loop: 5 hashes an element in float32 where 2.5 do.  What
// bounds this one at the srk ELBO's draws (one key over 64 x 17, float32:
// 544 threads in 3 blocks) is one thread's dependent chain, key load ->
// fold_in -> split -> the pair hash -> erf_inv -> store, against the launch
// floor (~1.7 us).  The work's bound (chip_smoke.py:st_increment_bound: a
// row's 3 hashes, half a hash and a normal an element and draw, over the
// integer rate; bytes at many rows) is 0.0000036 ms there.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
space_time_increment_kernel(const int64_t* __restrict__ keys, int64_t n, T s_w, T s_h,
                            T* __restrict__ w, T* __restrict__ h, I total, I units, I d) {
  const I u = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  I b = 0, j = 0;
  unit_coords(u, units, b, j);
  const size_t e0 = static_cast<size_t>(b) * d + j;
  const bool pair = unit_has_pair<T>(j, units, d);
  release_dependents();
  wait_for_predecessor();
  if (u >= total) return;
  uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
  uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
  fold_in(k0, k1, n);
  uint32_t a0, a1, b0, b1;
  split2(k0, k1, a0, a1, b0, b1);
  T w0, w1, h0, h1;
  draw_pair(a0, a1, j, units, d, s_w, w0, w1);
  draw_pair(b0, b1, j, units, d, s_h, h0, h1);
  w[e0] = w0;
  h[e0] = h0;
  if (pair) {
    w[e0 + units] = w1;
    h[e0 + units] = h1;
  }
}

// ---------------------------------------------------------------------------
// Row-windowed one-key draws (data parallelism).  A one-key path draws
// normal(key, (B, d)) over the whole batch, so under a data-parallel mesh a
// rank's rows [r0, r1) are elements [r0·d, r1·d) of that draw, not a draw
// of shape (r1 − r0, d): in float32 element e is a lane of counter pair
// e (lane 0, e < half) or e − half (lane 1), half = ceil(size / 2), and the
// two lanes of a pair usually belong to different ranks.  These kernels
// draw elements [e0, e0 + count) of a size-`size` draw, one thread an
// element: in float32 the thread hashes its element's pair and transforms
// only its own lane, in float64 its element is its own hash (e, e + size),
// as normal_f64 draws it.  Every element keeps the whole draw's op order,
// so the windows, concatenated, are the whole launch's bits.  A window is
// one key (rows = 1).  Programmatic dependent launches, as the others.
// ---------------------------------------------------------------------------

// Element e (global) of normal(key, (size,))·scale: in float32 the lane of
// its counter pair (pair_counters) that is e.
template <typename T>
__device__ __forceinline__ T draw_element(uint32_t k0, uint32_t k1, int64_t e, int64_t size,
                                          T scale) {
  if constexpr (sizeof(T) == 4) {
    const int64_t units = (size + 1) / 2;
    const bool lane1 = e >= units;
    uint32_t x0, x1;
    pair_counters<int64_t>(lane1 ? e - units : e, units, size, x0, x1);
    threefry2x32(k0, k1, x0, x1);
    return mul(normal_f32_bits(lane1 ? x1 : x0), scale);
  } else {
    return mul(normal_f64(k0, k1, e, size), scale);
  }
}

// Elements [e0, e0 + count) of the step-n increment normal(fold_in(key, n),
// (size,))·sqrt(dt).  The windowed brownian_increment_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
brownian_increment_window_kernel(const int64_t* __restrict__ keys, int64_t n, T dt,
                                 T* __restrict__ out, int64_t e0, int64_t count, int64_t size) {
  const T sqrt_dt = sqrt_ieee(dt);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  release_dependents();
  wait_for_predecessor();
  if (i >= count) return;
  uint32_t k0 = static_cast<uint32_t>(keys[0]);
  uint32_t k1 = static_cast<uint32_t>(keys[1]);
  fold_in(k0, k1, n);
  out[i] = draw_element(k0, k1, e0 + i, size, sqrt_dt);
}

// Phase 1 of the rank's elements, ΔW elements [e0, e0 + count) of the
// one-key draw.  The windowed phase1_gen_kernel; the state is the rank's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
phase1_gen_window_kernel(const T* __restrict__ z, const T* __restrict__ zh,
                         const T* __restrict__ mu, const T* __restrict__ sigma,
                         const int64_t* __restrict__ keys, int64_t n, T dt_grid, T dt, T sign,
                         T* __restrict__ zh1, T* __restrict__ dw, int64_t e0, int64_t count,
                         int64_t size) {
  const T sqrt_dt = sqrt_ieee(dt_grid);
  const T sdt = mul(sign, dt);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  release_dependents();
  wait_for_predecessor();
  if (i >= count) return;
  const T z0 = z[i], zh0 = zh[i], mu0 = mu[i], s0 = sigma[i];
  uint32_t k0 = static_cast<uint32_t>(keys[0]);
  uint32_t k1 = static_cast<uint32_t>(keys[1]);
  fold_in(k0, k1, n);
  const T w = draw_element(k0, k1, e0 + i, size, sqrt_dt);
  zh1[i] = phase1_elem(z0, zh0, mu0, s0, w, sdt, sign);
  dw[i] = w;
}

// (W, H) elements [e0, e0 + count) of grid step n.  The windowed
// space_time_increment_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
space_time_increment_window_kernel(const int64_t* __restrict__ keys, int64_t n, T s_w, T s_h,
                                   T* __restrict__ w, T* __restrict__ h, int64_t e0,
                                   int64_t count, int64_t size) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  release_dependents();
  wait_for_predecessor();
  if (i >= count) return;
  uint32_t k0 = static_cast<uint32_t>(keys[0]);
  uint32_t k1 = static_cast<uint32_t>(keys[1]);
  fold_in(k0, k1, n);
  uint32_t a0, a1, b0, b1;
  split2(k0, k1, a0, a1, b0, b1);
  w[i] = draw_element(a0, a1, e0 + i, size, s_w);
  h[i] = draw_element(b0, b1, e0 + i, size, s_h);
}

// (W(t_b) - W(t0), I(t_b)) of row b, I the running time-integral, by the
// joint (W, ∫W) Lévy-bridge descent to `depth` levels (the reference's
// BrownianPath._wh).  A block owns up to 32 elements: `rpb` rows and a
// slice of `upb` draw units of each (a unit is a counter pair in float32,
// whose one hash gives elements j and j + half; an element in float64).
// Its eight warps form a pipeline over the levels, each level passing
// through a ring of kStRing slots in shared memory:
//   warp 0, the walker (a lane a row): the interval's h = b - a, half =
//     0.5h, the go-left bit and the chain key c of each level into the
//     level's slot, then publishes the level; c starts at the root key
//     fold_in(key, 0xB0BA) and moves to fold_in(c, 2|3).  The only serial
//     part: a dependent hash a level.  It waits only when it is kStRing
//     levels ahead of the combiner;
//   warps 2-7, the drawers (level l to warp l mod 6; a lane an element in
//     float64, a (row, ξ, unit) in float32): once level l is published,
//     its keys split(fold_in(c, 1)), its scales sqrt(half/8),
//     sqrt(half³/24), and its two scaled normals an element (s·ξ, the plain
//     version's products) into the slot, then publish the slot;
//   warp 1, the combiner (a lane an element): the root pair (W, H) from
//     split(root key) while the walk starts, then, as each level's draws
//     arrive, the plain version's op sequence for that level, carrying (w,
//     A, pw, pi) in registers; after the last level the conditional-mean
//     tail writes W and I.
// So the draws of level l overlap the walk of later levels and the combine
// of earlier ones, and a launch costs about the walk plus one level's draws
// and combine.  Publishing is a release store of a counter in shared
// memory after __syncwarp; waiting is an acquire load in a loop (the
// drawers sleep between tries).  Grid (space_time_value_grid): at most 32
// elements and 32 rows a block, aiming at kStTargetBlocks blocks (two an
// SM): one key over (256, 32) in float64 is 256 blocks of 32 elements,
// each redoing the row's walk.
//
// What bounds it (an NVIDIA H100 80GB HBM3 at 700 W, one key over (256,
// 32), float64; chip_smoke.py st_value_stamps and source_variants): not
// the operations (the bound is ~0.0011 ms at depth 10) but two latency
// chains.  The walk, ~320 ns a level with the midpoint hash beside the
// chain's (the walker alone, drawers held back, takes as long): it ends
// ~3.4 us into the block at depth 10, ~8.3 us at depth 24.  One level's
// draws, ~1.9 us from its publication (a split, then a hash and XLA's
// float64 erf_inv a normal, two a lane): the combiner's root pair, three
// hashes and two normals, alone takes ~2.7 us.  The combine of the last
// levels and the tail add ~0.5 us.  The kernel it replaced ran the same
// walk at ~166 ns a level, then every element's 2(depth + 1) normals one
// after another on one thread (~17 us at depth 10).  Tried and dropped
// (source_variants, ST_VARIANTS): 512 threads, four blocks an SM, a ring of
// 32, publishing every 4 levels, the combiner beside or away from the
// walker, the drawers deriving fold_in(c, 1), sleeping or spinning waits:
// none faster by more than 0.3%, four blocks an SM ~1.5x slower.  ptxas: float64 48 registers, 23,116 bytes of
// static shared memory; float32 31 and 14,668; no spills.
constexpr int kStThreads = 256;
constexpr int kStDrawWarps = kStThreads / 32 - 2;
constexpr int kStCombineWarp = 4;                // the walker is warp 0, the drawers the rest
constexpr int kStRing = 16;                      // levels in flight between walk and combine
constexpr int kStMaxDepth = 512;
constexpr int kStTargetBlocks = kTargetBlocks;

template <typename T>
struct StSlot {  // one level of the block's rows
  uint32_t c0[32], c1[32];  // the midpoint's key fold_in(c, 1), c the level's chain key
  T h[32], half[32];
  int left[32];
  T term[2][32];  // s0·ξ0 and s1·ξ1 of each element of the block
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// the warp's writes (ordered by __syncwarp), then lane 0 publishes `v`
__device__ __forceinline__ void publish(int* flag, int v, int lane) {
  __syncwarp();
  if (lane == 0) st_release(flag, v);
}

// The scaled normal(s) of draw unit u (of `units`, element count d) from key
// (k0, k1): element u's in float64, elements u and u + units in float32
// (their counter pair's one hash), into ts[ul] and ts[upb + ul].
__device__ __forceinline__ void st_draw(float, uint32_t k0, uint32_t k1, float scale,
                                        int64_t u, int64_t units, int64_t d, float* ts,
                                        int ul, int upb) {
  uint32_t x0 = static_cast<uint32_t>(u);
  uint32_t x1 = (d & 1) && u == units - 1 ? 0u : static_cast<uint32_t>(u + units);
  threefry2x32(k0, k1, x0, x1);
  ts[ul] = mul(scale, normal_f32_bits(x0));
  if (u + units < d) ts[upb + ul] = mul(scale, normal_f32_bits(x1));
}
__device__ __forceinline__ void st_draw(double, uint32_t k0, uint32_t k1, double scale,
                                        int64_t u, int64_t, int64_t d, double* ts, int ul,
                                        int) {
  ts[ul] = mul(scale, normal_elem(double(), k0, k1, u, d));
}

template <typename T>
__global__ void __launch_bounds__(kStThreads)
space_time_value_kernel(const int64_t* __restrict__ keys, const T* __restrict__ t, T t0, T t1,
                        T span, T s_w, T s_h, int depth, T* __restrict__ w_out,
                        T* __restrict__ i_out, int64_t rows, int64_t d, int rpb, int upb) {
  constexpr bool kPairs = sizeof(T) == 4;
  __shared__ StSlot<T> ring[kStRing];
  __shared__ T tail_a[32], tail_b[32];
  __shared__ int walked, combined, tail_ready, drawn[kStRing];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t units = kPairs ? (d + 1) / 2 : d;
  // the grid has < 2^31 blocks, so its decomposition is 32-bit arithmetic
  const int slices = static_cast<int>((units + upb - 1) / upb);
  const int bx = static_cast<int>(blockIdx.x);
  const int64_t r0 = static_cast<int64_t>(bx / slices) * rpb;
  const int64_t u0 = static_cast<int64_t>(bx % slices) * upb;
  const int nr = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  const int nu = static_cast<int>(units - u0 < upb ? units - u0 : upb);
  const int row_elems = (kPairs ? 2 : 1) * upb;
  if (tid < kStRing) drawn[tid] = 0;
  if (tid == 0) walked = combined = tail_ready = 0;
  __syncthreads();

  if (warp == 0) {  // the walker
    uint32_t ch0 = 0, ch1 = 0;
    T a = t0, b = t1, tb = T(0);
    if (lane < nr) {
      ch0 = static_cast<uint32_t>(keys[2 * (r0 + lane)]);
      ch1 = static_cast<uint32_t>(keys[2 * (r0 + lane) + 1]);
      fold_in(ch0, ch1, 0xB0BA);
      tb = t[r0 + lane];
    }
    for (int l = 0; l < depth; ++l) {
      if (l >= kStRing) {  // the slot's last level must have been combined
        while (ld_acquire(&combined) < l - kStRing + 1) {
        }
      }
      StSlot<T>& sl = ring[l % kStRing];
      if (lane < nr) {
        const T h = sub(b, a);
        const T half = mul(T(0.5), h);
        const T m = add(a, half);
        const bool go_left = tb <= m;
        uint32_t f0 = ch0, f1 = ch1;  // the midpoint's key, off the chain
        fold_in(f0, f1, 1);
        sl.c0[lane] = f0;
        sl.c1[lane] = f1;
        sl.h[lane] = h;
        sl.half[lane] = half;
        sl.left[lane] = go_left;
        fold_in(ch0, ch1, go_left ? 2 : 3);
        if (go_left) b = m; else a = m;
      }
      publish(&walked, l + 1, lane);
    }
    if (lane < nr) {
      tail_a[lane] = a;
      tail_b[lane] = b;
    }
    publish(&tail_ready, 1, lane);
  } else if (warp != kStCombineWarp) {  // drawer k: levels k, k + kStDrawWarps, ...
    const int drawer = warp - 1 - (warp > kStCombineWarp ? 1 : 0);
    // its lane's item: element (r, ul) in float64, (r, ξ, ul) in float32
    const int per_row = (kPairs ? 2 : 1) * upb;
    const int r = lane / per_row, which = kPairs ? lane / upb % 2 : 0, ul = lane % upb;
    const bool item = r < nr && ul < nu;
    for (int l = drawer; l < depth; l += kStDrawWarps) {
      while (ld_acquire(&walked) <= l) __nanosleep(32);
      StSlot<T>& sl = ring[l % kStRing];
      if (item) {
        uint32_t k0 = sl.c0[r], k1 = sl.c1[r];
        uint32_t a0, a1, b0, b1;
        split2(k0, k1, a0, a1, b0, b1);
        const T half = sl.half[r];
        T* ts = sl.term[0] + r * row_elems;
        if constexpr (kPairs) {
          const T scale = which ? sqrt_ieee(divide(mul(half, mul(half, half)), T(24)))
                                : sqrt_ieee(divide(half, T(8)));
          st_draw(T(), which ? b0 : a0, which ? b1 : a1, scale, u0 + ul, units, d,
                  ts + which * 32, ul, upb);
        } else {
          const T s0 = sqrt_ieee(divide(half, T(8)));
          const T s1 = sqrt_ieee(divide(mul(half, mul(half, half)), T(24)));
          st_draw(T(), a0, a1, s0, u0 + ul, units, d, ts, ul, upb);
          st_draw(T(), b0, b1, s1, u0 + ul, units, d, ts + 32, ul, upb);
        }
      }
      publish(&drawn[l % kStRing], l + 1, lane);
    }
  } else {  // the combiner: element (cr, ce), unit u0 + ce % upb, half ce / upb (float32)
    const int cr = lane / row_elems, ce = lane % row_elems;
    const int64_t cg = u0 + ce % upb + (ce / upb) * units;  // its index in the row
    const bool owner = cr < nr && ce % upb < nu && cg < d;
    T w = T(0), area = T(0), pw = T(0), pi = T(0);
    if (owner) {  // the root pair (W, H) from split(fold_in(key, 0xB0BA))
      uint32_t k0 = static_cast<uint32_t>(keys[2 * (r0 + cr)]);
      uint32_t k1 = static_cast<uint32_t>(keys[2 * (r0 + cr) + 1]);
      fold_in(k0, k1, 0xB0BA);
      uint32_t a0, a1, b0, b1;
      split2(k0, k1, a0, a1, b0, b1);
      w = mul(normal_elem(T(), a0, a1, cg, d), s_w);
      const T hr = mul(normal_elem(T(), b0, b1, cg, d), s_h);
      area = mul(span, add(hr, mul(T(0.5), w)));
    }
    for (int l = 0; l < depth; ++l) {
      const StSlot<T>& sl = ring[l % kStRing];
      while (ld_acquire(&drawn[l % kStRing]) <= l) {
      }
      if (owner) {
        const T h = sl.h[cr], half = sl.half[cr];
        const T w_l = add(sub(divide(mul(T(1.5), area), h), mul(T(0.25), w)), sl.term[0][lane]);
        const T a_l = add(add(mul(mul(T(-0.25), half), w), mul(T(0.5), area)), sl.term[1][lane]);
        if (sl.left[cr]) {
          w = w_l;
          area = a_l;
        } else {
          pi = add(add(pi, mul(half, pw)), a_l);
          pw = add(pw, w_l);
          const T w_r = sub(w, w_l);
          area = sub(sub(area, a_l), mul(half, w_l));
          w = w_r;
        }
      }
      publish(&combined, l + 1, lane);
    }
    while (ld_acquire(&tail_ready) == 0) {
    }
    if (!owner) return;
    const T ta = tail_a[cr], hh = sub(tail_b[cr], ta), tb = t[r0 + cr];
    T th = divide(sub(tb, ta), hh > tiny(T()) ? hh : tiny(T()));
    th = th < T(0) ? T(0) : (th > T(1) ? T(1) : th);
    const T th2 = mul(th, th);
    const T th3 = mul(th, th2);
    const T c1 = sub(mul(T(3), th2), mul(T(2), th));
    const T c2 = mul(mul(T(6), th), sub(T(1), th));
    const int64_t o = (r0 + cr) * d + cg;
    w_out[o] = add(add(pw, mul(c1, w)), divide(mul(c2, area), hh));
    i_out[o] = add(add(add(pi, mul(mul(th, hh), pw)), mul(mul(hh, sub(th3, th2)), w)),
                   mul(sub(mul(T(3), th2), mul(T(2), th3)), area));
  }
}

// The launch shape of space_time_value: rows and units a block (at most 32
// elements), and blocks; a function of (dtype, rows, d) alone.
struct StGrid {
  int rows_per_block, units_per_block;
  int64_t blocks;
};

template <typename T>
inline StGrid space_time_value_grid(int64_t rows, int64_t d) {
  constexpr bool kPairs = sizeof(T) == 4;
  const int64_t units = kPairs ? (d + 1) / 2 : d;
  const int64_t unit_cap = kPairs ? 16 : 32;  // 32 elements a block
  int64_t ub, rb;
  if (rows >= kStTargetBlocks) {
    ub = units < unit_cap ? units : unit_cap;
    rb = (rows + kStTargetBlocks - 1) / kStTargetBlocks;
    const int64_t fit = unit_cap / ub;
    rb = rb < fit ? rb : fit;
  } else {
    const int64_t per_row = (kStTargetBlocks + rows - 1) / rows;
    ub = (units + per_row - 1) / per_row;
    ub = ub < unit_cap ? ub : unit_cap;
    rb = 1;
  }
  ub = ub < 1 ? 1 : ub;
  rb = rb < 1 ? 1 : rb;
  return StGrid{static_cast<int>(rb), static_cast<int>(ub),
                (rows + rb - 1) / rb * ((units + ub - 1) / ub)};
}

// The launch shape of brownian_value: rows and units a block, and blocks.
struct ValueGrid {
  int rows_per_block, units_per_block;
  int64_t blocks;
};

inline ValueGrid brownian_value_grid(bool pairs, int64_t rows, int64_t d) {
  const int64_t units = pairs ? (d + 1) / 2 : d;
  const int64_t unit_cap = kDrawThreads / (pairs ? 2 : 1);
  int64_t ub, rb;
  if (rows >= kTargetBlocks) {
    ub = units < unit_cap ? units : unit_cap;
    rb = (rows + kTargetBlocks - 1) / kTargetBlocks;
    const int64_t fit = unit_cap / ub;
    rb = rb < fit ? rb : fit;
    rb = rb < kValueRows ? rb : kValueRows;
  } else {
    const int64_t per_row = (kTargetBlocks + rows - 1) / rows;
    ub = (units + per_row - 1) / per_row;
    ub = ub < unit_cap ? ub : unit_cap;
    rb = 1;
  }
  ub = ub < 1 ? 1 : ub;
  rb = rb < 1 ? 1 : rb;
  return ValueGrid{static_cast<int>(rb), static_cast<int>(ub),
                   (rows + rb - 1) / rb * ((units + ub - 1) / ub)};
}

// Launch `kernel` with `blocks` blocks of kThreads on `stream` as a
// programmatic dependent launch: it may be scheduled while its predecessor
// on the stream drains, and its griddepcontrol.wait holds it until the
// predecessor's memory is visible.  Returns the launch's error, else
// cudaGetLastError(), as every rt_* function does.
template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), int64_t blocks,
                                    cudaStream_t stream, Args... args) {
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The drawing kernels' draw units a row: counter pairs in float32.
inline int64_t increment_units(int dtype, int64_t d) { return dtype == 0 ? (d + 1) / 2 : d; }

// Whether the drawing kernels take their 64-bit index path at (rows, d).
inline bool increment_wide(int64_t rows, int64_t d) { return rows * d >= (int64_t{1} << 31); }

template <typename T, typename I>
cudaError_t launch_increment(const int64_t* keys, int64_t n, double dt, void* out,
                             int64_t rows, int64_t d, int64_t units, cudaStream_t s) {
  const int64_t total = rows * units;
  return launch_dependent(brownian_increment_kernel<T, I>, (total + kThreads - 1) / kThreads,
                          s, keys, n, static_cast<T>(dt), static_cast<T*>(out),
                          static_cast<I>(total), static_cast<I>(units), static_cast<I>(d));
}

template <typename T, typename I>
cudaError_t launch_space_time_increment(const int64_t* keys, int64_t n, double s_w, double s_h,
                                        void* w, void* h, int64_t rows, int64_t d,
                                        int64_t units, cudaStream_t s) {
  const int64_t total = rows * units;
  return launch_dependent(space_time_increment_kernel<T, I>, (total + kThreads - 1) / kThreads,
                          s, keys, n, static_cast<T>(s_w), static_cast<T>(s_h),
                          static_cast<T*>(w), static_cast<T*>(h), static_cast<I>(total),
                          static_cast<I>(units), static_cast<I>(d));
}

template <typename T, typename I>
cudaError_t launch_phase1_gen(const void* z, const void* zh, const void* mu, const void* sigma,
                              const int64_t* keys, int64_t n, double dt_grid, double dt,
                              double sign, void* zh1, void* dw, int64_t rows, int64_t d,
                              int64_t units, cudaStream_t s) {
  const int64_t total = rows * units;
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dependent(phase1_gen_kernel<T, I>, (total + kThreads - 1) / kThreads, s,
                          in(z), in(zh), in(mu), in(sigma), keys, n, static_cast<T>(dt_grid),
                          static_cast<T>(dt), static_cast<T>(sign), static_cast<T*>(zh1),
                          static_cast<T*>(dw), static_cast<I>(total), static_cast<I>(units),
                          static_cast<I>(d));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// A one-pass launch's blocks: a thread a 16-byte pack where `vector`, else
// a thread an element.
template <typename T>
int64_t pass_blocks(bool vector, int64_t total) {
  const int64_t per = vector ? Pack16<T>::kN : 1;
  return ((total + per - 1) / per + kThreads - 1) / kThreads;
}

template <typename T>
cudaError_t launch_phase2(const void* z, const void* mu, const void* mu1, const void* sigma,
                          const void* sigma1, const void* dw, double dt, double sign,
                          void* out, int64_t total, cudaStream_t s) {
  const bool vector = aligned16(z) && aligned16(mu) && aligned16(mu1) && aligned16(sigma) &&
                      aligned16(sigma1) && aligned16(dw) && aligned16(out);
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dependent(vector ? rev_heun_phase2_kernel<T, true>
                                 : rev_heun_phase2_kernel<T, false>,
                          pass_blocks<T>(vector, total), s, in(z), in(mu), in(mu1), in(sigma),
                          in(sigma1), in(dw), static_cast<T>(dt), static_cast<T>(sign),
                          static_cast<T*>(out), total);
}

template <typename T>
cudaError_t launch_bwd_phase1(const void* g_z1, const void* g_mu1, const void* g_sig1,
                              const void* dw, double dt, void* c_mu1, void* c_sig1,
                              int64_t total, cudaStream_t s) {
  const bool vector = aligned16(g_z1) && aligned16(g_mu1) && aligned16(g_sig1) &&
                      aligned16(dw) && aligned16(c_mu1) && aligned16(c_sig1);
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dependent(vector ? bwd_phase1_kernel<T, true> : bwd_phase1_kernel<T, false>,
                          pass_blocks<T>(vector, total), s, in(g_z1), in(g_mu1), in(g_sig1),
                          in(dw), static_cast<T>(dt), static_cast<T*>(c_mu1),
                          static_cast<T*>(c_sig1), total);
}

template <typename T>
cudaError_t launch_phase1(const void* z, const void* zh, const void* mu, const void* sigma,
                          const void* dw, double dt, double sign, void* zh1, int64_t total,
                          cudaStream_t s) {
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dependent(phase1_kernel<T>, (total + kThreads - 1) / kThreads, s, in(z),
                          in(zh), in(mu), in(sigma), in(dw), static_cast<T>(dt),
                          static_cast<T>(sign), static_cast<T*>(zh1), total);
}

template <typename T>
cudaError_t launch_bwd_phase2(const void* g_z1, const void* ghat, const void* dw, double dt,
                              void* d_z, void* d_zh, void* d_mu, void* d_sigma, int64_t total,
                              cudaStream_t s) {
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dependent(bwd_phase2_kernel<T>, (total + kThreads - 1) / kThreads, s,
                          in(g_z1), in(ghat), in(dw), static_cast<T>(dt), static_cast<T*>(d_z),
                          static_cast<T*>(d_zh), static_cast<T*>(d_mu),
                          static_cast<T*>(d_sigma), total);
}


// The windowed draws' launches: a thread an element of the window.
inline int64_t window_blocks(int64_t count) { return (count + kThreads - 1) / kThreads; }

}  // namespace repro_torch


extern "C" int rt_brownian_increment(int dtype, const int64_t* keys, int64_t n,
                                     double dt, void* out, int64_t rows, int64_t d,
                                     void* stream) {
  using repro_torch::launch_increment;
  if (rows * d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t units = repro_torch::increment_units(dtype, d);
  cudaError_t err;
  if (repro_torch::increment_wide(rows, d)) {
    err = dtype == 0 ? launch_increment<float, uint64_t>(keys, n, dt, out, rows, d, units, s)
                     : launch_increment<double, uint64_t>(keys, n, dt, out, rows, d, units, s);
  } else {
    err = dtype == 0 ? launch_increment<float, uint32_t>(keys, n, dt, out, rows, d, units, s)
                     : launch_increment<double, uint32_t>(keys, n, dt, out, rows, d, units, s);
  }
  return static_cast<int>(err);
}

// brownian_increment's index helper on the host: whether the launcher takes
// the 64-bit path at (dtype, rows, d) (the return value), and unit u's (row,
// unit in the row) by that path's unit_coords into row_j[0], row_j[1].
extern "C" int rt_brownian_increment_unit(int dtype, int64_t rows, int64_t d, int64_t u,
                                          int64_t* row_j) {
  const int64_t units = repro_torch::increment_units(dtype, d);
  if (repro_torch::increment_wide(rows, d)) {
    uint64_t b, j;
    repro_torch::unit_coords<uint64_t>(u, units, b, j);
    row_j[0] = static_cast<int64_t>(b);
    row_j[1] = static_cast<int64_t>(j);
    return 1;
  }
  uint32_t b, j;
  repro_torch::unit_coords<uint32_t>(static_cast<uint32_t>(u), static_cast<uint32_t>(units),
                                     b, j);
  row_j[0] = b;
  row_j[1] = j;
  return 0;
}

// The number of programmatic-dependency edges of a captured CUDA graph (a
// cudaGraph_t), or -1 where the runtime cannot tell.
extern "C" int64_t rt_graph_programmatic_edges(void* graph) {
#if CUDART_VERSION >= 12030
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t num = 0;
#if CUDART_VERSION >= 13000
#define REPRO_GRAPH_EDGES cudaGraphGetEdges
#else
#define REPRO_GRAPH_EDGES cudaGraphGetEdges_v2
#endif
  if (REPRO_GRAPH_EDGES(g, nullptr, nullptr, nullptr, &num) != cudaSuccess) return -1;
  std::vector<cudaGraphNode_t> from(num), to(num);
  std::vector<cudaGraphEdgeData> data(num);
  if (REPRO_GRAPH_EDGES(g, from.data(), to.data(), data.data(), &num) != cudaSuccess) {
    return -1;
  }
#undef REPRO_GRAPH_EDGES
  int64_t count = 0;
  for (size_t i = 0; i < num; ++i) count += data[i].type == cudaGraphDependencyTypeProgrammatic;
  return count;
#else
  (void)graph;
  return -1;
#endif
}

extern "C" int rt_rev_heun_phase1_gen(int dtype, const void* z, const void* zh,
                                      const void* mu, const void* sigma,
                                      const int64_t* keys, int64_t n, double dt_grid,
                                      double dt, double sign, void* zh1, void* dw,
                                      int64_t rows, int64_t d, void* stream) {
  using repro_torch::launch_phase1_gen;
  if (rows * d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t units = repro_torch::increment_units(dtype, d);
  cudaError_t err;
  if (repro_torch::increment_wide(rows, d)) {
    err = dtype == 0 ? launch_phase1_gen<float, uint64_t>(z, zh, mu, sigma, keys, n, dt_grid,
                                                          dt, sign, zh1, dw, rows, d, units, s)
                     : launch_phase1_gen<double, uint64_t>(z, zh, mu, sigma, keys, n, dt_grid,
                                                           dt, sign, zh1, dw, rows, d, units,
                                                           s);
  } else {
    err = dtype == 0 ? launch_phase1_gen<float, uint32_t>(z, zh, mu, sigma, keys, n, dt_grid,
                                                          dt, sign, zh1, dw, rows, d, units, s)
                     : launch_phase1_gen<double, uint32_t>(z, zh, mu, sigma, keys, n, dt_grid,
                                                           dt, sign, zh1, dw, rows, d, units,
                                                           s);
  }
  return static_cast<int>(err);
}

extern "C" int rt_rev_heun_phase2(int dtype, const void* z, const void* mu,
                                  const void* mu1, const void* sigma, const void* sigma1,
                                  const void* dw, double dt, double sign, void* out,
                                  int64_t total, void* stream) {
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? repro_torch::launch_phase2<float>(z, mu, mu1, sigma, sigma1, dw, dt, sign,
                                                     out, total, s)
                 : repro_torch::launch_phase2<double>(z, mu, mu1, sigma, sigma1, dw, dt, sign,
                                                      out, total, s);
  return static_cast<int>(err);
}

extern "C" int rt_rev_heun_phase1(int dtype, const void* z, const void* zh, const void* mu,
                                  const void* sigma, const void* dw, double dt, double sign,
                                  void* zh1, int64_t total, void* stream) {
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? repro_torch::launch_phase1<float>(z, zh, mu, sigma, dw, dt, sign, zh1, total, s)
                 : repro_torch::launch_phase1<double>(z, zh, mu, sigma, dw, dt, sign, zh1, total,
                                                      s);
  return static_cast<int>(err);
}

extern "C" int rt_rev_heun_bwd_phase1(int dtype, const void* g_z1, const void* g_mu1,
                                      const void* g_sig1, const void* dw, double dt,
                                      void* c_mu1, void* c_sig1, int64_t total,
                                      void* stream) {
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? repro_torch::launch_bwd_phase1<float>(g_z1, g_mu1, g_sig1, dw, dt, c_mu1,
                                                         c_sig1, total, s)
                 : repro_torch::launch_bwd_phase1<double>(g_z1, g_mu1, g_sig1, dw, dt, c_mu1,
                                                          c_sig1, total, s);
  return static_cast<int>(err);
}

extern "C" int rt_rev_heun_bwd_phase2(int dtype, const void* g_z1, const void* ghat,
                                      const void* dw, double dt, void* d_z, void* d_zh,
                                      void* d_mu, void* d_sigma, int64_t total,
                                      void* stream) {
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? repro_torch::launch_bwd_phase2<float>(g_z1, ghat, dw, dt, d_z, d_zh, d_mu,
                                                         d_sigma, total, s)
                 : repro_torch::launch_bwd_phase2<double>(g_z1, ghat, dw, dt, d_z, d_zh, d_mu,
                                                          d_sigma, total, s);
  return static_cast<int>(err);
}

extern "C" int rt_brownian_value(int dtype, const int64_t* keys, const void* t,
                                 double t0, double t1, int depth, void* out,
                                 int64_t rows, int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows * d > 0) {
    const repro_torch::ValueGrid g = repro_torch::brownian_value_grid(dtype == 0, rows, d);
    if (g.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(g.blocks);
    constexpr int kT = repro_torch::kValueThreads;
    // the span and its sqrt in the state dtype, as the plain version rounds them
    if (dtype == 0) {
      const float sqrt_span = sqrtf(static_cast<float>(t1 - t0));
      repro_torch::brownian_value_kernel<float><<<blocks, kT, 0, s>>>(
          keys, static_cast<const float*>(t), static_cast<float>(t0),
          static_cast<float>(t1), sqrt_span, depth, static_cast<float*>(out), rows, d,
          g.rows_per_block, g.units_per_block);
    } else {
      repro_torch::brownian_value_kernel<double><<<blocks, kT, 0, s>>>(
          keys, static_cast<const double*>(t), t0, t1, sqrt(t1 - t0), depth,
          static_cast<double*>(out), rows, d, g.rows_per_block, g.units_per_block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of blocks rt_brownian_value launches for (dtype, rows, d).
extern "C" int64_t rt_brownian_value_blocks(int dtype, int64_t rows, int64_t d) {
  return rows * d > 0 ? repro_torch::brownian_value_grid(dtype == 0, rows, d).blocks : 0;
}

// s_w = sqrt(dt) and s_h = sqrt(dt / 12) come rounded to the state dtype
// from the host, as the plain version forms them.
extern "C" int rt_space_time_increment(int dtype, const int64_t* keys, int64_t n, double s_w,
                                       double s_h, void* w, void* h, int64_t rows, int64_t d,
                                       void* stream) {
  using repro_torch::launch_space_time_increment;
  if (rows * d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t units = repro_torch::increment_units(dtype, d);
  cudaError_t err;
  if (repro_torch::increment_wide(rows, d)) {
    err = dtype == 0 ? launch_space_time_increment<float, uint64_t>(keys, n, s_w, s_h, w, h,
                                                                    rows, d, units, s)
                     : launch_space_time_increment<double, uint64_t>(keys, n, s_w, s_h, w, h,
                                                                     rows, d, units, s);
  } else {
    err = dtype == 0 ? launch_space_time_increment<float, uint32_t>(keys, n, s_w, s_h, w, h,
                                                                    rows, d, units, s)
                     : launch_space_time_increment<double, uint32_t>(keys, n, s_w, s_h, w, h,
                                                                     rows, d, units, s);
  }
  return static_cast<int>(err);
}

// span, s_w = sqrt(span) and s_h = sqrt(span / 12) come rounded to the
// state dtype from the host, as the plain version forms them.
extern "C" int rt_space_time_value(int dtype, const int64_t* keys, const void* t, double t0,
                                   double t1, double span, double s_w, double s_h, int depth,
                                   void* w, void* i, int64_t rows, int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth < 0 || depth > repro_torch::kStMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows * d > 0) {
    constexpr int kT = repro_torch::kStThreads;
    const auto g = dtype == 0 ? repro_torch::space_time_value_grid<float>(rows, d)
                              : repro_torch::space_time_value_grid<double>(rows, d);
    if (g.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(g.blocks);
    if (dtype == 0) {
      repro_torch::space_time_value_kernel<float><<<blocks, kT, 0, s>>>(
          keys, static_cast<const float*>(t), static_cast<float>(t0), static_cast<float>(t1),
          static_cast<float>(span), static_cast<float>(s_w), static_cast<float>(s_h), depth,
          static_cast<float*>(w), static_cast<float*>(i), rows, d, g.rows_per_block,
          g.units_per_block);
    } else {
      repro_torch::space_time_value_kernel<double><<<blocks, kT, 0, s>>>(
          keys, static_cast<const double*>(t), t0, t1, span, s_w, s_h, depth,
          static_cast<double*>(w), static_cast<double*>(i), rows, d, g.rows_per_block,
          g.units_per_block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Row-windowed one-key draws: elements [e0, e0 + count) of the size-`size`
// draw of the one key keys[0..1] (a data-parallel rank's rows).  The window
// (0, size, size) gives the unwindowed launch's bits.
extern "C" int rt_brownian_increment_window(int dtype, const int64_t* keys, int64_t n,
                                            double dt, void* out, int64_t e0, int64_t count,
                                            int64_t size, void* stream) {
  using namespace repro_torch;
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  if (e0 < 0 || e0 + count > size || size >= (int64_t{1} << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = window_blocks(count);
  const cudaError_t err =
      dtype == 0 ? launch_dependent(brownian_increment_window_kernel<float>, blocks, s, keys, n,
                                    static_cast<float>(dt), static_cast<float*>(out), e0, count,
                                    size)
                 : launch_dependent(brownian_increment_window_kernel<double>, blocks, s, keys,
                                    n, dt, static_cast<double*>(out), e0, count, size);
  return static_cast<int>(err);
}

extern "C" int rt_rev_heun_phase1_gen_window(int dtype, const void* z, const void* zh,
                                             const void* mu, const void* sigma,
                                             const int64_t* keys, int64_t n, double dt_grid,
                                             double dt, double sign, void* zh1, void* dw,
                                             int64_t e0, int64_t count, int64_t size,
                                             void* stream) {
  using namespace repro_torch;
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  if (e0 < 0 || e0 + count > size || size >= (int64_t{1} << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = window_blocks(count);
  cudaError_t err;
  if (dtype == 0) {
    const auto in = [](const void* p) { return static_cast<const float*>(p); };
    err = launch_dependent(phase1_gen_window_kernel<float>, blocks, s, in(z), in(zh), in(mu),
                           in(sigma), keys, n, static_cast<float>(dt_grid),
                           static_cast<float>(dt), static_cast<float>(sign),
                           static_cast<float*>(zh1), static_cast<float*>(dw), e0, count, size);
  } else {
    const auto in = [](const void* p) { return static_cast<const double*>(p); };
    err = launch_dependent(phase1_gen_window_kernel<double>, blocks, s, in(z), in(zh), in(mu),
                           in(sigma), keys, n, dt_grid, dt, sign, static_cast<double*>(zh1),
                           static_cast<double*>(dw), e0, count, size);
  }
  return static_cast<int>(err);
}

extern "C" int rt_space_time_increment_window(int dtype, const int64_t* keys, int64_t n,
                                              double s_w, double s_h, void* w, void* h,
                                              int64_t e0, int64_t count, int64_t size,
                                              void* stream) {
  using namespace repro_torch;
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  if (e0 < 0 || e0 + count > size || size >= (int64_t{1} << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = window_blocks(count);
  const cudaError_t err =
      dtype == 0 ? launch_dependent(space_time_increment_window_kernel<float>, blocks, s, keys,
                                    n, static_cast<float>(s_w), static_cast<float>(s_h),
                                    static_cast<float*>(w), static_cast<float*>(h), e0, count,
                                    size)
                 : launch_dependent(space_time_increment_window_kernel<double>, blocks, s, keys,
                                    n, s_w, s_h, static_cast<double*>(w),
                                    static_cast<double*>(h), e0, count, size);
  return static_cast<int>(err);
}
