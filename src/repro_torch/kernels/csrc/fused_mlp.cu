// The SDE vector-field MLP, Linear -> LipSwish -> Linear, in one launch, and
// its backward in one launch, for Hopper.
//
// Replaces the Pallas kernel fused_mlp of the JAX package:
//   src/repro/kernels/fused_mlp.py:43 (kernel body :26-32, pallas_call :52)
// and computes the function of src/repro/kernels/ref.py:156, row by row, for
// x (R, Din) -> out (R, Dout):
//   pre = x·W1 + b1                                   (R × H)
//   a   = 0.909·(pre·σ(pre)),  σ(p) = 1/(1 + exp(−p))
//   out = cast(a)·W2 + b2                             (R × Dout)
// float32 and bfloat16 operands accumulate in float32, float64 operands in
// float64 (the port's training path runs the adjoint identities in float64
// through these fields; the Pallas body's preferred_element_type=float32
// covers f32 and bf16 only).  a is rounded to x's dtype before the second
// product (fused_mlp.py:30-31; a no-op but for bf16), and the output is cast
// to x's dtype.  exp is the IEEE one: the library builds with -fmad=false
// and without --use_fast_math.
//
// Row invariance, the design constraint.  Serving holds a request's rows to
// the same bits whatever bucket they are coalesced into (bucket 1 = a row of
// bucket 1024, bitwise).  cuBLAS picks its GEMM by shape, so the plain port
// multiplies fixed 1024-row blocks (src/repro_torch/nn/core.py).  Here every
// element of pre and out is one thread's sum over ascending k, each
// multiply-add spelled __fmaf_rn / __fma_rn, from 0, then the bias: the same
// operations in the same order whatever R, the block the row lands in, the
// rows per block or whether the weights came from shared memory.
//
// Design.  The SDE widths are tiny (Din 2-33, H 32-64, Dout 16-64), so a
// launch is bound by latency, not by bytes or flops.  Each field shape the
// port runs (REPRO_MLP_FIXED_WIDTHS: the ELBO's, the SDE-GAN's, the burst's) has
// its own instantiation, fused_mlp_fixed<T, Acc, Din, H, Dout>, so every
// loop is unrolled; any other width takes the runtime-width kernel below
// (fused_mlp_kernel), and which one runs depends on the dtype and the
// widths alone, never on R.  A fixed block is 4 warps over 8 consecutive
// rows (R 1024: 128 blocks, one wave on 132 SMs; R 64: 8 blocks).  It
// stages W1, b1, W2, b2 and its tile of x with 16-byte cp.async copies
// (element copies where a source is not 16-byte aligned), then one
// barrier; after it the warps share nothing.  A warp owns 2 rows: layer l's
// N outputs of a row spread over min(N, 32) lanes (two rows a pass where N
// = 16), each lane keeping rows × N/32 independent accumulators, the
// weights read across lanes from shared memory (distinct banks) and x or a
// as a broadcast; a passes to layer 2 through shared memory (row stride H
// + 1) and a __syncwarp.  The sums and the LipSwish are the runtime-width
// kernel's, op for op, so both give the same bits, and the forward's bits
// are the earlier kernel's.  Tensor cores were not taken: the products are
// ~0.5 us of the launch (below).
//
// What bounds it (an NVIDIA H100 80GB HBM3 at 700 W, 17 -> 32 -> 16,
// float32; chip_smoke.py mlp_fwd_stamps and source_variants): the launch
// (~1.7-1.9 us back to back), then one memory round trip for the copies
// (~1800 cycles issued and waited for, ~0.9 us of device time: with plain
// 16-byte loads in their place it takes ~0.8 us more), then layer 1 ~530
// and layer 2 with the store ~400 cycles.  The runtime-width kernel it
// replaced on these shapes spent ~3270 cycles staging element by element
// and ~1870 + ~1190 in its two passes (runtime loops, one FMA chain a
// thread, each FMA waiting on two shared loads).  ptxas: float32 17 -> 32
// -> 16 32 registers, 6,016 bytes of shared memory; float64 32 -> 64 -> 32
// 90 registers, 39,744 bytes; no spills.  The runtime-width kernel: a block
// of 128 threads owns up to 8 rows, stages the weights (when they fit in
// 48 KB beside the tile; else reads them through L1/L2) and converts the
// row tile to the accumulator type, then thread e computes pre/a for (row
// e / H, unit e % H) and, after a barrier, out for (row e / Dout, column e
// % Dout).
//
// Bound.  At the training state (R = 1024, 17 -> 32 -> 16, f32) the kernel
// reads 69.6 KB of x and 4.4 KB of weights and writes 65.5 KB: 0.042 us at
// 3.35 TB/s, so it is bound by bytes; its 2R(Din·H + H·Dout) + 6R·H
// (LipSwish) + R(H + Dout) flops, 2.41 MFLOP, take 0.036 us at 67 TFLOP/s.
// Both are far below the ~2 us a launch costs, so launches are what count:
// one here against the ~16 device kernels of the unfused chain.
//
// The backward, fused_mlp_bwd.  It replaces the plain VJP the port ran
// before (kernels/vjp.py: ref.fused_mlp recomputed under autograd, ~34 aten
// ops and ~30 device kernels a call); the JAX package has no backward
// kernel, XLA differentiates the plain definition.  Given x, W1, b1, W2 and
// the cotangent g (R, Dout), one launch writes all five gradients:
//   pre  = x·W1 + b1            (recomputed: nothing of the forward is saved)
//   a    = cast(0.909·pre·s),   s = σ(pre)
//   da   = g·W2ᵀ,   dpre = da ⊙ 0.909·(s + pre·s·(1 − s))
//   dW2 = aᵀg,  db2 = Σ_r g,  dW1 = xᵀ·dpre,  db1 = Σ_r dpre,  dx = dpre·W1ᵀ
// in the forward's types (bf16 with f32 arithmetic; a rounded to bf16 and
// the bf16 rounding differentiated as the identity, as autograd of the
// plain version does).  σ here is the MUFU's in f32 (ex2/rcp.approx, a few
// ulp) and IEEE in f64: the gradients are held to a tolerance, and nothing
// asks them to repeat the forward's bits.
//
// Design.  One thread-block cluster of kCluster = 16 blocks (a non-portable
// size: it halves the rows a block carries against the portable 8 and
// measured faster at R = 1024; cudaOccupancyMaxActiveClusters says 7 fit
// an H100), 512 threads a block.  Block r owns consecutive tiles of
// `tile` rows (ceil(R/16) rounded up to the MMA's M, at most 128; the plan
// is a function of dtype, R and widths alone, so dW and db depend on R
// alone and two launches give the same bits).  Each tile, staged by
// cp.async (an element a copy) in padded shared-memory layouts, is:
//   1. pre = x·W1 and da = g·W2ᵀ, a warp an M × 8 output tile, into shared
//      memory; then a and dpre, a thread an element;
//   2. dW1ᵀ|db1 = dpreᵀ·[x | 1] and dW2ᵀ|db2 = gᵀ·[a | 1] (the ones
//      columns make the bias sums columns of the products), added to the
//      block's running sums, and dx = dpre·W1ᵀ straight to global memory
//      (a row's dx depends on that row alone: bitwise the same at any R).
// Every product runs on mma.sync tensor cores: split TF32 (m16n8k8,
// tensor_core.cuh, three products in three accumulators) for f32 and bf16,
// DMMA (m8n8k4) for f64; a fresh tensor-core sum covers at most 64 of
// depth and the pieces are added in order with IEEE adds.  Tensor cores pay
// here not by shortening one sum (K is 8–128) but in shared-memory traffic:
// an FMA on CUDA cores reads one or two shared operands, one m16n8k8 reads
// six fragment values a lane for 1024 multiply-adds.  Odd widths are
// padded with zeros in shared memory (fma(0, w, s) is exact).
//
// The reduction across blocks.  No atomics, fences or tickets: after its
// last tile a block sends each of its sums e into the shared memory of
// block e mod 16 (st.async, counted on that block's mbarrier); block r
// waits on its own barrier and adds its slice over ranks 0, 1, ... in
// ascending order, then writes it.  One relaxed cluster barrier at the
// start makes sure every block's mbarrier exists before the sends.  So
// there are no partials in global memory, no fence, no atomic ticket, no
// last block adding every partial alone, no counter to reset and no
// scratch on the host.  Where the sums do not fit in shared memory (of the
// checked widths only 512 -> 512 -> 512, which no path runs) the weights
// are read through L1/L2 and each block writes its sums to a global
// partial (allocated by the caller with torch.empty), read after a cluster
// barrier in the same ascending order.
//
// What bounds it (an H100, 17 -> 32 -> 16, f32, chip_smoke.py
// mlp_bwd_stamps and mlp_bwd_split): not bytes or operations but latency
// and issue.  Launching the cluster costs ~1.9 µs; then, at R = 64 / 1024,
// the barriers' set-up ~0.5 / 0.7 µs, the loads ~1.1 / 2.3 µs (one
// cp.async request an element; 16-byte and bulk copies measured no
// faster), step 1 ~0.85 / 2.3 µs and step 2 ~1.1 / 2.3 µs (the split-TF32
// products: three mma.sync a k-step, ~40 cycles each on a scheduler), the
// slices and the writes ~0.45 µs.
//
// Bound of the backward.  At R = 1024, 17 -> 32 -> 16, f32 it reads x, g
// and the weights and writes dx and the weight gradients, ~214 KB: 0.064
// µs at 3.35 TB/s; its 2R(3·Din·H + 2·H·Dout) + 13·R·H + R·Dout flops, 5.9
// MFLOP, take 0.088 µs at 67 TFLOP/s: bound by operations, far below a
// launch (chip_smoke.py mlp_bwd_bound).
//
// Interface: plain C functions (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16, 2 = float64; x, W1, b1, W2, b2 and
// out (and dx, dW1, db1, dW2, db2) contiguous in one dtype, W (in, out)
// row-major as the reference's pytree holds them; g any row and column
// strides.  They launch on the given stream and return the launch's error
// (cudaLaunchKernelEx, then cudaGetLastError()), or cudaErrorInvalidValue for
// a dtype, width or partial buffer they do not take.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "tensor_core.cuh"

namespace repro_torch_mlp {

constexpr int kThreads = 128;
constexpr int kRowsMax = 8;
constexpr int kSmemBytes = 48 * 1024;  // the static limit: no attribute needed

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float exp_ieee(float x) { return expf(x); }
__device__ __forceinline__ double exp_ieee(double x) { return exp(x); }

template <typename Acc>
__device__ __forceinline__ Acc lipswish(Acc p) {
  const Acc one = static_cast<Acc>(1.0);
  const Acc s = one / (one + exp_ieee(-p));
  return static_cast<Acc>(0.909) * (p * s);
}

// Load/store between the operand type T and the accumulator type Acc.
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ double load(const double* p) { return __ldg(p); }

template <typename T, typename Acc> __device__ __forceinline__ T from_acc(Acc v);
template <> __device__ __forceinline__ float from_acc<float, float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double, double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename Acc, bool kStaged>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                 int64_t rows, int din, int hidden, int dout, int tile) {
  extern __shared__ double smem_d[];  // 8-byte aligned for f64
  Acc* xs = reinterpret_cast<Acc*>(smem_d);  // tile × Din
  Acc* as = xs + tile * din;                 // tile × H
  T* w1s = reinterpret_cast<T*>(as + tile * hidden);
  T* w2s = w1s + din * hidden;
  T* b1s = w2s + hidden * dout;
  T* b2s = b1s + hidden;

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int nr = static_cast<int>(rows - row0 < tile ? rows - row0 : tile);

  if (kStaged) {
    for (int e = tid; e < din * hidden; e += kThreads) w1s[e] = w1[e];
    for (int e = tid; e < hidden * dout; e += kThreads) w2s[e] = w2[e];
    for (int e = tid; e < hidden; e += kThreads) b1s[e] = b1[e];
    for (int e = tid; e < dout; e += kThreads) b2s[e] = b2[e];
  }
  const T* xb = x + row0 * din;
  for (int e = tid; e < nr * din; e += kThreads) xs[e] = load(xb + e);
  __syncthreads();

  // pre / a: thread e -> (row e / H, hidden unit e % H)
  for (int e = tid; e < nr * hidden; e += kThreads) {
    const int r = e / hidden;
    const int k = e - r * hidden;
    const Acc* xr = xs + r * din;
    Acc acc = static_cast<Acc>(0);
    for (int i = 0; i < din; ++i) {
      const Acc w = kStaged ? to_acc(w1s[i * hidden + k]) : load(w1 + i * hidden + k);
      acc = fma_rn(xr[i], w, acc);
    }
    const Acc pre = acc + (kStaged ? to_acc(b1s[k]) : load(b1 + k));
    // the hidden activation in x's dtype before the second product
    as[e] = to_acc(from_acc<T, Acc>(lipswish(pre)));
  }
  __syncthreads();

  // out: thread e -> (row e / Dout, output column e % Dout)
  T* ob = out + row0 * dout;
  for (int e = tid; e < nr * dout; e += kThreads) {
    const int r = e / dout;
    const int j = e - r * dout;
    const Acc* ar = as + r * hidden;
    Acc acc = static_cast<Acc>(0);
    for (int k = 0; k < hidden; ++k) {
      const Acc w = kStaged ? to_acc(w2s[k * dout + j]) : load(w2 + k * dout + j);
      acc = fma_rn(ar[k], w, acc);
    }
    ob[e] = from_acc<T, Acc>(acc + (kStaged ? to_acc(b2s[j]) : load(b2 + j)));
  }
}

// ---- the fixed-width forward ----------------------------------------------
//
// One instantiation for each field shape the port runs (kFixedWidths), the
// widths compile-time constants so that every loop is unrolled.  A block of
// kFixedWarps warps owns kFixedRows consecutive rows, a warp kWarpRows of
// them; the warps share nothing but the staged weights, so the one block
// barrier is the staging's.  Inside a warp, layer l's N outputs of a row
// are spread over LaneSplit<N>::lanes lanes (several rows a pass where N <
// 32), and a lane keeps `rows × cols` independent accumulators.
constexpr int kFixedWarps = 4;
constexpr int kFixedThreads = 32 * kFixedWarps;
constexpr int kWarpRows = 2;
constexpr int kFixedRows = kFixedWarps * kWarpRows;

template <int N>
struct LaneSplit {
  static constexpr int lanes = N < 32 ? N : 32;      // lanes sharing one row
  static constexpr int groups = 32 / lanes;          // rows a warp covers at once
  static constexpr int cols = N / lanes;             // outputs a lane, a row
  static constexpr int rows = kWarpRows / groups;    // rows a lane
  static constexpr bool ok = (N % 32 == 0 || 32 % N == 0) && kWarpRows % groups == 0;
};

// (Din, H, Dout) of the fixed instantiations: the depth-1 fields of the
// ELBO (mu, sigma, nu, qz0, zeta), the SDE-GAN's generator and
// discriminator (chip_smoke.py MLP_SHAPES) and the adaptive burst.
#define REPRO_MLP_FIXED_WIDTHS(X) \
  X(17, 32, 16) X(33, 32, 16) X(16, 32, 16) X(8, 32, 16) X(4, 32, 16) X(2, 32, 16) \
  X(17, 32, 64) X(17, 32, 32) X(32, 64, 32)

// Copy n elements of T from global to shared memory, 16-byte cp.async
// chunks where the source is 16-byte aligned (the destination always is),
// the remainder (or everything, unaligned) an element at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int tid) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = n * static_cast<int>(sizeof(T)) / 16;
    for (int c = tid; c < chunks; c += kFixedThreads)
      repro_torch_tc::cp_async16(repro_torch_tc::smem_addr(reinterpret_cast<char*>(dst) + 16 * c),
                                 reinterpret_cast<const char*>(src) + 16 * c, 16);
    for (int e = chunks * 16 / static_cast<int>(sizeof(T)) + tid; e < n; e += kFixedThreads)
      dst[e] = src[e];
  } else {
    for (int e = tid; e < n; e += kFixedThreads) dst[e] = src[e];
  }
}

template <typename T, typename Acc, int DIN, int H, int DOUT>
__global__ void __launch_bounds__(kFixedThreads)
fused_mlp_fixed(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                int64_t rows) {
  using S1 = LaneSplit<H>;
  using S2 = LaneSplit<DOUT>;
  static_assert(S1::ok && S2::ok, "a fixed width must divide or be a multiple of 32");
  constexpr int kAs = H + 1;  // the activation's row stride: two rows a pass, distinct banks
  __shared__ __align__(16) T w1s[DIN * H];
  __shared__ __align__(16) T w2s[H * DOUT];
  __shared__ __align__(16) T b1s[H];
  __shared__ __align__(16) T b2s[DOUT];
  __shared__ __align__(16) T xs[kFixedRows * DIN];
  __shared__ Acc as[kFixedRows * kAs];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kFixedRows;
  const int nr = static_cast<int>(rows - row0 < kFixedRows ? rows - row0 : kFixedRows);
  stage(w1s, w1, DIN * H, tid);
  stage(w2s, w2, H * DOUT, tid);
  stage(b1s, b1, H, tid);
  stage(b2s, b2, DOUT, tid);
  stage(xs, x + row0 * DIN, nr * DIN, tid);
  repro_torch_tc::cp_async_commit();
  repro_torch_tc::cp_async_wait<0>();
  __syncthreads();

  const int lane = tid & 31;
  const int wr = (tid >> 5) * kWarpRows;  // the warp's first row in the tile
  // layer 1: pre = x·W1 + b1 and a = cast(LipSwish(pre)) for rows
  // wr + g1 + groups·q and hidden units c1 + lanes·m
  {
    const int g1 = lane / S1::lanes, c1 = lane % S1::lanes;
    Acc acc[S1::rows][S1::cols];
#pragma unroll
    for (int q = 0; q < S1::rows; ++q)
#pragma unroll
      for (int m = 0; m < S1::cols; ++m) acc[q][m] = static_cast<Acc>(0);
#pragma unroll
    for (int i = 0; i < DIN; ++i) {
      Acc w[S1::cols];
#pragma unroll
      for (int m = 0; m < S1::cols; ++m) w[m] = to_acc(w1s[i * H + c1 + S1::lanes * m]);
#pragma unroll
      for (int q = 0; q < S1::rows; ++q) {
        const Acc xv = to_acc(xs[(wr + g1 + S1::groups * q) * DIN + i]);
#pragma unroll
        for (int m = 0; m < S1::cols; ++m) acc[q][m] = fma_rn(xv, w[m], acc[q][m]);
      }
    }
#pragma unroll
    for (int q = 0; q < S1::rows; ++q)
#pragma unroll
      for (int m = 0; m < S1::cols; ++m) {
        const int k = c1 + S1::lanes * m;
        const Acc pre = acc[q][m] + to_acc(b1s[k]);
        // the hidden activation in x's dtype before the second product
        as[(wr + g1 + S1::groups * q) * kAs + k] = to_acc(from_acc<T, Acc>(lipswish(pre)));
      }
  }
  __syncwarp();
  // layer 2: out = a·W2 + b2 for rows wr + g2 + groups·q, columns c2 + lanes·m
  const int g2 = lane / S2::lanes, c2 = lane % S2::lanes;
  Acc acc[S2::rows][S2::cols];
#pragma unroll
  for (int q = 0; q < S2::rows; ++q)
#pragma unroll
    for (int m = 0; m < S2::cols; ++m) acc[q][m] = static_cast<Acc>(0);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    Acc w[S2::cols];
#pragma unroll
    for (int m = 0; m < S2::cols; ++m) w[m] = to_acc(w2s[k * DOUT + c2 + S2::lanes * m]);
#pragma unroll
    for (int q = 0; q < S2::rows; ++q) {
      const Acc av = as[(wr + g2 + S2::groups * q) * kAs + k];
#pragma unroll
      for (int m = 0; m < S2::cols; ++m) acc[q][m] = fma_rn(av, w[m], acc[q][m]);
    }
  }
#pragma unroll
  for (int q = 0; q < S2::rows; ++q) {
    const int r = wr + g2 + S2::groups * q;
    if (r < nr) {
#pragma unroll
      for (int m = 0; m < S2::cols; ++m) {
        const int j = c2 + S2::lanes * m;
        out[(row0 + r) * DOUT + j] = from_acc<T, Acc>(acc[q][m] + to_acc(b2s[j]));
      }
    }
  }
}

// 1 when (Din, H, Dout) has a fixed instantiation.
inline bool fixed_width(int din, int hidden, int dout) {
#define REPRO_MLP_IS(a, b, c) if (din == a && hidden == b && dout == c) return true;
  REPRO_MLP_FIXED_WIDTHS(REPRO_MLP_IS)
#undef REPRO_MLP_IS
  return false;
}

template <typename T, typename Acc>
cudaError_t launch_fixed(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, T* out,
                         int64_t rows, int din, int hidden, int dout, cudaStream_t stream) {
  const int64_t blocks = (rows + kFixedRows - 1) / kFixedRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
#define REPRO_MLP_LAUNCH(a, b, c)                                                       \
  if (din == a && hidden == b && dout == c) {                                           \
    fused_mlp_fixed<T, Acc, a, b, c><<<grid, kFixedThreads, 0, stream>>>(x, w1, b1, w2, \
                                                                         b2, out, rows); \
    return cudaGetLastError();                                                          \
  }
  REPRO_MLP_FIXED_WIDTHS(REPRO_MLP_LAUNCH)
#undef REPRO_MLP_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T, typename Acc>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int64_t rows, int din, int hidden, int dout,
                   cudaStream_t stream) {
  const T* px = static_cast<const T*>(x);
  const T* pw1 = static_cast<const T*>(w1);
  const T* pb1 = static_cast<const T*>(b1);
  const T* pw2 = static_cast<const T*>(w2);
  const T* pb2 = static_cast<const T*>(b2);
  T* po = static_cast<T*>(out);
  if (fixed_width(din, hidden, dout))
    return launch_fixed<T, Acc>(px, pw1, pb1, pw2, pb2, po, rows, din, hidden, dout, stream);
  int tile = kRowsMax;
  while (tile > 1 && static_cast<int64_t>(tile) * (din + hidden) * sizeof(Acc) > kSmemBytes)
    tile /= 2;
  const int64_t tile_bytes = static_cast<int64_t>(tile) * (din + hidden) * sizeof(Acc);
  if (tile_bytes > kSmemBytes) return cudaErrorInvalidValue;
  const int64_t weight_bytes =
      (static_cast<int64_t>(din) * hidden + static_cast<int64_t>(hidden) * dout + hidden +
       dout) * sizeof(T);
  const bool staged = tile_bytes + weight_bytes <= kSmemBytes;
  const int64_t blocks = (rows + tile - 1) / tile;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (staged) {
    fused_mlp_kernel<T, Acc, true><<<grid, kThreads, tile_bytes + weight_bytes, stream>>>(
        px, pw1, pb1, pw2, pb2, po, rows, din, hidden, dout, tile);
  } else {
    fused_mlp_kernel<T, Acc, false><<<grid, kThreads, tile_bytes, stream>>>(
        px, pw1, pb1, pw2, pb2, po, rows, din, hidden, dout, tile);
  }
  return cudaGetLastError();
}

// ---- backward ------------------------------------------------------------

namespace cg = cooperative_groups;
namespace tc = repro_torch_tc;

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCluster = 16;       // blocks a launch: one cluster (non-portable size)
constexpr int kBwdTileMax = 128;   // rows a tile, at most
constexpr int kChunk = 64;         // depth of one tensor-core sum before it is added (RN) on
constexpr int64_t kBwdSmemMax = 227 * 1024;  // dynamic shared memory a block may opt in to
constexpr int kBarBytes = 16;      // the mbarrier's slot at the start of shared memory
constexpr int kMaxDevices = 64;    // devices whose launch attributes are remembered

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// row strides (elements): ≡ 8 mod 16 for operands read along k across the
// warp's lanes (the sums over rows), ≡ 4 mod 8 for those read along m
__host__ __device__ constexpr int stride8(int c) { return c % 16 == 8 ? c : c + 8; }
__host__ __device__ constexpr int stride4(int c) { return c % 8 == 4 ? c : c + 4; }

// σ(p) in the backward: float32 (and bfloat16's float32) on the MUFU
// (ex2.approx and rcp.approx, a few ulp: the gradients' tolerance is 2e-5,
// and nothing asks these bits to equal the forward's); float64 IEEE.
__device__ __forceinline__ float sigmoid_bwd(float p) {
  return __fdividef(1.0f, 1.0f + __expf(-p));
}
__device__ __forceinline__ double sigmoid_bwd(double p) { return 1.0 / (1.0 + exp(-p)); }

// Split-TF32 m16n8k8 products, for float32 and for bfloat16 widened to
// float32.  product(d, a, b, k0, k1): d = A[0:16, k0:k1) · B[k0:k1, 0:8)
// from zero, the three split products (small·big, big·small, big·big) in
// three accumulators, so that the chains of dependent MMAs are a third as
// long, added at the end as big + (the two small ones).
struct MmaF32 {
  using Acc = float;
  static constexpr int M = 16, K = 8, C = 4;  // N = 8
  __device__ static int row(int lane, int q) { return (lane >> 2) + 8 * (q >> 1); }
  __device__ static int col(int lane, int q) { return 2 * (lane & 3) + (q & 1); }
  template <class FA, class FB>
  __device__ static void product(float (&d)[4], const FA& a, const FB& b, int k0, int k1,
                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, bs[4] = {0.f, 0.f, 0.f, 0.f};
    float bb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = k0; k < k1; k += K) {
      tc::Split4 A;
      tc::Split2 B;
      tc::split_tf32(a(g, k + t), A.big[0], A.small[0]);
      tc::split_tf32(a(g + 8, k + t), A.big[1], A.small[1]);
      tc::split_tf32(a(g, k + t + 4), A.big[2], A.small[2]);
      tc::split_tf32(a(g + 8, k + t + 4), A.big[3], A.small[3]);
      tc::split_tf32(b(k + t, g), B.big[0], B.small[0]);
      tc::split_tf32(b(k + t + 4, g), B.big[1], B.small[1]);
      tc::mma_tf32(sb, A.small, B.big[0], B.big[1]);
      tc::mma_tf32(bs, A.big, B.small[0], B.small[1]);
      tc::mma_tf32(bb, A.big, B.big[0], B.big[1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = bb[q] + (sb[q] + bs[q]);
  }
};

// DMMA m8n8k4 products for float64: d = A[0:8, k0:k1) · B[k0:k1, 0:8).
struct MmaF64 {
  using Acc = double;
  static constexpr int M = 8, K = 4, C = 2;  // N = 8
  __device__ static int row(int lane, int) { return lane >> 2; }
  __device__ static int col(int lane, int q) { return 2 * (lane & 3) + q; }
  template <class FA, class FB>
  __device__ static void product(double (&d)[2], const FA& a, const FB& b, int k0, int k1,
                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
    d[0] = d[1] = 0.0;
#pragma unroll 2
    for (int k = k0; k < k1; k += K) tc::mma_f64(d, a(g, k + t), b(k + t, g));
  }
};

template <typename T> struct MmaFor { using type = MmaF32; };
template <> struct MmaFor<double> { using type = MmaF64; };

// c = A[0:M, 0:kend) · B[0:kend, 0:8) for one warp's output tile: a fresh
// tensor-core sum per kChunk of depth, the chunks added in ascending order
// with IEEE adds (the tensor core's own sums are short).  a(m, k) and b(k,
// n) read the operands (m, n relative to the tile).
template <class Mma, class FA, class FB>
__device__ __forceinline__ void warp_product(typename Mma::Acc (&c)[Mma::C], const FA& a,
                                             const FB& b, int kend, int lane) {
  for (int k0 = 0; k0 < kend; k0 += kChunk) {
    typename Mma::Acc d[Mma::C];
    Mma::product(d, a, b, k0, k0 + kChunk < kend ? k0 + kChunk : kend, lane);
#pragma unroll
    for (int q = 0; q < Mma::C; ++q) c[q] = k0 == 0 ? d[q] : c[q] + d[q];
  }
}

// One warp's output tile, returned in registers.
template <class Mma> struct Frag { typename Mma::Acc v[Mma::C]; };

__device__ __forceinline__ float ld_shared(uint32_t addr, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ double ld_shared(uint32_t addr, double) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
  return v;
}

// warp_product with both operands in shared memory: element (m, k) of A at
// byte a + m·am + k·ak, (k, n) of B at b + k·bk + n·bn (32-bit shared
// addresses: ld.shared, no generic-address resolution).
template <class Mma>
__device__ __forceinline__ Frag<Mma> smem_product(uint32_t a, int am, int ak, uint32_t b, int bk,
                                               int bn, int kend) {
  using Acc = typename Mma::Acc;
  Frag<Mma> c;
  warp_product<Mma>(c.v, [=](int m, int k) { return ld_shared(a + m * am + k * ak, Acc()); },
                    [=](int k, int n) { return ld_shared(b + k * bk + n * bn, Acc()); }, kend,
                    threadIdx.x & 31);
  return c;
}

// The same with B in global memory (k, n at b[k·bk + n·bn], zero beyond
// kmax, nmax): the weights where they do not fit in shared memory.
template <class Mma, typename T>
__device__ __forceinline__ Frag<Mma> global_b_product(uint32_t a, int am, int ak, const T* b,
                                                   int64_t bk, int64_t bn, int kmax, int nmax,
                                                   int kend) {
  using Acc = typename Mma::Acc;
  Frag<Mma> c;
  warp_product<Mma>(c.v, [=](int m, int k) { return ld_shared(a + m * am + k * ak, Acc()); },
                    [=](int k, int n) { return k < kmax && n < nmax ? load(b + k * bk + n * bn)
                                                                    : Acc(0); },
                    kend, threadIdx.x & 31);
  return c;
}

// Padded sizes and row strides (elements) of the backward's shared-memory
// operands, a function of the widths and the dtype's MMA shape.
struct BwdDims {
  int xc, gc, ac, dc;  // tile columns: [x | 1], g, [a | 1], dpre
  int sx, sg, sa, sd;  // their row strides
  int w1r, w1c, sw1;   // W1 (Din × H) staged: rows, columns, stride
  int w2r, w2c, sw2;   // W2 (H × Dout)
  int b1n;
  int64_t pe;          // dW1, db1, dW2, db2 elements: the sums over rows
  int64_t slice;       // elements of the sums a block reduces, at most
  int64_t row_elems;   // a tile row of all four tile operands
  int64_t fixed_elems; // the staged weights, the block's sums, the received sums
};

template <class Mma>
__host__ __device__ inline BwdDims bwd_dims(int din, int hidden, int dout) {
  BwdDims d{};
  d.xc = round_up(din + 1, 8);      // the N of dW1ᵀ|db1 (ones at column Din)
  d.gc = round_up(dout, Mma::M);    // the M of dW2ᵀ|db2
  d.ac = round_up(hidden + 1, 8);   // the N of dW2ᵀ|db2 (ones at column H)
  d.dc = round_up(hidden, Mma::M);  // the M of dW1ᵀ|db1
  d.sx = stride8(d.xc);
  d.sg = stride8(d.gc);
  d.sa = stride8(d.ac);
  d.sd = stride8(d.dc);
  d.w1r = round_up(din + 1, 8);
  d.w1c = round_up(hidden, 8);
  d.sw1 = stride8(d.w1c);
  d.w2r = round_up(hidden, 8);
  d.w2c = round_up(dout, Mma::K);
  d.sw2 = stride4(d.w2c);
  d.b1n = round_up(hidden, 8);
  d.pe = static_cast<int64_t>(din) * hidden + hidden + static_cast<int64_t>(hidden) * dout +
         dout;
  d.slice = (d.pe + kCluster - 1) / kCluster;
  d.row_elems = d.sx + d.sg + d.sa + d.sd;
  d.fixed_elems = static_cast<int64_t>(d.w1r) * d.sw1 + static_cast<int64_t>(d.w2r) * d.sw2 +
                  d.b1n + d.pe + kCluster * d.slice;
  return d;
}

// The launch plan of one backward, a function of (dtype, R, widths) alone,
// so that the sums over rows (dW, db) depend on R and on nothing else.
struct BwdPlan {
  int blocks;               // kCluster, or 0 for widths a block cannot take
  int tile;                 // rows a tile
  int64_t tiles;            // ceil(R / tile)
  int64_t tiles_per_block;  // consecutive tiles a block owns
  bool smem;                // weights and sums in shared memory (else global partials)
  int64_t smem_bytes;       // dynamic shared memory a block
  int64_t partial_bytes;    // the global partials where the sums do not fit
};

// tile: ceil(R / kCluster) rows rounded up to the MMA's M, at most
// kBwdTileMax, shrunk until the tile operands, the staged weights, the
// block's sums and the sums it receives fit in kBwdSmemMax; where even one
// M of rows does not fit with them, the weights are read through L1/L2 and
// the sums kept in a global partial a block, and the tile shrinks until its
// operands fit.
template <class Mma>
BwdPlan plan_bwd(int64_t rows, int din, int hidden, int dout) {
  BwdPlan p{};
  if (rows <= 0 || din <= 0 || hidden <= 0 || dout <= 0) return p;
  const BwdDims d = bwd_dims<Mma>(din, hidden, dout);
  const int64_t es = sizeof(typename Mma::Acc);
  const int64_t row = d.row_elems * es, fixed = kBarBytes + d.fixed_elems * es;
  const int64_t want = (rows + kCluster - 1) / kCluster;
  int tile = static_cast<int>(want < kBwdTileMax ? round_up(static_cast<int>(want), Mma::M)
                                                 : kBwdTileMax);
  p.smem = Mma::M * row + fixed <= kBwdSmemMax;
  const int64_t extra = p.smem ? fixed : 0;
  while (tile > Mma::M && tile * row + extra > kBwdSmemMax) tile -= Mma::M;
  if (tile * row + extra > kBwdSmemMax) return BwdPlan{};
  p.blocks = kCluster;
  p.tile = tile;
  p.smem_bytes = tile * row + extra;
  p.tiles = (rows + tile - 1) / tile;
  if (p.tiles > 0x7fffffff) return BwdPlan{};
  p.tiles_per_block = (p.tiles + kCluster - 1) / kCluster;
  p.partial_bytes = p.smem ? 0 : kCluster * d.pe * es;
  return p;
}

// rows × cols of dst (row stride `stride`) from one warp a row: the block
// drows × dcols copied from src (row and column strides; float32 and
// float64 by cp.async, an element a copy, issued and not waited for;
// bfloat16 widened to float32 through registers), the rest zero but column
// `one`, which is one.
template <typename T, typename Acc>
__device__ __forceinline__ void stage(Acc* dst, int stride, int rows, int cols, const T* src,
                                      int64_t src_rs, int64_t src_cs, int drows, int dcols,
                                      int one) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r = warp; r < rows; r += kBwdWarps) {
#pragma unroll 1
    for (int c = lane; c < cols; c += 32) {
      Acc* d = dst + r * stride + c;
      if (r < drows && c < dcols) {
        const T* s = src + r * src_rs + c * src_cs;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          *d = __bfloat162float(*s);
        } else {
          tc::cp_async_elem<sizeof(T)>(tc::smem_addr(d), s);
        }
      } else {
        *d = c == one ? Acc(1) : Acc(0);
      }
    }
  }
}

// Columns [c0, c1) of rows × · of dst: zero but column `one`, which is one.
template <typename Acc>
__device__ __forceinline__ void pad_cols(Acc* dst, int stride, int rows, int c0, int c1,
                                         int one) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r = warp; r < rows; r += kBwdWarps)
#pragma unroll 1
    for (int c = c0 + lane; c < c1; c += 32) dst[r * stride + c] = c == one ? Acc(1) : Acc(0);
}

// One backward: dx (R, Din), dW1, db1, dW2, db2 from x, W1, b1, W2 and the
// cotangent g (R, Dout; row and column strides given), by one cluster of
// kCluster blocks.  Block `rank` owns tiles [rank·tpb, (rank+1)·tpb) of
// `tile` rows.  Per tile, on the tensor cores, each warp an output tile of
// M × 8 at a time:
//   1. pre = x·W1 and da = g·W2ᵀ (separate warps), then a (rounded to T)
//      and dpre, one thread an element;
//   2. dW1ᵀ|db1 += dpreᵀ·[x | 1] and dW2ᵀ|db2 += gᵀ·[a | 1] (the sums over
//      the tile's rows, added to the block's running sums), and dx =
//      dpre·W1ᵀ straight to global memory.
// After its last tile a block sends each of its sums e to block e mod
// kCluster, into that block's shared memory (st.async counted on its
// mbarrier); block r waits for its slice from every block with rows and
// adds them in ascending rank.  Where the sums do not fit in shared memory
// they go to global partials, read after a cluster barrier instead.
template <typename T, class Mma, bool kSmem>
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ g, int64_t g_rs, int64_t g_cs,
                     T* __restrict__ dx, T* __restrict__ dw1, T* __restrict__ db1,
                     T* __restrict__ dw2, T* __restrict__ db2,
                     typename Mma::Acc* __restrict__ partials, int64_t rows, int din,
                     int hidden, int dout, int tile, int tiles_per_block, int tiles) {
  using Acc = typename Mma::Acc;
  constexpr int M = Mma::M;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const BwdDims d = bwd_dims<Mma>(din, hidden, dout);
  extern __shared__ __align__(16) unsigned char smem_b[];
  const uint32_t bar = tc::smem_addr(smem_b);  // the sums from the other blocks arrive
  Acc* xs = reinterpret_cast<Acc*>(smem_b + (kSmem ? kBarBytes : 0));  // tile × [x | 1]
  Acc* gs = xs + tile * d.sx;                // tile × g
  Acc* as = gs + tile * d.sg;                // tile × [pre → a | 1], a rounded to T
  Acc* ds = as + tile * d.sa;                // tile × (da → dpre)
  Acc* w1s = ds + tile * d.sd;               // staged weights (kSmem)
  Acc* w2s = w1s + d.w1r * d.sw1;
  Acc* b1s = w2s + d.w2r * d.sw2;
  Acc* acc = kSmem ? b1s + d.b1n : partials + rank * d.pe;  // dW1 | db1 | dW2 | db2
  Acc* recv = acc + d.pe;                    // kCluster × slice received sums (kSmem)
  const int64_t n_w1 = static_cast<int64_t>(din) * hidden;
  const int64_t n_w2 = static_cast<int64_t>(hidden) * dout;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = rank * tiles_per_block;  // my tiles: t0 .. t0 + mine - 1
  const int mine = tiles - t0 < 0 ? 0 : (tiles - t0 < tiles_per_block ? tiles - t0
                                                                      : tiles_per_block);
  // blocks with rows: 0 .. active - 1 (tiles_per_block · (active - 1) < tiles)
  int active = 1;
  while (active < kCluster && active * tiles_per_block < tiles) ++active;
  // my slice: elements e ≡ rank (mod kCluster), at j = e / kCluster
  const int64_t mine_e = d.pe > rank ? (d.pe - rank + kCluster - 1) / kCluster : 0;
  auto tile_rows = [&](int t) {
    const int64_t left = rows - static_cast<int64_t>(t0 + t) * tile;
    return static_cast<int>(left < tile ? left : tile);
  };
  const auto load_tile = [&](int t, int nr) {  // x and g of tile t, and their padding
    const int64_t row0 = static_cast<int64_t>(t0 + t) * tile;
    stage(xs, d.sx, tile, d.xc, x + row0 * din, din, 1, nr, din, din);
    stage(gs, d.sg, tile, d.gc, g + row0 * g_rs, g_rs, g_cs, nr, dout, -1);
  };
  if (kSmem && tid == 0) {
    tc::mbar_init(bar, 1);
    tc::fence_mbar_init();
    tc::mbar_expect_tx(bar, static_cast<uint32_t>(active * mine_e * sizeof(Acc)));
  }
  tc::cluster_arrive_relaxed();  // my barrier is ready for the other blocks

  // everything issued before any arithmetic (the weights, the first
  // tile's x and g, the padding: zeros, and the ones columns that make db1
  // and db2 columns of the products), then one wait
  if (mine > 0) {
    if (kSmem) {
      stage(w1s, d.sw1, d.w1r, d.w1c, w1, hidden, 1, din, hidden, -1);
      stage(w2s, d.sw2, d.w2r, d.w2c, w2, dout, 1, hidden, dout, -1);
      stage(b1s, 0, 1, d.b1n, b1, 0, 1, 1, hidden, -1);
    }
    load_tile(0, tile_rows(0));
    pad_cols(as, d.sa, tile, hidden, d.ac, hidden);
    pad_cols(ds, d.sd, tile, hidden, d.dc, -1);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  tc::cluster_wait();  // every block's barrier is ready: sums may be sent

  for (int t = 0; t < mine; ++t) {
    const int64_t row0 = static_cast<int64_t>(t0 + t) * tile;
    const int nr = tile_rows(t);
    if (t > 0) {
      __syncthreads();  // the last tile's products are done with xs and gs
      load_tile(t, nr);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    const int mt = (nr + M - 1) / M;  // row tiles with rows of this tile

    // 1. pre = x·W1 into as, da = g·W2ᵀ into ds: a warp an output tile
    const int nt1 = d.w1c / 8;
    for (int job = warp; job < 2 * mt * nt1; job += kBwdWarps) {
      const bool is_pre = job < mt * nt1;
      const int jj = is_pre ? job : job - mt * nt1;
      const int m0 = (jj / nt1) * M, n0 = (jj % nt1) * 8;
      const int es = sizeof(Acc);
      Frag<Mma> c;
      if (is_pre) {  // A = x, B = W1
        const uint32_t a = tc::smem_addr(xs + m0 * d.sx);
        c = kSmem ? smem_product<Mma>(a, d.sx * es, es, tc::smem_addr(w1s + n0), d.sw1 * es, es,
                                      round_up(din, Mma::K))
                  : global_b_product<Mma>(a, d.sx * es, es, w1 + n0, hidden, 1, din,
                                          hidden - n0, round_up(din, Mma::K));
      } else {  // A = g, B = W2ᵀ
        const uint32_t a = tc::smem_addr(gs + m0 * d.sg);
        c = kSmem ? smem_product<Mma>(a, d.sg * es, es, tc::smem_addr(w2s + n0 * d.sw2), es,
                                      d.sw2 * es, d.w2c)
                  : global_b_product<Mma>(a, d.sg * es, es, w2 + static_cast<int64_t>(n0) * dout,
                                          1, dout, dout, hidden - n0, d.w2c);
      }
      Acc* out = is_pre ? as : ds;
      const int so = is_pre ? d.sa : d.sd;
#pragma unroll
      for (int q = 0; q < Mma::C; ++q) {
        const int r = m0 + Mma::row(lane, q), h = n0 + Mma::col(lane, q);
        if (h < hidden) out[r * so + h] = c.v[q];
      }
    }
    __syncthreads();
    // a and dpre, a thread an element
    for (int r = warp; r < mt * M; r += kBwdWarps) {
      for (int h = lane; h < hidden; h += 32) {
        const Acc p = as[r * d.sa + h] + (kSmem ? b1s[h] : load(b1 + h));
        const Acc one = static_cast<Acc>(1.0);
        const Acc sg = sigmoid_bwd(p);
        const Acc ps = p * sg;
        as[r * d.sa + h] = to_acc(from_acc<T, Acc>(static_cast<Acc>(0.909) * ps));
        ds[r * d.sd + h] = ds[r * d.sd + h] * (static_cast<Acc>(0.909) * (sg + ps * (one - sg)));
      }
    }
    __syncthreads();

    // 2. the sums over the tile's rows (rows nr .. kr - 1 are zero) and dx;
    // after the last tile each sum goes to the block that reduces it
    const bool last = t == mine - 1;
    const auto add = [&](int64_t e, Acc v) {
      if (t > 0) v = acc[e] + v;
      if (!last) {
        acc[e] = v;
      } else if constexpr (kSmem) {
        const int q = static_cast<int>(e % kCluster);
        const uint32_t local = tc::smem_addr(recv + rank * d.slice + e / kCluster);
        tc::st_async(tc::cluster_addr(local, q), v, tc::cluster_addr(bar, q));
      } else {
        acc[e] = v;
      }
    };
    const int kr = round_up(nr, Mma::K);
    const int nt_w1 = d.xc / 8, nt_w2 = d.ac / 8, nt_dx = round_up(din, 8) / 8;
    const int j1 = (d.dc / M) * nt_w1, j2 = (d.gc / M) * nt_w2, j3 = mt * nt_dx;
    const int es = sizeof(Acc);
    for (int job = warp; job < j1 + j2 + j3; job += kBwdWarps) {
      if (job < j1) {  // dW1ᵀ | db1 = dpreᵀ · [x | 1]
        const int m0 = (job / nt_w1) * M, n0 = (job % nt_w1) * 8;
        const Frag<Mma> c = smem_product<Mma>(tc::smem_addr(ds + m0), es, d.sd * es,
                                              tc::smem_addr(xs + n0), d.sx * es, es, kr);
#pragma unroll
        for (int q = 0; q < Mma::C; ++q) {
          const int h = m0 + Mma::row(lane, q), i = n0 + Mma::col(lane, q);
          if (h < hidden && i <= din)
            add(i < din ? static_cast<int64_t>(i) * hidden + h : n_w1 + h, c.v[q]);
        }
      } else if (job < j1 + j2) {  // dW2ᵀ | db2 = gᵀ · [a | 1]
        const int jj = job - j1;
        const int m0 = (jj / nt_w2) * M, n0 = (jj % nt_w2) * 8;
        const Frag<Mma> c = smem_product<Mma>(tc::smem_addr(gs + m0), es, d.sg * es,
                                              tc::smem_addr(as + n0), d.sa * es, es, kr);
#pragma unroll
        for (int q = 0; q < Mma::C; ++q) {
          const int j = m0 + Mma::row(lane, q), h = n0 + Mma::col(lane, q);
          if (j < dout && h <= hidden)
            add(n_w1 + hidden + (h < hidden ? static_cast<int64_t>(h) * dout + j : n_w2 + j),
                c.v[q]);
        }
      } else {  // dx = dpre · W1ᵀ
        const int jj = job - j1 - j2;
        const int m0 = (jj / nt_dx) * M, n0 = (jj % nt_dx) * 8;
        const uint32_t a = tc::smem_addr(ds + m0 * d.sd);
        const Frag<Mma> c =
            kSmem ? smem_product<Mma>(a, d.sd * es, es, tc::smem_addr(w1s + n0 * d.sw1), es,
                                      d.sw1 * es, round_up(hidden, Mma::K))
                  : global_b_product<Mma>(a, d.sd * es, es,
                                          w1 + static_cast<int64_t>(n0) * hidden, 1, hidden,
                                          hidden, din - n0, round_up(hidden, Mma::K));
#pragma unroll
        for (int q = 0; q < Mma::C; ++q) {
          const int r = m0 + Mma::row(lane, q), i = n0 + Mma::col(lane, q);
          if (r < nr && i < din) dx[(row0 + r) * din + i] = from_acc<T, Acc>(c.v[q]);
        }
      }
    }
  }

  // -- the cluster reduction --
  // block r adds the sums e ≡ r (mod kCluster) of blocks 0, 1, ..,
  // active - 1 in ascending order
  if constexpr (kSmem) {
    tc::mbar_wait(bar, 0);  // every block's slice for me has arrived
  } else {
    cluster.sync();  // every block's partial is written (release / acquire)
  }
  for (int64_t j = tid; j < mine_e; j += kBwdThreads) {
    const int64_t e = j * kCluster + rank;
    Acc v[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      if (q >= active) break;
      if constexpr (kSmem) {
        v[q] = recv[q * d.slice + j];
      } else {
        v[q] = __ldcg(partials + q * d.pe + e);
      }
    }
    Acc s = v[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) {
      if (q >= active) break;
      s = s + v[q];
    }
    const T o = from_acc<T, Acc>(s);
    if (e < n_w1) dw1[e] = o;
    else if (e < n_w1 + hidden) db1[e - n_w1] = o;
    else if (e < n_w1 + hidden + n_w2) dw2[e - n_w1 - hidden] = o;
    else db2[e - n_w1 - hidden - n_w2] = o;
  }
}

// The launch configuration of one backward: one cluster of kCluster blocks
// (a non-portable size, allowed once a device), and the shared memory
// opted in to above the static 48 KB as far as a launch needs it.
template <typename T, bool kSmem>
cudaError_t bwd_config(const BwdPlan& p, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                       cudaLaunchAttribute& attr) {
  const auto kernel = fused_mlp_bwd_kernel<T, typename MmaFor<T>::type, kSmem>;
  static int64_t opted[kMaxDevices] = {};  // 0: not prepared; else the smem opted in to
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || opted[dev] < p.smem_bytes || opted[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int64_t bytes = p.smem_bytes > 48 * 1024 ? p.smem_bytes : 48 * 1024;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = bytes;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem_bytes);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, bool kSmem>
cudaError_t launch_bwd_kernel(const BwdPlan& p, const T* x, const T* w1, const T* b1,
                              const T* w2, const T* g, int64_t g_rs, int64_t g_cs, T* dx,
                              T* dw1, T* db1, T* dw2, T* db2, void* partials, int64_t rows,
                              int din, int hidden, int dout, cudaStream_t stream) {
  using Mma = typename MmaFor<T>::type;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_config<T, kSmem>(p, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fused_mlp_bwd_kernel<T, Mma, kSmem>, x, w1, b1, w2, g, g_rs,
                           g_cs, dx, dw1, db1, dw2, db2,
                           static_cast<typename Mma::Acc*>(partials), rows, din, hidden, dout,
                           p.tile, static_cast<int>(p.tiles_per_block),
                           static_cast<int>(p.tiles));
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* g, int64_t g_rs, int64_t g_cs, void* dx, void* dw1,
                       void* db1, void* dw2, void* db2, void* partials, int64_t partial_bytes,
                       int64_t rows, int din, int hidden, int dout, cudaStream_t stream) {
  const BwdPlan p = plan_bwd<typename MmaFor<T>::type>(rows, din, hidden, dout);
  if (p.blocks <= 0 || (p.partial_bytes > 0 && (partials == nullptr ||
                                                 partial_bytes < p.partial_bytes)))
    return cudaErrorInvalidValue;
  const auto args = [&](auto launch) {
    return launch(p, static_cast<const T*>(x), static_cast<const T*>(w1),
                  static_cast<const T*>(b1), static_cast<const T*>(w2),
                  static_cast<const T*>(g), g_rs, g_cs, static_cast<T*>(dx),
                  static_cast<T*>(dw1), static_cast<T*>(db1), static_cast<T*>(dw2),
                  static_cast<T*>(db2), partials, rows, din, hidden, dout, stream);
  };
  return p.smem ? args(launch_bwd_kernel<T, true>) : args(launch_bwd_kernel<T, false>);
}

// The most clusters of the backward's launch for (dtype, R, widths) that
// the card can hold at once (cudaOccupancyMaxActiveClusters); 0 means the
// launch cannot be scheduled.
template <typename T>
int64_t bwd_clusters(int64_t rows, int din, int hidden, int dout) {
  const BwdPlan p = plan_bwd<typename MmaFor<T>::type>(rows, din, hidden, dout);
  if (p.blocks <= 0) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err;
  if (p.smem) {
    err = bwd_config<T, true>(p, nullptr, cfg, attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, fused_mlp_bwd_kernel<T, typename MmaFor<T>::type, true>, &cfg);
  } else {
    err = bwd_config<T, false>(p, nullptr, cfg, attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, fused_mlp_bwd_kernel<T, typename MmaFor<T>::type, false>, &cfg);
  }
  return err == cudaSuccess ? n : -static_cast<int64_t>(err);
}

// The backward's plan for a dtype code (blocks 0 for a dtype or width it
// does not take).
inline BwdPlan plan_for(int dtype, int64_t rows, int din, int hidden, int dout) {
  if (dtype == 0 || dtype == 1) return plan_bwd<MmaF32>(rows, din, hidden, dout);
  if (dtype == 2) return plan_bwd<MmaF64>(rows, din, hidden, dout);
  return BwdPlan{};
}

}  // namespace repro_torch_mlp

extern "C" int rt_fused_mlp(int dtype, const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int64_t rows, int din,
                            int hidden, int dout, void* stream) {
  using namespace repro_torch_mlp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaGetLastError();
  if (rows < 0 || din <= 0 || hidden <= 0 || dout <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, float>(x, w1, b1, w2, b2, out, rows, din, hidden, dout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float>(x, w1, b1, w2, b2, out, rows, din, hidden, dout, s);
  if (dtype == 2) return launch<double, double>(x, w1, b1, w2, b2, out, rows, din, hidden, dout, s);
  return cudaErrorInvalidValue;
}

// The backward's plan for (dtype, R, widths) into out[6]: blocks (the
// cluster), rows a tile, tiles a block, whether the weights and the sums
// sit in shared memory (1) or the sums in global partials (0), the dynamic
// shared memory a block, and the bytes of the partials the caller must
// pass (0 when the sums sit in shared memory).  Returns
// cudaErrorInvalidValue for a dtype or width it does not take.
extern "C" int rt_fused_mlp_bwd_plan(int dtype, int64_t rows, int din, int hidden, int dout,
                                     int64_t* out) {
  const auto p = repro_torch_mlp::plan_for(dtype, rows, din, hidden, dout);
  out[0] = p.blocks;
  out[1] = p.tile;
  out[2] = p.tiles_per_block;
  out[3] = p.smem ? 1 : 0;
  out[4] = p.smem_bytes;
  out[5] = p.partial_bytes;
  return p.blocks > 0 ? 0 : cudaErrorInvalidValue;
}

// The most clusters of the backward's launch for (dtype, R, widths) the
// card holds at once (cudaOccupancyMaxActiveClusters: 0 = it cannot be
// scheduled), or minus a CUDA error code.
extern "C" int64_t rt_fused_mlp_bwd_clusters(int dtype, int64_t rows, int din, int hidden,
                                             int dout) {
  using namespace repro_torch_mlp;
  if (dtype == 0) return bwd_clusters<float>(rows, din, hidden, dout);
  if (dtype == 1) return bwd_clusters<__nv_bfloat16>(rows, din, hidden, dout);
  if (dtype == 2) return bwd_clusters<double>(rows, din, hidden, dout);
  return -static_cast<int64_t>(cudaErrorInvalidValue);
}

extern "C" int rt_fused_mlp_bwd(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* g, int64_t g_rs, int64_t g_cs,
                                void* dx, void* dw1, void* db1, void* dw2, void* db2,
                                void* partials, int64_t partial_bytes, int64_t rows, int din,
                                int hidden, int dout, void* stream) {
  using namespace repro_torch_mlp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || din <= 0 || hidden <= 0 || dout <= 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2, db2, partials,
                             partial_bytes, rows, din, hidden, dout, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2, db2,
                                     partials, partial_bytes, rows, din, hidden, dout, s);
  if (dtype == 2)
    return launch_bwd<double>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2, db2, partials,
                              partial_bytes, rows, din, hidden, dout, s);
  return cudaErrorInvalidValue;
}
