// The SDE vector-field MLP, Linear -> LipSwish -> Linear, in one launch, for
// Hopper.
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
// Design.  The SDE widths are tiny (Din 4–33, H 32–64, Dout 16–64), so the
// kernel is launch-bound, and the simple form is enough: a block of 128
// threads owns up to 8 rows.  It stages the weights and biases in shared
// memory (the largest field, the 32→64→32 burst, is 16 KB in f32 and 33 KB in
// f64) together with the row tile of x and of a, converted to the
// accumulator type; then two barrier-separated passes: thread e computes
// pre/a for (row e / H, unit e % H), then out for (row e / Dout, column e %
// Dout).  Neighbouring threads read neighbouring weight columns (distinct
// banks) and one broadcast row of x or a, and write neighbouring outputs.
// Where the weights and the tile do not fit in 48 KB of shared memory
// together (widths up to 512 in f32 and f64), the weights are read through
// L1/L2 (__ldg) with the same per-row order; the row tile shrinks to fit
// when (Din + H) is large.  Tensor cores (mma.sync on bf16 or TF32 tiles)
// and a persistent block per SM are later work.
//
// Bound.  At the training state (R = 1024, 17 -> 32 -> 16, f32) the kernel
// reads 69.6 KB of x and 4.4 KB of weights and writes 65.5 KB: 0.042 µs at
// 3.35 TB/s, so it is bound by bytes; its 2R(Din·H + H·Dout) + 6R·H
// (LipSwish) + R(H + Dout) flops, 2.41 MFLOP, take 0.036 µs at 67 TFLOP/s.
// Both are far below the ~2–3 µs a launch costs, so launches are what
// count: one here against the ~16 device kernels of the unfused chain.
//
// Interface: a plain C function (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16, 2 = float64; x, W1, b1, W2, b2 and
// out contiguous in one dtype, W (in, out) row-major as the reference's
// pytree holds them.  It launches on the given stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a dtype or width it does
// not take.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, typename Acc>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int64_t rows, int din, int hidden, int dout,
                   cudaStream_t stream) {
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
  const T* px = static_cast<const T*>(x);
  const T* pw1 = static_cast<const T*>(w1);
  const T* pb1 = static_cast<const T*>(b1);
  const T* pw2 = static_cast<const T*>(w2);
  const T* pb2 = static_cast<const T*>(b2);
  T* po = static_cast<T*>(out);
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
