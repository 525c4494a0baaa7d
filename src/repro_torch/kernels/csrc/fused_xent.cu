// The LM loss: per-token softmax cross entropy, forward and backward, for
// Hopper.
//
// Replaces the Pallas kernel fused_xent of the JAX package:
//   src/repro/kernels/xent.py:56 (kernel body :27-53, pallas_call :70)
// and computes the function of src/repro/kernels/ref.py:218 for logits
// x (R, V) in f32 or bf16 and int32 labels (R,):
//   forward:  lse_r = log Σ_v exp(x_rv),   loss_r = lse_r − x[r, label_r]
//   backward: dx_rv = g_r · (exp(x_rv − lse_r) − [v == label_r])
// All arithmetic is f32; loss and lse are f32, dx is in x's dtype.  A label
// in [−V, 0) counts from the end and one outside [−V, V) gives a NaN loss,
// as the reference's gather does.  lse = m + log(max(l, 1e−30)) with the
// running maximum m floored at −1e30, as xent.py:52 and its NEG_INF.
//
// Design.  The TPU kernel tiles (256 rows × 2048 vocab) and walks the vocab
// blocks as the sequential inner grid axis, carrying (max, sum-exp, label
// logit) in VMEM scratch; it halves the vocab block until it divides V (256
// wide at V = 32000, 8 wide at 50280).  Here one block of 256 threads owns
// one row and streams it once: each thread keeps a running (max, sum-exp)
// pair in registers over the elements t·VEC + k·256·VEC of the row, read as
// 16-byte vectors (4 f32 or 8 bf16) where V is a multiple of the vector and
// the row base is 16-byte aligned, else one element at a time, so any V
// works (V = 1 and odd V included).  The 256 pairs are then merged by xor
// shuffles within each warp and by warp 0 over the 8 warp results, in one
// fixed order: a row's bits depend on V (and on whether the logits' base is
// 16-byte aligned, which picks the vector path), never on R or on where the
// row sits (rows invariant bitwise).  The label logit is one load at
// x[r, label_r]; there is no one-hot scan.  The backward is one more pass
// of the same shape: read x, write dx, no f32 (R, V) temporary, which is
// what autograd of the plain version materialises (1.05 GB at 8192 ×
// 32000).  exp and log are the IEEE expf / logf (no --use_fast_math).
//
// Bound.  At the LM training shape of tinyllama-1.1b (R = 8192 tokens,
// V = 32000) the forward reads the logits once, 524 MB in bf16 and 1.05 GB
// in f32: 0.157 / 0.313 ms at 3.35 TB/s; the backward reads and writes
// them, 0.313 / 0.626 ms.  Its ~6 flops and one exp per element (1.6 GFLOP
// at this shape) take ~0.03 ms at 67 TFLOP/s, so both are bound by bytes.
// One row per block gives 8192 blocks of 256 threads, 8 resident per SM,
// enough loads in flight to approach the memory rate; a row's 125 vectors
// per thread leave the reduction's cost small.  Left on the table: the
// forward and backward of one step read the same logits twice (the
// backward could be fused into the LM head's backward GEMM), and bf16 exp
// in pairs.
//
// Interface: plain C functions (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16; x (R, V) contiguous, labels (R,)
// int32, loss, lse and g (R,) float32, dx (R, V) contiguous in x's dtype.
// They launch on the given stream and return cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype or shape they do not take.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_xent {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // xent.py's NEG_INF: the running max's floor

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T read or written as one aligned access (16 bytes for the
// vector paths, one element for the scalar path).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Merge the running pair (m, l) with (m2, l2): symmetric in the two pairs,
// so every lane of an xor butterfly ends with the same bits.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void push(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// The label's column, or -1 when it lies outside [-V, V).
__device__ __forceinline__ int64_t label_column(int label, int64_t V) {
  int64_t lab = label;
  if (lab < 0) lab += V;
  return (lab >= 0 && lab < V) ? lab : -1;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse, int64_t V) {
  __shared__ float sm[kWarps], sl[kWarps];
  const int64_t r = blockIdx.x;
  const T* row = x + r * V;
  float m = kNegInf, l = 0.0f;
  const int64_t nvec = V / VEC;
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(row)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) push(m, l, to_f32(p.v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < kWarps ? sm[lane] : kNegInf;
  l = lane < kWarps ? sl[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off));
  if (lane == 0) {
    const float s = m + logf(fmaxf(l, 1e-30f));
    const int64_t col = label_column(labels[r], V);
    lse[r] = s;
    loss[r] = col >= 0 ? s - to_f32(row[col]) : __int_as_float(0x7fc00000);  // NaN
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, int64_t V) {
  const int64_t r = blockIdx.x;
  const T* row = x + r * V;
  T* drow = dx + r * V;
  const float s = lse[r], gr = g[r];
  const int64_t col = label_column(labels[r], V);
  const int64_t nvec = V / VEC;
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(row)[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float e = expf(to_f32(p.v[k]) - s);
      if (i * VEC + k == col) e -= 1.0f;
      out.v[k] = from_f32<T>(gr * e);
    }
    reinterpret_cast<Pack<T, VEC>*>(drow)[i] = out;
  }
}

// 16-byte vectors when V is a multiple of the vector and every row base is
// aligned (the base pointers aligned and V·sizeof(T) a multiple of 16).
template <typename T>
bool vectorised(int64_t V, const void* a, const void* b) {
  constexpr int vec = 16 / sizeof(T);
  return V % vec == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int* labels, float* loss, float* lse,
                       int64_t R, int64_t V, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const T* px = static_cast<const T*>(x);
  if (vectorised<T>(V, x, x))
    xent_fwd_kernel<T, vec><<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
        px, labels, loss, lse, V);
  else
    xent_fwd_kernel<T, 1><<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
        px, labels, loss, lse, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int* labels, const float* lse, const float* g,
                       void* dx, int64_t R, int64_t V, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const T* px = static_cast<const T*>(x);
  T* pd = static_cast<T*>(dx);
  if (vectorised<T>(V, x, dx))
    xent_bwd_kernel<T, vec><<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
        px, labels, lse, g, pd, V);
  else
    xent_bwd_kernel<T, 1><<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
        px, labels, lse, g, pd, V);
  return cudaGetLastError();
}

bool bad_shape(int64_t R, int64_t V) { return R < 0 || R > 0x7fffffff || V <= 0; }

}  // namespace repro_torch_xent

extern "C" int rt_fused_xent_fwd(int dtype, const void* x, const void* labels, void* loss,
                                 void* lse, int64_t R, int64_t V, void* stream) {
  using namespace repro_torch_xent;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(R, V)) return cudaErrorInvalidValue;
  if (R == 0) return cudaGetLastError();
  const int* lab = static_cast<const int*>(labels);
  float* pl = static_cast<float*>(loss);
  float* ps = static_cast<float*>(lse);
  if (dtype == 0) return launch_fwd<float>(x, lab, pl, ps, R, V, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, lab, pl, ps, R, V, s);
  return cudaErrorInvalidValue;
}

extern "C" int rt_fused_xent_bwd(int dtype, const void* x, const void* labels,
                                 const void* lse, const void* g, void* dx, int64_t R,
                                 int64_t V, void* stream) {
  using namespace repro_torch_xent;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(R, V)) return cudaErrorInvalidValue;
  if (R == 0) return cudaGetLastError();
  const int* lab = static_cast<const int*>(labels);
  const float* ps = static_cast<const float*>(lse);
  const float* pg = static_cast<const float*>(g);
  if (dtype == 0) return launch_bwd<float>(x, lab, ps, pg, dx, R, V, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, lab, ps, pg, dx, R, V, s);
  return cudaErrorInvalidValue;
}
