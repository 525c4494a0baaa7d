// The Mamba2 SSD (state-space duality) chunk scan, for Hopper.
//
// Replaces the Pallas kernel ssd_chunk of the JAX package:
//   src/repro/kernels/ssd_chunk.py:59 (kernel body :28-56)
// It computes the recurrence of src/repro/kernels/ref.py:ssd_scan,
//   h_t = exp(a_t)·h_{t-1} + b_t ⊗ x_t,   y_t = c_tᵀ h_t,   h_0 = 0,
// in the chunked dual form that kernel uses.  Per chunk of L positions,
// with cum the inclusive cumsum of a over the chunk and H the state carried
// in from the previous chunk:
//   G   = (C·Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ 1(s ≤ t)          (L × L)
//   Y   = G·X + exp(cum_t) ⊙ (C·H)                         (L × P)
//   H  ← exp(cum_L)·H + (B ⊙ exp(cum_L − cum_s))ᵀ·X        (N × P)
// x (B, H, S, P) in f32 or bf16; a (B, H, S) f32; b, c (B, H, S, N) in x's
// dtype, read through their strides (the mixer passes them expanded over the
// heads with stride 0, so no per-head copy is made); y in x's dtype, also
// through its strides; the terminal state (B, H, N, P) in f32, contiguous.
// All arithmetic is f32.  exp(cum_t − cum_s) is evaluated only for s ≤ t:
// the entries above the diagonal can overflow, and inf·0 would give NaN.
//
// Design.  The TPU kernel runs the chunks as the sequential inner grid axis
// and carries H in VMEM scratch.  Blocks on Hopper run in no order, so here
// one thread block owns one (batch, head) and loops over the chunks itself,
// with the (N × P) f32 state resident in shared memory for the whole scan
// (32 KB at N = 128, P = 64).  L is fixed at 32, one position per lane of
// warp 0, which forms the cumsum with shuffles; the ragged last chunk is
// padded with x = b = c = 0 and a = 0 (so cum_L is the last real position's
// and the padding adds nothing to H), where the JAX wrapper halves L until
// it divides S.  The function is the same for every L; only rounding moves.
// Shared memory holds H, the chunk's X, B and C as f32 (B and C rows padded
// by 4 floats so the float4 reads of 8 lanes hit distinct banks) and G:
// 79.7 KB at N = 128, P = 64, which is above the 48 KB of static shared
// memory (hence cudaFuncSetAttribute) and lets 2 blocks share an SM, so the
// 256 (batch, head) blocks of a B = 4 prefill run in one wave on 132 SMs.
// 256 threads; per chunk, three barrier-separated products:
//   G: thread (s = lane, t = warp + 8i), 4 entries, a float4 walk over N;
//   Y: thread (4 columns, rows r + RG·i), the G·X and C·H sums apart;
//   H: thread (4 columns, rows n + RG·i), the B-scaled Bᵀ·X sum.
//
// Bound.  At the prefill shape of mamba2-1.3b (B = 4, H = 64, S = 2048,
// P = 64, N = 128, bf16 in) the chunked form does 2LN + 2LP + 4NP flops per
// position and head: 45,056 at L = 32, 2.36e10 per call, which takes
// 0.353 ms at the 67 TFLOP/s of f32 CUDA-core FMAs; its ~149 MB of x, y, a,
// the unique b and c, and the state take 0.045 ms at 3.35 TB/s, so it is
// bound by operations.  This design reaches only part of that rate: its
// products read every operand from shared memory (no register tiling beyond
// 4 × 4), and one block per (batch, head) leaves S's parallelism unused.
// Left on the table: tensor cores (mma.sync / wgmma on bf16 or TF32 tiles),
// a parallel pass for the chunk states followed by a short scan across
// chunks, and TMA loads double-buffered against the products.
//
// The products are CUDA-core f32 FMAs, spelled __fmaf_rn because the
// library builds with -fmad=false for the bitwise kernels; this kernel is
// held to a tolerance (y: rtol = atol = 2e-4 in f32, 6e-2 for bf16 outputs;
// the state: 2e-4 of its largest magnitude), not bitwise, since the chunked
// form sums in another order than the sequential recurrence.
//
// Interface: a plain C function (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16; N in {16, 128}, P in {16, 64}.  The
// fifteen strides (elements) come as a host array: (batch, head, position)
// of x, a, b, c and y; the last axis of x, b, c and y is contiguous.  It
// launches on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype or shape it does not take.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_ssd {

constexpr int kL = 32;          // chunk length: one position per lane of warp 0
constexpr int kThreads = 256;
constexpr int kLdG = kL + 4;    // G row stride (floats)

struct Strides {
  int64_t x[3], a[3], b[3], c[3], y[3];  // (batch, head, position), in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int N, int P>
constexpr int smem_floats() {
  return N * P + kL * P + 2 * kL * (N + 4) + kL * kLdG + 3 * kL;
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ y,
                 float* __restrict__ h_out, int heads, int S, Strides st) {
  static_assert(P % 4 == 0 && N % 4 == 0, "float4 walks need N and P in fours");
  constexpr int kLdBC = N + 4;                 // B and C row stride (floats)
  constexpr int kCG = P / 4;                   // 4-column groups of Y and H
  constexpr int kRG = kThreads / kCG;          // row groups
  constexpr int kRowsY = (kL + kRG - 1) / kRG; // Y rows per thread
  constexpr int kRowsH = (N + kRG - 1) / kRG;  // H rows per thread
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // N x P, the carried state
  float* xs = hs + N * P;                        // L x P
  float* bs = xs + kL * P;                       // L x (N + 4)
  float* cs = bs + kL * kLdBC;                   // L x (N + 4)
  float* gs = cs + kL * kLdBC;                   // L x (L + 4)
  float* cum = gs + kL * kLdG;                   // cumsum of a over the chunk
  float* ecum = cum + kL;                        // exp(cum_t)
  float* wdec = ecum + kL;                       // exp(cum_L - cum_s)

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / heads, hi = blockIdx.x % heads;
  const T* xp = x + bi * st.x[0] + hi * st.x[1];
  const float* ap = a + bi * st.a[0] + hi * st.a[1];
  const T* bp = b + bi * st.b[0] + hi * st.b[1];
  const T* cp = c + bi * st.c[0] + hi * st.c[1];
  T* yp = y + bi * st.y[0] + hi * st.y[1];

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;

  const int cg = tid % kCG, rg = tid / kCG;
  const int n_chunks = (S + kL - 1) / kL;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kL;
    __syncthreads();  // the previous chunk is done with xs, bs, cs, gs; H is updated

    for (int i = tid; i < kL * P; i += kThreads) {
      const int r = i / P, col = i % P, t = t0 + r;
      xs[i] = t < S ? to_f32(xp[t * st.x[2] + col]) : 0.f;
    }
    for (int i = tid; i < kL * N; i += kThreads) {
      const int r = i / N, col = i % N, t = t0 + r;
      bs[r * kLdBC + col] = t < S ? to_f32(bp[t * st.b[2] + col]) : 0.f;
      cs[r * kLdBC + col] = t < S ? to_f32(cp[t * st.c[2] + col]) : 0.f;
    }
    if (tid < 32) {  // warp 0: the inclusive cumsum, one position per lane
      const int t = t0 + tid;
      float v = t < S ? ap[t * st.a[2]] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v = __fadd_rn(v, u);
      }
      const float last = __shfl_sync(0xffffffffu, v, 31);
      cum[tid] = v;
      ecum[tid] = expf(v);
      wdec[tid] = expf(__fsub_rn(last, v));
    }
    __syncthreads();

    {  // G = (C·Bᵀ) ⊙ exp(cum_t − cum_s) on s ≤ t, 0 above
      const int s = tid % 32, w = tid / 32;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv = load4(bs + s * kLdBC + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = load4(cs + (w + 8 * i) * kLdBC + n);
          acc[i] = __fmaf_rn(cv.x, bv.x, acc[i]);
          acc[i] = __fmaf_rn(cv.y, bv.y, acc[i]);
          acc[i] = __fmaf_rn(cv.z, bv.z, acc[i]);
          acc[i] = __fmaf_rn(cv.w, bv.w, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = w + 8 * i;
        gs[t * kLdG + s] = s <= t ? __fmul_rn(acc[i], expf(__fsub_rn(cum[t], cum[s]))) : 0.f;
      }
    }
    __syncthreads();

    // Y = G·X + exp(cum_t)·(C·H), written to global memory
    if (rg < kL) {
      float gx[kRowsY][4], ch_[kRowsY][4];
#pragma unroll
      for (int i = 0; i < kRowsY; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gx[i][j] = ch_[i][j] = 0.f;
#pragma unroll 2
      for (int s = 0; s < kL; s += 4) {
        float4 xv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = load4(xs + (s + e) * P + cg * 4);
#pragma unroll
        for (int i = 0; i < kRowsY; ++i) {
          const int t = rg + kRG * i;
          if (t < kL) {
            const float4 gv = load4(gs + t * kLdG + s);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float g = comp(gv, e);
              gx[i][0] = __fmaf_rn(g, xv[e].x, gx[i][0]);
              gx[i][1] = __fmaf_rn(g, xv[e].y, gx[i][1]);
              gx[i][2] = __fmaf_rn(g, xv[e].z, gx[i][2]);
              gx[i][3] = __fmaf_rn(g, xv[e].w, gx[i][3]);
            }
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = load4(hs + (n + e) * P + cg * 4);
#pragma unroll
        for (int i = 0; i < kRowsY; ++i) {
          const int t = rg + kRG * i;
          if (t < kL) {
            const float4 cv = load4(cs + t * kLdBC + n);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float cc = comp(cv, e);
              ch_[i][0] = __fmaf_rn(cc, hv[e].x, ch_[i][0]);
              ch_[i][1] = __fmaf_rn(cc, hv[e].y, ch_[i][1]);
              ch_[i][2] = __fmaf_rn(cc, hv[e].z, ch_[i][2]);
              ch_[i][3] = __fmaf_rn(cc, hv[e].w, ch_[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsY; ++i) {
        const int t = rg + kRG * i;
        if (t < kL && t0 + t < S) {
          T* out = yp + (t0 + t) * st.y[2] + cg * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) store(out + j, __fmaf_rn(ecum[t], ch_[i][j], gx[i][j]));
        }
      }
    }
    __syncthreads();  // every thread is done reading H

    // H <- exp(cum_L)·H + (B ⊙ exp(cum_L − cum_s))ᵀ·X
    {
      float acc[kRowsH][4];
#pragma unroll
      for (int i = 0; i < kRowsH; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < kL; ++s) {
        const float4 xv = load4(xs + s * P + cg * 4);
        const float w = wdec[s];
#pragma unroll
        for (int i = 0; i < kRowsH; ++i) {
          const int n = rg + kRG * i;
          if (n < N) {
            const float bw = __fmul_rn(bs[s * kLdBC + n], w);
            acc[i][0] = __fmaf_rn(bw, xv.x, acc[i][0]);
            acc[i][1] = __fmaf_rn(bw, xv.y, acc[i][1]);
            acc[i][2] = __fmaf_rn(bw, xv.z, acc[i][2]);
            acc[i][3] = __fmaf_rn(bw, xv.w, acc[i][3]);
          }
        }
      }
      const float decay = ecum[kL - 1];
#pragma unroll
      for (int i = 0; i < kRowsH; ++i) {
        const int n = rg + kRG * i;
        if (n < N) {
          float* hrow = hs + n * P + cg * 4;
          const float4 hv = load4(hrow);
          *reinterpret_cast<float4*>(hrow) = make_float4(
              __fmaf_rn(decay, hv.x, acc[i][0]), __fmaf_rn(decay, hv.y, acc[i][1]),
              __fmaf_rn(decay, hv.z, acc[i][2]), __fmaf_rn(decay, hv.w, acc[i][3]));
        }
      }
    }
  }
  __syncthreads();
  float* hp = h_out + static_cast<int64_t>(blockIdx.x) * N * P;
  for (int i = tid; i < N * P; i += kThreads) hp[i] = hs[i];
}

template <typename T, int N, int P>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* h, int64_t batch, int64_t heads, int64_t seq, const Strides& st,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(smem_floats<N, P>() * sizeof(float));
  auto kernel = ssd_chunk_kernel<T, N, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(batch * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(h),
      static_cast<int>(heads), static_cast<int>(seq), st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_np(int n, int p, const void* x, const void* a, const void* b,
                      const void* c, void* y, void* h, int64_t batch, int64_t heads,
                      int64_t seq, const Strides& st, cudaStream_t stream) {
  if (n == 16 && p == 16) return launch<T, 16, 16>(x, a, b, c, y, h, batch, heads, seq, st, stream);
  if (n == 16 && p == 64) return launch<T, 16, 64>(x, a, b, c, y, h, batch, heads, seq, st, stream);
  if (n == 128 && p == 16) return launch<T, 128, 16>(x, a, b, c, y, h, batch, heads, seq, st, stream);
  if (n == 128 && p == 64) return launch<T, 128, 64>(x, a, b, c, y, h, batch, heads, seq, st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch_ssd

extern "C" int rt_ssd_chunk(int dtype, int state, int headdim, const void* x, const void* a,
                            const void* b, const void* c, void* y, void* h, int64_t batch,
                            int64_t heads, int64_t seq, const int64_t* strides,
                            void* stream) {
  using namespace repro_torch_ssd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0) return cudaGetLastError();
  if (batch * heads > 0x7fffffff || seq > 0x7fffffff) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.a[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
  if (dtype == 0) return launch_np<float>(state, headdim, x, a, b, c, y, h, batch, heads, seq, st, s);
  if (dtype == 1)
    return launch_np<__nv_bfloat16>(state, headdim, x, a, b, c, y, h, batch, heads, seq, st, s);
  return cudaErrorInvalidValue;
}
