// Causal or full GQA attention with an online softmax, for Hopper.
//
// Replaces the Pallas kernel flash_attention of the JAX package:
//   src/repro/kernels/flash_attention.py:67 (kernel body :27-64)
// It computes what that kernel computes: q (B, Hq, S, D), k and v
// (B, Hkv, S, D) with Hq % Hkv == 0; query head h reads KV head
// h / (Hq/Hkv) in place, with no repeat copy.  Per query row:
//   s   = (q . k^T accumulated in f32) * scale, masked scores -1e30
//   m'  = max(m, rowmax(s));  p = exp(s - m');  alpha = exp(m - m')
//   l   = alpha*l + rowsum(p)
//   acc = alpha*acc + round_to_input_dtype(p) . v    (f32 accumulation)
//   o   = acc / max(l, 1e-30), cast to the input dtype
// P is rounded to the input dtype before P.V, as the TPU kernel's
// p.astype(v.dtype) (:57); in bf16 that rounding is most of the gap to an
// f32 softmax.  `scale` is the launcher's float 1/sqrt(D) by default, as
// flash_attention.py:82 has it; the port's plain version
// (kernels/ref.py:flash_attention) follows ref.py and rounds the scale to
// the input dtype first, so in bf16 the two differ by 1e-4 relative in the
// scale.  Each keeps the difference its JAX counterpart has.
//
// Design.  The TPU kernel runs the KV axis as its sequential innermost grid
// dimension and carries (m, l, acc) in VMEM scratch between grid steps.
// Blocks on Hopper run in no order, so here one thread block owns one
// (batch, query head, 64-row query tile) and loops over the 64-row KV tiles
// itself, carrying (m, l, acc) in registers.  Under `causal` it stops at the
// diagonal tile (the TPU kernel's `needed` skip), and it masks the ragged
// last tile itself (columns past S score -inf and their V rows are zero)
// where the JAX wrapper halves its block until it divides S; the results
// are the same function.  Q, the current K (then V) tile and P live in
// dynamic shared memory as f32, rows padded by 4 floats so the float4 reads
// of 8 lanes fall in distinct banks (85 KB at D = 128: above the 48 KB of
// static shared memory, hence cudaFuncSetAttribute).  128 threads as 8 x 16:
// a thread owns 8 query rows (ty + 8i) x 4 score columns (tx + 16j) of a
// tile, and 8 rows x 4·ceil(D/64) output columns.  Row max and row sum
// reduce over the 16 lanes of a half-warp with shuffles.  Query tiles are
// issued last-first, so the long causal rows start first.
//
// Dtypes float32 and bfloat16; D in {16, 64, 128} (template parameter);
// any S >= 1.  The products are CUDA-core f32 FMAs, spelled __fmaf_rn
// because the library builds with -fmad=false for the bitwise kernels; this
// kernel is held to a tolerance (f32 2e-5, bf16 6e-2), not bitwise, since
// it sums in another order than the plain version.
//
// Bound.  At the prefill shape of qwen2.5-14b (B = 4, Hq = 40, Hkv = 8,
// S = 2048, D = 128, bf16, causal) the work is 2·B·Hq·S²·D = 1.72e11 flops
// with the masked half skipped, against 201 MB of Q, K, V and O: bound by
// operations, 0.174 ms at the 989 TFLOP/s of bf16 tensor cores (the bytes
// alone take 0.060 ms).  This design uses no tensor core: its ceiling is
// the 67 TFLOP/s of f32 FMAs, 15x the bound, and shared-memory reads and
// the unoverlapped tile loads (three barriers per tile, 2 blocks per SM)
// keep it below that.  Left on the table: mma.sync or wgmma on bf16 tiles,
// TMA or cp.async loads double-buffered against the products, and larger
// tiles with warp specialisation.
//
// Interface: a plain C function (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16.  It launches on the given stream and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype or head
// dimension it does not take.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_attention {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // KV rows per tile
constexpr int kTX = 16, kTY = 8;      // thread grid of a block
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;      // query rows per thread
constexpr int kCols = kBK / kTX;      // score columns per thread
constexpr int kLdP = kBK + 4;         // P row stride (floats)
constexpr float kMasked = -1e30f;     // the TPU kernel's NEG_INF
static_assert(kBQ == kBK, "the causal tile count assumes square tiles");

// x rounded to the input dtype and read back as f32 (p.astype(v.dtype))
__device__ __forceinline__ float round_to(float, float x) { return x; }
__device__ __forceinline__ float round_to(__nv_bfloat16, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Rows row0 .. row0+63 of one head's (S, D) slab into shared memory as f32
// (row stride D + 4); rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + static_cast<int64_t>(row0 + r) * D + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
                       int group, int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kGroups = D / 4;                    // 4-column output groups
  constexpr int kGPT = (kGroups + kTX - 1) / kTX;   // output groups per thread
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + kBQ * kLd;
  float* ps = kvs + kBK * kLd;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t q_off = (static_cast<int64_t>(b) * Hq + h) * S * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * (Hq / group) + h / group) * S * D;

  load_tile<T, D>(qs, q + q_off, q0, S);

  float m[kRows], l[kRows], acc[kRows][kGPT * 4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kGPT * 4; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? qt + 1 : (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P.V is done with kvs and ps
    load_tile<T, D>(kvs, k + kv_off, k0, S);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv4[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv4[j] = load4(kvs + (tx + kTX * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 q4 = load4(qs + (ty + kTY * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = __fmaf_rn(q4.x, kv4[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(q4.y, kv4[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(q4.z, kv4[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(q4.w, kv4[j].w, s[i][j]);
        }
      }
    }

    // online softmax of this tile's rows
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kTY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTX * j;
        float x = __fmul_rn(s[i][j], scale);
        if (kj >= S) x = -INFINITY;                  // past the ragged end: p = 0
        else if (causal && kj > qi) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        rs = __fadd_rn(rs, p);
        ps[(ty + kTY * i) * kLdP + tx + kTX * j] = round_to(T(), p);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kGPT * 4; ++c) acc[i][c] = __fmul_rn(alpha, acc[i][c]);
    }

    __syncthreads();  // P written; every thread is done reading K
    load_tile<T, D>(kvs, v + kv_off, k0, S);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p4[i] = load4(ps + (ty + kTY * i) * kLdP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < kGPT; ++g) {
          const int grp = tx + kTX * g;
          if (kGroups % kTX == 0 || grp < kGroups) {
            const float4 v4 = load4(kvs + (kk + e) * kLd + grp * 4);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float p = comp(p4[i], e);
              acc[i][4 * g + 0] = __fmaf_rn(p, v4.x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = __fmaf_rn(p, v4.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = __fmaf_rn(p, v4.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = __fmaf_rn(p, v4.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kGPT; ++g) {
      const int grp = tx + kTX * g;
      if (kGroups % kTX == 0 || grp < kGroups) {
        const float4 out = make_float4(
            __fdiv_rn(acc[i][4 * g + 0], denom), __fdiv_rn(acc[i][4 * g + 1], denom),
            __fdiv_rn(acc[i][4 * g + 2], denom), __fdiv_rn(acc[i][4 * g + 3], denom));
        store4(o + q_off + static_cast<int64_t>(qi) * D + grp * 4, out);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B,
                   int64_t Hq, int64_t Hkv, int64_t S, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int kLd = D + 4;
  const int smem = static_cast<int>((2 * kBQ * kLd + kBQ * kLdP) * sizeof(float));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ), static_cast<unsigned>(Hq),
                  static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<int>(S), static_cast<int>(Hq),
      static_cast<int>(Hq / Hkv), causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int64_t B,
                     int64_t Hq, int64_t Hkv, int64_t S, int causal, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch_attention

extern "C" int rt_flash_attention(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, void* o, int64_t batch, int64_t heads_q,
                                  int64_t heads_kv, int64_t seq, int causal, double scale,
                                  void* stream) {
  using namespace repro_torch_attention;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  if (heads_kv <= 0 || heads_q % heads_kv != 0) return cudaErrorInvalidValue;
  if (batch * heads_q * seq == 0) return cudaGetLastError();
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, o, batch, heads_q, heads_kv, seq, causal, sc, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, batch, heads_q, heads_kv, seq,
                                   causal, sc, s);
  return cudaErrorInvalidValue;
}
