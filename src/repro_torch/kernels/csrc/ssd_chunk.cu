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
//   Y   = exp(cum_t) ⊙ (C·H) + G·X                         (L × P)
//   H  ← exp(cum_L)·H + (B ⊙ exp(cum_L − cum_s))ᵀ·X        (N × P)
// x (B, H, S, P) in f32 or bf16; a (B, H, S) f32; b, c (B, H, S, N) in x's
// dtype, read through their strides (the mixer passes x and a as transposed
// views and b and c expanded over the heads with stride 0, so no copy is
// made); y in x's dtype through its strides; the terminal state (B, H, N, P)
// in f32, contiguous.  exp(cum_t − cum_s) is evaluated only for s ≤ t and
// never factored into exp(cum_t)·exp(−cum_s): above the diagonal, and in
// the factored form, it overflows at strong decay, and inf·0 gives NaN.
//
// What bounded the earlier design (one block of 256 threads per (batch,
// head), L = 32, f32 FMAs on CUDA cores): 1.1836 ms at mamba2-1.3b's
// prefill (B 4, H 64, S 2048, P 64, N 128, bf16), 3.4x the 0.3526 ms f32
// CUDA-core bound and 27x the tensor-core bound below.  Its products read
// every operand from shared memory into 4 x 4 register tiles (bound by
// shared-memory bandwidth), its loads were synchronous between four
// barriers a chunk, bf16 inputs were widened to f32 in shared memory, and at
// batch 1 its 64 blocks left half of the 132 SMs idle.
//
// This design:
//   - Products on tensor cores: mma.sync with f32 accumulators.  bf16
//     inputs: X, B and C stay bf16 in shared memory and feed m16n8k16 bf16
//     MMAs through ldmatrix; C·Bᵀ is exact products of the inputs.  The
//     three operands the kernel forms itself go in as bf16 hi + lo (two
//     products each, lo first): G after the decay mask, the copy of H for
//     C·H, and B ⊙ w of the state update.  One bf16 rounding of G or H puts
//     y past the 6e-2 tolerance at S = 2048, one of B ⊙ w the state past its
//     2e-4 (tests/test_torch_ssd.py emulates each).  f32 inputs: split TF32
//     on m16n8k8 (tensor_core.cuh, shared with the f32 attention), three
//     TF32 products of split halves per product, about f32 accuracy, where
//     one TF32 product misses y's 2e-4 by ~100x.  The carried state H
//     stays f32 in the accumulator registers of the warps that update it.
//   - L = 64, the JAX wrapper's default: 16-row MMA tiles, 4 row tiles a
//     chunk, and half the per-chunk overhead (barriers, loads, scan) of
//     L = 32.  The ragged last chunk is padded with x = b = c = 0 and a = 0,
//     so the padding adds nothing to H and cum_L is the last real
//     position's.
//   - 16 warps a block, one block an SM (193 KB of shared memory at N 128,
//     P 64, bf16).  Per chunk: G once a block (its ten 16 x 16 blocks on or
//     below the diagonal, one a warp, masked and written to shared memory as
//     bf16 hi and lo); the state update, every warp its part of H (one
//     16-row m tile of N and half the columns at N = 128; at N = 16 the
//     columns are cut among the warps), which also writes H's operand copy
//     for the next chunk (double-buffered); a barrier; then Y = exp(cum_t)
//     ⊙ (C·H) + G·X, every warp 16 rows and a quarter of the columns.  Two
//     barriers a chunk (the earlier design had four): the chunk's data and
//     the previous chunk done; G complete.
//   - Pipelined loads: chunk k + 1's X, B and C go into the other half of a
//     two-stage ring by cp.async (16 bytes a copy, the thread's row offsets
//     computed once) while chunk k computes; one warp loads chunk k + 1's
//     a (strided, 4 bytes an element) and scans it at the end of chunk k,
//     in log2 units so every exponential is exp2 on the MUFU.  Operands read
//     through their strides: b and c with stride 0 over the heads need no
//     tensor map.  Rows that do not start on 16-byte boundaries are copied
//     by plain loads instead (the same bits).  A bulk copy (TMA, 1-D) per
//     row was tried and was slower than cp.async: 192 copies of 32-256 bytes
//     a chunk.
//   - Enough blocks at batch 1: Y's and H's columns are independent across
//     P, so a block owns one (batch, head, P slice) and recomputes G per
//     slice.  The launcher starts from the widest slice that fits shared
//     memory (P; 32 for f32 at N = 128) and halves it, down to 16 columns,
//     while twice the blocks still fit one wave (2 · batch · heads · slices
//     <= SMs): mamba2-1.3b's batch-1 prefill runs 128 blocks of 32 columns,
//     its B 4 prefill 256 blocks of 64 (two waves).  Every slice count
//     gives the same bits.
//   - Not taken: sharing C·Bᵀ and the B and C loads across the heads that
//     share b and c (stride 0), wgmma for the products, TMA boxes.
//
// Bound.  At mamba2-1.3b's prefill the ~149 MB of x, y, a, the unique b
// and c, and the state take 0.0444 ms at 3.35 TB/s; the chunked form's
// 2LN + 2LP + 4NP flops per position and head take 0.030 ms at L = 64 on
// bf16 tensor cores (989 TFLOP/s): bound by bytes.  This design: 0.2800 ms
// there, 0.1111 ms at batch 1 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6
// row 11).  What bounds it: a chain of dependent steps a chunk (loads,
// G, state, barrier, Y) that 4 warps an SM sub-partition only partly hide,
// with the hi + lo products doubling the MMAs of C·H and of the state.
// ptxas (sm_90a, -O3): 118 registers at N 128, P 64, bf16 (69-118 over the
// instantiations), no spills, one barrier.
//
// No atomics and no split over S: two launches give the same bits.  Held
// to a tolerance against the plain recurrence (y: rtol = atol = 2e-4 in
// f32, 6e-2 for bf16 outputs; the state: 2e-4 of its largest magnitude),
// not bitwise, since the chunked form sums in another order.  Scalar f32
// arithmetic is spelled with __f*_rn intrinsics because the library builds
// with -fmad=false for the bitwise kernels.
//
// Interface: a plain C function (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16; N in {16, 128}, P in {16, 64}.  The
// fifteen strides (elements) come as a host array: (batch, head, position)
// of x, a, b, c and y; the last axis of x, b, c and y is contiguous.
// `slices` is the number of P slices (0: the launcher's choice above;
// otherwise a power of two leaving at least 16 columns that fit); the grid
// query rt_ssd_chunk_slices reports the choice.  It launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// dtype, shape or slice count it does not take.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace repro_torch_ssd {

using namespace repro_torch_tc;

constexpr int kL = 64;                 // chunk length
constexpr int kRowTiles = kL / 16;     // 16-row tiles of the chunk
constexpr int kGBlocks = kRowTiles * (kRowTiles + 1) / 2;  // G's 16 x 16 blocks on or below
                                                           // the diagonal
constexpr int kWarps = 16;             // Y: a row tile and a quarter of the columns each
constexpr int kColGroups = kWarps / kRowTiles;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t x[3], a[3], b[3], c[3], y[3];  // (batch, head, position), in elements
};

// Shared-memory geometry of one instantiation.  Rows are padded so that the
// fragment loads of a warp hit distinct banks: bf16 rows of N + 8, PS + 8
// and L + 8 elements (ldmatrix reads 8 rows of 16 bytes, 4 banks apart);
// f32 B, C and G rows of N + 8 and L + 8 floats (64-bit loads of column
// pairs, 8 rows x 4 pairs), X and H rows of PS + 4 (32-bit loads of 4 row
// pairs x 8 columns).  Every row starts on a 16-byte boundary (cp.async,
// ldmatrix).
template <typename T, int N, int PS>
struct Geometry {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLdN = N + 8;
  static constexpr int kLdP = kBf16 ? PS + 8 : PS + 4;
  static constexpr int kLdG = kL + 8;
  static constexpr int kX = kL * kLdP, kBC = kL * kLdN;  // elements
  // a stage: X, B, C
  static constexpr int kStageBytes = (kX + 2 * kBC) * static_cast<int>(sizeof(T));
  // the H operand copy and G: bf16 hi and lo parts, or f32
  static constexpr int kParts = kBf16 ? 2 : 1;
  static constexpr int kHPart = N * kLdP, kGPart = kL * kLdG;  // elements
  static constexpr int kHBytes = kParts * kHPart * static_cast<int>(sizeof(T));
  static constexpr int kGBytes = kParts * kGPart * static_cast<int>(sizeof(T));
  // two chunks' a, and two of their scans: cum, exp2(cum), w and exp2(cum_L)
  static constexpr int kScan = 3 * kL + 4;  // floats
  static constexpr int kScanBytes = 2 * (kL + kScan) * 4;
  static constexpr int kSmem = 2 * kStageBytes + 2 * kHBytes + kGBytes + kScanBytes;
  // Y's PS/8 n tiles among a row tile's kColGroups warps; the state's (N/16
  // m tiles) x (PS/8 n tiles) among all warps, m first
  static constexpr int kMT = N / 16, kNT = PS / 8;
  static constexpr int kYN = kNT >= kColGroups ? kNT / kColGroups : 1;
  static constexpr int kWarpsM = kMT < kWarps ? kMT : kWarps;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kWM = kMT / kWarpsM;
  static constexpr int kWN = (kNT + kWarpsN - 1) / kWarpsN;
  static_assert(kNT % kWN == 0 && kNT % kYN == 0, "a warp owns all or none of its n tiles");
  static_assert(kStageBytes % 16 == 0 && kHBytes % 16 == 0 && kGBytes % 16 == 0,
                "16-byte aligned regions");
  static_assert(PS % 16 == 0 && N % 16 == 0, "MMA tiles");
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// 4 bytes global -> shared (the strided a); src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16).  Fragments, with
// g = lane / 4 and q = lane % 4: a = {(g, 2q..2q+1), (g + 8, 2q..), (g,
// 8 + 2q..), (g + 8, 8 + 2q..)}; b = {(k 2q..2q+1, n g), (k 8 + 2q.., n g)};
// c = (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (v0, v1) as bf16 pairs hi + lo: hi = bf16(v), lo = bf16(v − hi), so hi +
// lo misses v by ~2^-17 of it where hi alone misses it by 2^-9.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(__fsub_rn(v0, h.x), __fsub_rn(v1, h.y));
}

// A bf16 pair scaled by (w0, w1), split into hi + lo.
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = unpack_bf16(v);
  split_bf16(__fmul_rn(f.x, w0), __fmul_rn(f.y, w1), hi, lo);
}

// The f32 A fragment (rows row, row + 8; columns col, col + 1 as the k
// order's q, q + 4) of a tile with rows ld floats apart, split.
__device__ __forceinline__ Split4 load_a_split(const float* tile, int ld, int row, int col) {
  const float2 lo = *reinterpret_cast<const float2*>(tile + row * ld + col);
  const float2 hi = *reinterpret_cast<const float2*>(tile + (row + 8) * ld + col);
  Split4 a;
  split_tf32(lo.x, a.big[0], a.small[0]);
  split_tf32(hi.x, a.big[1], a.small[1]);
  split_tf32(lo.y, a.big[2], a.small[2]);
  split_tf32(hi.y, a.big[3], a.small[3]);
  return a;
}

// The f32 B fragment (k rows k0, k0 + 1 as the k order's q, q + 4; column
// col) of a tile with rows ld floats apart, split.
__device__ __forceinline__ Split2 load_b_split(const float* tile, int ld, int k0, int col) {
  Split2 b;
  split_tf32(tile[k0 * ld + col], b.big[0], b.small[0]);
  split_tf32(tile[(k0 + 1) * ld + col], b.big[1], b.small[1]);
  return b;
}

// The B fragments of n tiles nt0 .. nt0 + kCount − 1 over k rows k0 .. k0
// + 15 of a row-major (k, n) bf16 tile with rows ld apart: ldmatrix.trans,
// two n tiles a load where kCount is even.
template <int kCount>
__device__ __forceinline__ void ldsm_b_t(uint32_t (&f)[kCount][2], const __nv_bfloat16* tile,
                                         int ld, int k0, int nt0, int lane) {
  const __nv_bfloat16* row = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + nt0 * 8;
  if constexpr (kCount % 2 == 0) {
#pragma unroll
    for (int j = 0; j < kCount; j += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, smem_addr(row + j * 8 + (lane >> 4) * 8));
      f[j][0] = r[0];
      f[j][1] = r[1];
      f[j + 1][0] = r[2];
      f[j + 1][1] = r[3];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      uint32_t r[2];
      ldsm_x2_t(r, smem_addr(row + j * 8));
      f[j][0] = r[0];
      f[j][1] = r[1];
    }
  }
}

// The bf16 A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 15 of a
// row-major tile with rows ld apart.
__device__ __forceinline__ void ldsm_a(uint32_t (&f)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int k0, int lane) {
  ldsm_x4(f, smem_addr(tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8));
}

// One operand's rows of a chunk (kVecs 16-byte vectors a row, rows ld
// elements apart in shared memory) by cp.async, rows at or past S zero;
// the thread's copies are fixed for the whole scan, so their row offsets
// in the operand are computed once (offsets).  vec false: plain loads.
template <typename T, int kVecs, int kLd>
struct RowCopies {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));  // elements a vector
  static constexpr int kPer = (kL * kVecs + kThreads - 1) / kThreads;
  int64_t off[kPer];

  __device__ __forceinline__ void init(int64_t stride) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      off[k] = static_cast<int64_t>(i / kVecs) * stride + (i % kVecs) * kV;
    }
  }

  __device__ __forceinline__ void load(T* dst, const T* __restrict__ src, int64_t stride,
                                       int t0, int S, bool vec) const {
    const T* base = src + static_cast<int64_t>(t0) * stride;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= kL * kVecs) break;
      const int r = i / kVecs, col = (i % kVecs) * kV;
      const bool in = t0 + r < S;
      T* d = dst + r * kLd + col;
      if (vec) {
        cp_async16(smem_addr(d), in ? base + off[k] : src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) d[e] = in ? base[off[k] + e] : zero<T>();
      }
    }
  }
};

// The X (PS columns), B and C copies of a thread.
template <typename T, int N, int PS>
struct ChunkCopies {
  using G = Geometry<T, N, PS>;
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  RowCopies<T, PS / kV, G::kLdP> x;
  RowCopies<T, N / kV, G::kLdN> b, c;

  __device__ __forceinline__ void init(const Strides& st) {
    x.init(st.x[2]);
    b.init(st.b[2]);
    c.init(st.c[2]);
  }

  // One chunk's X, B and C into a stage.
  __device__ __forceinline__ void load(char* stage, const T* xp, const T* bp, const T* cp,
                                       const Strides& st, int t0, int S, bool vec) const {
    T* xs = reinterpret_cast<T*>(stage);
    x.load(xs, xp, st.x[2], t0, S, vec);
    b.load(xs + G::kX, bp, st.b[2], t0, S, vec);
    c.load(xs + G::kX + G::kBC, cp, st.c[2], t0, S, vec);
  }
};

// One chunk's a (strided, 4 bytes an element) by one warp's cp.async; past
// S it is zero, so the padding decays nothing.
__device__ __forceinline__ void load_a(float* dst, const float* __restrict__ ap, int64_t stride,
                                       int t0, int S, int lane) {
#pragma unroll
  for (int k = 0; k < kL / 32; ++k) {
    const int t = t0 + lane + 32 * k;
    const bool in = t < S;
    cp_async4(smem_addr(dst + lane + 32 * k), in ? ap + static_cast<int64_t>(t) * stride : ap,
              in ? 4 : 0);
  }
}

// The scan of one chunk's a by one warp (lane l: positions 2l, 2l + 1), in
// log2 units so every exponential is exp2 on the MUFU: cum = the inclusive
// cumsum of a·log2(e), exp2(cum_t), w_s = exp2(cum_L − cum_s), and
// exp2(cum_L).
__device__ __forceinline__ void scan_chunk(float* out, const float* as, int lane) {
  const float a0 = __fmul_rn(as[2 * lane], kLog2e), a1 = __fmul_rn(as[2 * lane + 1], kLog2e);
  float incl = __fadd_rn(a0, a1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, u);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  const float last = __shfl_sync(kFull, incl, 31);
  const float c0 = __fadd_rn(excl, a0), c1 = incl;
  out[2 * lane] = c0;
  out[2 * lane + 1] = c1;
  out[kL + 2 * lane] = exp2_approx(c0);
  out[kL + 2 * lane + 1] = exp2_approx(c1);
  out[2 * kL + 2 * lane] = exp2_approx(__fsub_rn(last, c0));
  out[2 * kL + 2 * lane + 1] = exp2_approx(__fsub_rn(last, c1));
  if (lane == 0) out[3 * kL] = exp2_approx(last);
}

template <typename T, int N, int PS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ y,
                 float* __restrict__ h_out, int heads, int slices, int S, Strides st,
                 int vec) {
  using G = Geometry<T, N, PS>;
  constexpr bool kBf16 = G::kBf16;
  constexpr int kLdN = G::kLdN, kLdP = G::kLdP, kLdG = G::kLdG, kYN = G::kYN;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  char* stages = smem;                                        // two stages
  T* hops = reinterpret_cast<T*>(smem + 2 * G::kStageBytes);  // two H operand copies
  T* gs = reinterpret_cast<T*>(smem + 2 * G::kStageBytes + 2 * G::kHBytes);  // G
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  // a of chunks k, k + 1 and their scans: one warp (kScanWarp, of row tile
  // 0, the lightest Y) loads and scans chunk k + 1 at the end of chunk k
  float* abuf = reinterpret_cast<float*>(smem + 2 * G::kStageBytes + 2 * G::kHBytes +
                                         G::kGBytes);
  float* scans = abuf + 2 * kL;
  constexpr int kScanWarp = kWarps - kRowTiles;
  const bool scanner = warp == kScanWarp;

  const int slice = blockIdx.x % slices;
  const int bh = blockIdx.x / slices;
  const int bi = bh / heads, hi = bh % heads;
  const int p0 = slice * PS, P = PS * slices;
  const T* xp = x + bi * st.x[0] + hi * st.x[1] + p0;
  const float* ap = a + bi * st.a[0] + hi * st.a[1];
  const T* bp = b + bi * st.b[0] + hi * st.b[1];
  const T* cp = c + bi * st.c[0] + hi * st.c[1];
  T* yp = y + bi * st.y[0] + hi * st.y[1] + p0;

  // Y: the warp's 16 rows (row tile rt) and kYN n tiles from ny0; H: m
  // tiles wm·kWM + i (rows of N), n tiles wn·kWN + j
  const int rt = warp % kRowTiles, rw = 16 * rt, t_lo = rw + g, t_hi = t_lo + 8;
  const int ny0 = (warp / kRowTiles) * kYN;
  const bool owns_y = ny0 < G::kNT;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;
  const bool owns_h = wn * G::kWN < G::kNT;  // at N = 16 some warps have no columns
  float hacc[G::kWM][G::kWN][4];
#pragma unroll
  for (int i = 0; i < G::kWM; ++i)
#pragma unroll
    for (int j = 0; j < G::kWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.f;

  const int n_chunks = (S + kL - 1) / kL;
  ChunkCopies<T, N, PS> copies;
  copies.init(st);
  if (scanner) load_a(abuf, ap, st.a[2], 0, S, lane);
  cp_async_commit();
  copies.load(stages, xp, bp, cp, st, 0, S, vec);
  cp_async_commit();
  if (scanner) {
    cp_async_wait<1>();  // chunk 0's a
    __syncwarp();
    scan_chunk(scans, abuf, lane);
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kL;
    cp_async_wait<0>();  // this chunk's copies landed
    __syncthreads();     // ... for every thread; every warp is done with chunk ch − 1
    if (scanner && ch + 1 < n_chunks)
      load_a(abuf + ((ch + 1) & 1) * kL, ap, st.a[2], t0 + kL, S, lane);
    cp_async_commit();
    if (ch + 1 < n_chunks)
      copies.load(stages + ((ch + 1) & 1) * G::kStageBytes, xp, bp, cp, st, t0 + kL, S, vec);
    cp_async_commit();
    const T* xs = reinterpret_cast<const T*>(stages + (ch & 1) * G::kStageBytes);
    const T* bs = xs + G::kX;
    const T* cs = bs + G::kBC;
    const T* hcur = hops + (ch & 1) * (G::kHBytes / static_cast<int>(sizeof(T)));
    T* hnext = hops + ((ch + 1) & 1) * (G::kHBytes / static_cast<int>(sizeof(T)));

    const float* cum = scans + (ch & 1) * G::kScan;  // this chunk's scan (scan_chunk)
    const float* ecum = cum + kL;
    const float* wdec = cum + 2 * kL;
    const float decay = cum[3 * kL];

    // G = (C·Bᵀ) ⊙ exp(cum_t − cum_s) on s <= t, once a block: its 16 x 16
    // blocks (r, k) on or below the diagonal, one a warp, into gs (bf16 hi
    // and lo parts, or f32)
    for (int blk = warp; blk < kGBlocks; blk += kWarps) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= blk) ++r;
      const int kc = blk - r * (r + 1) / 2;
      float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (kBf16) {
#pragma unroll
        for (int kb = 0; kb < N / 16; ++kb) {
          uint32_t af[4], bf[4];
          ldsm_a(af, cs, kLdN, 16 * r, kb * 16, lane);
          ldsm_x4(bf, smem_addr(bs + (16 * kc + (lane & 7) + (lane >> 4) * 8) * kLdN + kb * 16 +
                                ((lane >> 3) & 1) * 8));
          mma_bf16(gacc[0], af, bf[0], bf[1]);
          mma_bf16(gacc[1], af, bf[2], bf[3]);
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < N / 8; ++kk) {
          const Split4 af = load_a_split(cs, kLdN, 16 * r + g, kk * 8 + 2 * q);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 br = *reinterpret_cast<const float2*>(
                bs + (16 * kc + 8 * h + g) * kLdN + kk * 8 + 2 * q);
            Split2 bf;
            split_tf32(br.x, bf.big[0], bf.small[0]);
            split_tf32(br.y, bf.big[1], bf.small[1]);
            mma_3xtf32(gacc[h], af, bf);
          }
        }
      }
      const int tl = 16 * r + g, th = tl + 8;
      const float cum_lo = cum[tl], cum_hi = cum[th];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s0 = 16 * kc + 8 * h + 2 * q, s1 = s0 + 1;
        const float c0 = cum[s0], c1 = cum[s1];
        const float v0 = s0 <= tl ? __fmul_rn(gacc[h][0], exp2_approx(__fsub_rn(cum_lo, c0))) : 0.f;
        const float v1 = s1 <= tl ? __fmul_rn(gacc[h][1], exp2_approx(__fsub_rn(cum_lo, c1))) : 0.f;
        const float v2 = s0 <= th ? __fmul_rn(gacc[h][2], exp2_approx(__fsub_rn(cum_hi, c0))) : 0.f;
        const float v3 = s1 <= th ? __fmul_rn(gacc[h][3], exp2_approx(__fsub_rn(cum_hi, c1))) : 0.f;
        if constexpr (kBf16) {
          uint32_t hi0, lo0, hi1, lo1;
          split_bf16(v0, v1, hi0, lo0);
          split_bf16(v2, v3, hi1, lo1);
          *reinterpret_cast<uint32_t*>(gs + tl * kLdG + s0) = hi0;
          *reinterpret_cast<uint32_t*>(gs + th * kLdG + s0) = hi1;
          *reinterpret_cast<uint32_t*>(gs + G::kGPart + tl * kLdG + s0) = lo0;
          *reinterpret_cast<uint32_t*>(gs + G::kGPart + th * kLdG + s0) = lo1;
        } else {
          *reinterpret_cast<float2*>(gs + tl * kLdG + s0) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(gs + th * kLdG + s0) = make_float2(v2, v3);
        }
      }
    }

    // H ← exp(cum_L)·H + (B ⊙ w)ᵀ·X on the warp's part of H, w_s = exp(cum_L − cum_s),
    // and its operand copy for the next chunk's C·H
    if (owns_h) {
#pragma unroll
      for (int i = 0; i < G::kWM; ++i)
#pragma unroll
        for (int j = 0; j < G::kWN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[i][j][e] = __fmul_rn(decay, hacc[i][j][e]);
      if constexpr (kBf16) {
#pragma unroll
        for (int kb = 0; kb < kL / 16; ++kb) {
          const float w0 = wdec[kb * 16 + 2 * q], w1 = wdec[kb * 16 + 2 * q + 1];
          const float w2 = wdec[kb * 16 + 8 + 2 * q], w3 = wdec[kb * 16 + 9 + 2 * q];
          uint32_t xf[G::kWN][2];
          ldsm_b_t<G::kWN>(xf, xs, kLdP, kb * 16, wn * G::kWN, lane);
#pragma unroll
          for (int i = 0; i < G::kWM; ++i) {
            // (B ⊙ w)ᵀ's A fragment: B's stored (s, n) blocks read transposed
            const int n0 = (wm * G::kWM + i) * 16;
            uint32_t raw[4], ahi[4], alo[4];
            ldsm_x4_t(raw, smem_addr(bs + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * kLdN + n0 +
                                     ((lane >> 3) & 1) * 8));
            scale_split(raw[0], w0, w1, ahi[0], alo[0]);
            scale_split(raw[1], w0, w1, ahi[1], alo[1]);
            scale_split(raw[2], w2, w3, ahi[2], alo[2]);
            scale_split(raw[3], w2, w3, ahi[3], alo[3]);
#pragma unroll
            for (int j = 0; j < G::kWN; ++j) {
              mma_bf16(hacc[i][j], alo, xf[j][0], xf[j][1]);
              mma_bf16(hacc[i][j], ahi, xf[j][0], xf[j][1]);
            }
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < kL / 8; ++kk) {
          const int s0 = kk * 8 + 2 * q;
          const float w0 = wdec[s0], w1 = wdec[s0 + 1];
#pragma unroll
          for (int i = 0; i < G::kWM; ++i) {
            const int n0 = (wm * G::kWM + i) * 16;
            Split4 af;
            split_tf32(__fmul_rn(bs[s0 * kLdN + n0 + g], w0), af.big[0], af.small[0]);
            split_tf32(__fmul_rn(bs[s0 * kLdN + n0 + g + 8], w0), af.big[1], af.small[1]);
            split_tf32(__fmul_rn(bs[(s0 + 1) * kLdN + n0 + g], w1), af.big[2], af.small[2]);
            split_tf32(__fmul_rn(bs[(s0 + 1) * kLdN + n0 + g + 8], w1), af.big[3], af.small[3]);
#pragma unroll
            for (int j = 0; j < G::kWN; ++j)
              mma_3xtf32(hacc[i][j], af,
                         load_b_split(xs, kLdP, s0, (wn * G::kWN + j) * 8 + g));
          }
        }
      }
      if (ch + 1 < n_chunks) {
#pragma unroll
        for (int i = 0; i < G::kWM; ++i)
#pragma unroll
          for (int j = 0; j < G::kWN; ++j) {
            const int row = (wm * G::kWM + i) * 16 + g, col = (wn * G::kWN + j) * 8 + 2 * q;
            if constexpr (kBf16) {
              uint32_t hi0, lo0, hi1, lo1;
              split_bf16(hacc[i][j][0], hacc[i][j][1], hi0, lo0);
              split_bf16(hacc[i][j][2], hacc[i][j][3], hi1, lo1);
              *reinterpret_cast<uint32_t*>(hnext + row * kLdP + col) = hi0;
              *reinterpret_cast<uint32_t*>(hnext + (row + 8) * kLdP + col) = hi1;
              *reinterpret_cast<uint32_t*>(hnext + G::kHPart + row * kLdP + col) = lo0;
              *reinterpret_cast<uint32_t*>(hnext + G::kHPart + (row + 8) * kLdP + col) = lo1;
            } else {
              *reinterpret_cast<float2*>(hnext + row * kLdP + col) =
                  make_float2(hacc[i][j][0], hacc[i][j][1]);
              *reinterpret_cast<float2*>(hnext + (row + 8) * kLdP + col) =
                  make_float2(hacc[i][j][2], hacc[i][j][3]);
            }
          }
      }
    }
    __syncthreads();  // G is complete

    // Y = exp(cum_t) ⊙ (C·H) + G·X over the warp's 16 rows and kYN n tiles
    if (owns_y) {
      float yacc[kYN][4];
#pragma unroll
      for (int j = 0; j < kYN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      if (ch > 0) {  // H = 0 before the first chunk
        if constexpr (kBf16) {
#pragma unroll
          for (int kb = 0; kb < N / 16; ++kb) {
            uint32_t af[4], bhi[kYN][2], blo[kYN][2];
            ldsm_a(af, cs, kLdN, rw, kb * 16, lane);
            ldsm_b_t<kYN>(bhi, hcur, kLdP, kb * 16, ny0, lane);  // H's hi and lo parts
            ldsm_b_t<kYN>(blo, hcur + G::kHPart, kLdP, kb * 16, ny0, lane);
#pragma unroll
            for (int j = 0; j < kYN; ++j) {
              mma_bf16(yacc[j], af, blo[j][0], blo[j][1]);
              mma_bf16(yacc[j], af, bhi[j][0], bhi[j][1]);
            }
          }
        } else {
#pragma unroll 4
          for (int kk = 0; kk < N / 8; ++kk) {
            const Split4 af = load_a_split(cs, kLdN, t_lo, kk * 8 + 2 * q);
#pragma unroll
            for (int j = 0; j < kYN; ++j)
              mma_3xtf32(yacc[j], af,
                         load_b_split(hcur, kLdP, kk * 8 + 2 * q, (ny0 + j) * 8 + g));
          }
        }
        const float e_lo = ecum[t_lo], e_hi = ecum[t_hi];
#pragma unroll
        for (int j = 0; j < kYN; ++j) {
          yacc[j][0] = __fmul_rn(yacc[j][0], e_lo);
          yacc[j][1] = __fmul_rn(yacc[j][1], e_lo);
          yacc[j][2] = __fmul_rn(yacc[j][2], e_hi);
          yacc[j][3] = __fmul_rn(yacc[j][3], e_hi);
        }
      }
      if constexpr (kBf16) {
        for (int kc = 0; kc <= rt; ++kc) {
          uint32_t ahi[4], alo[4], bx[kYN][2];
          ldsm_a(ahi, gs, kLdG, rw, kc * 16, lane);
          ldsm_a(alo, gs + G::kGPart, kLdG, rw, kc * 16, lane);
          ldsm_b_t<kYN>(bx, xs, kLdP, kc * 16, ny0, lane);
#pragma unroll
          for (int j = 0; j < kYN; ++j) {
            mma_bf16(yacc[j], alo, bx[j][0], bx[j][1]);
            mma_bf16(yacc[j], ahi, bx[j][0], bx[j][1]);
          }
        }
      } else {
        // G's and X's fragments in the k order 0, 2, 4, 6, 1, 3, 5, 7
        for (int j = 0; j < 2 * rt + 2; ++j) {
          const Split4 af = load_a_split(gs, kLdG, t_lo, j * 8 + 2 * q);
#pragma unroll
          for (int jn = 0; jn < kYN; ++jn)
            mma_3xtf32(yacc[jn], af, load_b_split(xs, kLdP, j * 8 + 2 * q, (ny0 + jn) * 8 + g));
        }
      }
#pragma unroll
      for (int j = 0; j < kYN; ++j) {
        const int col = (ny0 + j) * 8 + 2 * q;
        if (t0 + t_lo < S) {
          T* out = yp + static_cast<int64_t>(t0 + t_lo) * st.y[2] + col;
          if constexpr (kBf16)
            *reinterpret_cast<uint32_t*>(out) = pack_bf16(yacc[j][0], yacc[j][1]);
          else
            *reinterpret_cast<float2*>(out) = make_float2(yacc[j][0], yacc[j][1]);
        }
        if (t0 + t_hi < S) {
          T* out = yp + static_cast<int64_t>(t0 + t_hi) * st.y[2] + col;
          if constexpr (kBf16)
            *reinterpret_cast<uint32_t*>(out) = pack_bf16(yacc[j][2], yacc[j][3]);
          else
            *reinterpret_cast<float2*>(out) = make_float2(yacc[j][2], yacc[j][3]);
        }
      }
    }
    if (scanner && ch + 1 < n_chunks) {
      cp_async_wait<1>();  // chunk ch + 1's a (its X, B and C may still be in flight)
      __syncwarp();
      scan_chunk(scans + ((ch + 1) & 1) * G::kScan, abuf + ((ch + 1) & 1) * kL, lane);
    }
  }

  // the terminal state, f32, this block's columns of (N, P)
  if (!owns_h) return;
  float* hp = h_out + static_cast<int64_t>(bh) * N * P + p0;
#pragma unroll
  for (int i = 0; i < G::kWM; ++i)
#pragma unroll
    for (int j = 0; j < G::kWN; ++j) {
      const int row = (wm * G::kWM + i) * 16 + g, col = (wn * G::kWN + j) * 8 + 2 * q;
      *reinterpret_cast<float2*>(hp + static_cast<int64_t>(row) * P + col) =
          make_float2(hacc[i][j][0], hacc[i][j][1]);
      *reinterpret_cast<float2*>(hp + static_cast<int64_t>(row + 8) * P + col) =
          make_float2(hacc[i][j][2], hacc[i][j][3]);
    }
}

// The widest slice a block can take: f32 at N = 128 needs twice bf16's
// stage memory, and 64 columns would not fit 227 KB.
inline int max_slice(int dtype, int n, int p) { return dtype == 0 && n == 128 && p > 32 ? 32 : p; }

// The launcher's slice count: the widest slice, halved (down to 16
// columns) while twice the blocks still fit one wave.
inline int64_t choose_slices(int dtype, int n, int p, int64_t bh, int sms) {
  int64_t slices = p / max_slice(dtype, n, p);
  while (2 * bh * slices <= sms && p / (2 * slices) >= 16) slices *= 2;
  return slices;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename T, int N, int PS>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* h, int64_t bh, int64_t heads, int64_t slices, int64_t seq,
                   const Strides& st, int vec, cudaStream_t stream) {
  using G = Geometry<T, N, PS>;
  auto kernel = ssd_chunk_kernel<T, N, PS>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<static_cast<unsigned>(bh * slices), kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(h),
      static_cast<int>(heads), static_cast<int>(slices), static_cast<int>(seq), st, vec);
  return cudaGetLastError();
}

template <typename T, int N, int P>
cudaError_t launch_slices(const void* x, const void* a, const void* b, const void* c, void* y,
                          void* h, int64_t bh, int64_t heads, int64_t slices, int64_t seq,
                          const Strides& st, int vec, cudaStream_t stream) {
  const int64_t ps = P / slices;
  if constexpr (P == 64) {
    if constexpr (!(std::is_same<T, float>::value && N == 128))
      if (ps == 64)
        return launch<T, N, 64>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
    if (ps == 32)
      return launch<T, N, 32>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  }
  if (ps == 16) return launch<T, N, 16>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_np(int n, int p, const void* x, const void* a, const void* b,
                      const void* c, void* y, void* h, int64_t bh, int64_t heads,
                      int64_t slices, int64_t seq, const Strides& st, int vec,
                      cudaStream_t stream) {
  if (n == 16 && p == 16)
    return launch_slices<T, 16, 16>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  if (n == 16 && p == 64)
    return launch_slices<T, 16, 64>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  if (n == 128 && p == 16)
    return launch_slices<T, 128, 16>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  if (n == 128 && p == 64)
    return launch_slices<T, 128, 64>(x, a, b, c, y, h, bh, heads, slices, seq, st, vec, stream);
  return cudaErrorInvalidValue;
}

// Whether every row of an operand starts on a 16-byte boundary.
inline bool rows_aligned16(const void* p, const int64_t* strides, int elsize) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((strides[i] * elsize) % 16) return false;
  return true;
}

}  // namespace repro_torch_ssd

extern "C" int64_t rt_ssd_chunk_slices(int dtype, int state, int headdim, int64_t bh) {
  using namespace repro_torch_ssd;
  return choose_slices(dtype, state, headdim, bh, sm_count());
}

extern "C" int rt_ssd_chunk(int dtype, int state, int headdim, const void* x, const void* a,
                            const void* b, const void* c, void* y, void* h, int64_t batch,
                            int64_t heads, int64_t seq, const int64_t* strides,
                            int64_t slices, void* stream) {
  using namespace repro_torch_ssd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * heads;
  if (bh == 0) return cudaGetLastError();
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if ((state != 16 && state != 128) || (headdim != 16 && headdim != 64))
    return cudaErrorInvalidValue;
  if (slices == 0) slices = choose_slices(dtype, state, headdim, bh, sm_count());
  if (slices < 1 || headdim % slices || headdim / slices < 16 ||
      headdim / slices > max_slice(dtype, state, headdim) || (slices & (slices - 1)))
    return cudaErrorInvalidValue;
  if (bh * slices > 0x7fffffff || seq > 0x7fffffff) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.a[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
  const int el = dtype == 0 ? 4 : 2;
  const int vec = rows_aligned16(x, st.x, el) && rows_aligned16(b, st.b, el) &&
                  rows_aligned16(c, st.c, el);
  if (dtype == 0)
    return launch_np<float>(state, headdim, x, a, b, c, y, h, bh, heads, slices, seq, st, vec, s);
  return launch_np<__nv_bfloat16>(state, headdim, x, a, b, c, y, h, bh, heads, slices, seq, st,
                                  vec, s);
}
