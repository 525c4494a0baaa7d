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
// The backward, fused_mlp_bwd.  It replaces the plain VJP the port ran
// before (kernels/vjp.py: ref.fused_mlp recomputed under autograd, ~34 aten
// ops and ~30 device kernels a call); the JAX package has no backward
// kernel, XLA differentiates the plain definition.  Given x, W1, b1, W2 and
// the cotangent g (R, Dout), one launch writes all five gradients:
//   pre  = x·W1 + b1            (recomputed in the forward's exact order)
//   a    = cast(0.909·pre·s),   s = σ(pre)
//   da   = g·W2ᵀ,   dpre = da ⊙ 0.909·(s + pre·s·(1 − s))
//   dW2 = aᵀg,  db2 = Σ_r g,  dW1 = xᵀ·dpre,  db1 = Σ_r dpre,  dx = dpre·W1ᵀ
// in the forward's types (bf16 with f32 arithmetic; a rounded to bf16 and
// the bf16 rounding differentiated as the identity, as autograd of the
// plain version does), every sum ascending with __fmaf_rn / __fma_rn.
// Nothing of the forward is saved: recomputing pre costs ~1/3 of the
// backward's flops and saves the forward a second output.
//
// Design.  512 threads a block; block b owns consecutive tiles of `tile`
// rows.  Per tile: x and g into shared memory; thread e -> (row, unit)
// recomputes pre and writes a and dpre to shared memory; thread e -> (row,
// input) writes dx (a row's dx depends on that row alone: bitwise the same
// whatever R); then the thread owning each element of dW1, db1, dW2, db2
// adds the tile's rows, ascending, to the block's running sum (in shared
// memory when it fits, else in the block's partial in the scratch).  W1,
// W1ᵀ, W2ᵀ and b1 are staged in shared memory when they fit (the
// transposes make every inner loop read consecutive addresses across a
// warp), else read through L1/L2 (4× slower at 17 -> 32 -> 64 on an H100).
// No atomics in any sum: each block writes its partial, fences, and takes a
// ticket (one atomicAdd on a counter, not a sum); the block that draws the
// last ticket adds the partials in ascending block order (four elements a
// thread at once, to keep loads in flight), writes dW and db, and resets
// the counter to zero for the next launch on the stream.  The plan is a
// function of (dtype, R, widths) alone, so dW and db depend on R alone and
// two launches give the same bits: the tile grows from 8 to 64 rows until
// the tiles fit 32 blocks, one tile a block (a block is one latency chain:
// on an H100 8 blocks of 8 rows beat one block of 64, and 32 blocks of 32
// rows beat 16 of 64 at R = 1024), shrunk where a smaller tile lets the
// weights be staged.  At the ELBO batch (R = 64, 17 -> 32 -> 16) that is 8
// blocks of 8 rows; at R = 1024, 32 of 32.  What bounds it is that chain:
// the launch, the staging loads, one tile's dependent sums, the fence and
// the ticket, and the last block's pass over the partials; tensor cores
// would shorten none of it at these widths (the products are ~6 MFLOP at
// R = 1024).
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
// strides.  They launch on the given stream and return cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype, width or scratch they do not take.

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

// ---- backward ------------------------------------------------------------

constexpr int kBwdThreads = 512;
constexpr int kBwdTileMin = 8;      // rows a tile: grown from 8 ...
constexpr int kBwdTileMax = 64;     // ... to 64 until the tiles fit kBwdBlocksMax blocks
constexpr int kBwdUnitsPerThread = 4;  // the row stage's (row, unit) pairs a thread, at most
constexpr int kBwdBlocksMax = 32;   // blocks (partials) a launch
constexpr int kBwdOwn = 4;          // elements a thread of the last block sums at once
constexpr int64_t kPartialBytesMax = 16 << 20;
constexpr int64_t kTicketBytes = 256;  // the ticket counter's slot before the partials
// dynamic shared memory of the backward: the static limit less the kernel's
// own static flag, so that no attribute is needed
constexpr int64_t kBwdSmemBytes = kSmemBytes - 64;

// The launch plan of one backward, a function of (dtype, R, widths) alone,
// so that the sums over rows (dW, db) depend on R and on nothing else.
struct BwdPlan {
  int tile;             // rows a tile
  int64_t tiles;        // ceil(R / tile)
  int tiles_per_block;  // consecutive tiles a block owns
  int blocks;
  bool staged;          // W1, W1ᵀ, W2ᵀ and b1 in shared memory
  bool smem_acc;        // the block's running dW/db sums in shared memory
  int64_t smem;         // dynamic shared memory bytes
  int64_t scratch;      // bytes of the scratch buffer: ticket + blocks partials
};

inline int64_t partial_elems(int din, int hidden, int dout) {
  return static_cast<int64_t>(din) * hidden + hidden + static_cast<int64_t>(hidden) * dout +
         dout;
}

template <typename T, typename Acc>
BwdPlan plan_bwd(int64_t rows, int din, int hidden, int dout) {
  BwdPlan p{};
  const int64_t row_bytes = (static_cast<int64_t>(din) + dout + 2 * hidden) * sizeof(Acc);
  const int64_t acc_bytes = partial_elems(din, hidden, dout) * static_cast<int64_t>(sizeof(Acc));
  const int64_t weight_bytes =
      (2 * static_cast<int64_t>(din) * hidden + static_cast<int64_t>(hidden) * dout + hidden) *
      static_cast<int64_t>(sizeof(T));
  // tile: one per block up to kBwdBlocksMax blocks (one tile a block is the
  // fastest a block's latency chain allows), at most kBwdUnitsPerThread
  // row-stage pairs a thread, and small enough to keep the running sums and
  // the weights in shared memory where a smaller tile lets them fit
  int tile = kBwdTileMin;
  while (tile < kBwdTileMax && static_cast<int64_t>(tile) * kBwdBlocksMax < rows) tile *= 2;
  while (tile > 1 && static_cast<int64_t>(tile) * hidden > kBwdUnitsPerThread * kBwdThreads)
    tile /= 2;
  while (tile > 1 && tile * row_bytes + acc_bytes + weight_bytes > kBwdSmemBytes &&
         (tile / 2) * row_bytes + acc_bytes + weight_bytes <= kBwdSmemBytes)
    tile /= 2;  // a smaller tile that fits the weights as well
  while (tile > 1 && tile * row_bytes > kBwdSmemBytes) tile /= 2;
  p.tile = tile;
  p.smem = tile * row_bytes;
  if (p.smem > kBwdSmemBytes) { p.blocks = 0; return p; }  // a row does not fit
  p.smem_acc = p.smem + acc_bytes <= kBwdSmemBytes;
  if (p.smem_acc) p.smem += acc_bytes;
  p.staged = p.smem + weight_bytes <= kBwdSmemBytes;
  if (p.staged) p.smem += weight_bytes;
  p.tiles = (rows + tile - 1) / tile;
  int64_t cap = kBwdBlocksMax;
  const int64_t by_bytes = kPartialBytesMax / acc_bytes;
  if (cap > by_bytes) cap = by_bytes > 0 ? by_bytes : 1;
  if (cap > p.tiles) cap = p.tiles;
  p.tiles_per_block = static_cast<int>((p.tiles + cap - 1) / cap);
  p.blocks = static_cast<int>((p.tiles + p.tiles_per_block - 1) / p.tiles_per_block);
  // partials: one a block when there are several, or the lone block's sums
  // when they do not fit in shared memory
  p.scratch = kTicketBytes + (p.blocks > 1 || !p.smem_acc ? p.blocks * acc_bytes : 0);
  return p;
}

// One backward: dx (R, Din), dW1, db1, dW2, db2 from x, W1, b1, W2 and the
// cotangent g (R, Dout; row and column strides given).  Block b owns tiles
// [b·tpb, (b+1)·tpb) of `tile` rows.  Per tile: x and g into shared memory;
// then thread e -> (row, unit) recomputes pre in the forward's order, a
// (rounded to T) and dpre; then thread e -> (row, input) writes dx; then the
// thread owning each dW/db element adds the tile's rows, ascending, to the
// block's running sum.  The last block to finish (ticket after a fence)
// adds the blocks' partials in ascending block order and writes dW/db.
template <typename T, typename Acc, bool kStaged>
__global__ void __launch_bounds__(kBwdThreads)
fused_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ g, int64_t g_rs, int64_t g_cs,
                     T* __restrict__ dx, T* __restrict__ dw1, T* __restrict__ db1,
                     T* __restrict__ dw2, T* __restrict__ db2, Acc* __restrict__ partials,
                     unsigned* __restrict__ ticket, int64_t rows, int din, int hidden,
                     int dout, int tile, int tiles_per_block, bool smem_acc) {
  extern __shared__ double smem_d[];
  Acc* xs = reinterpret_cast<Acc*>(smem_d);  // tile × Din
  Acc* gs = xs + tile * din;                 // tile × Dout
  Acc* as = gs + tile * dout;                // tile × H: a, rounded to T
  Acc* ds = as + tile * hidden;              // tile × H: dpre
  const int n_w1 = din * hidden, n_w2 = hidden * dout;
  const int pe = n_w1 + hidden + n_w2 + dout;
  Acc* acc = smem_acc ? ds + tile * hidden
                      : partials + static_cast<int64_t>(blockIdx.x) * pe;
  T* w1s = reinterpret_cast<T*>(ds + tile * hidden + (smem_acc ? pe : 0));  // Din × H
  Acc* acc_w1 = acc;                 // Din × H
  Acc* acc_b1 = acc_w1 + n_w1;       // H
  Acc* acc_w2 = acc_b1 + hidden;     // H × Dout
  Acc* acc_b2 = acc_w2 + n_w2;       // Dout
  T* w1t = w1s + n_w1;               // H × Din: W1ᵀ
  T* w2t = w1t + n_w1;               // Dout × H: W2ᵀ
  T* b1s = w2t + n_w2;

  const int tid = threadIdx.x;
  if (kStaged) {
    for (int e = tid; e < n_w1; e += kBwdThreads) w1s[e] = w1[e];
    for (int e = tid; e < n_w1; e += kBwdThreads) {  // e = k·Din + i
      const int k = e / din;
      w1t[e] = w1[(e - k * din) * hidden + k];
    }
    for (int e = tid; e < n_w2; e += kBwdThreads) {  // e = j·H + k
      const int j = e / hidden;
      w2t[e] = w2[(e - j * hidden) * dout + j];
    }
    for (int e = tid; e < hidden; e += kBwdThreads) b1s[e] = b1[e];
  }

  const int64_t tiles = (rows + tile - 1) / tile;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  for (int t = 0; t < tiles_per_block && t0 + t < tiles; ++t) {
    const int64_t row0 = (t0 + t) * tile;
    const int nr = static_cast<int>(rows - row0 < tile ? rows - row0 : tile);
    const T* xb = x + row0 * din;
    for (int e = tid; e < nr * din; e += kBwdThreads) xs[e] = load(xb + e);
    for (int e = tid; e < nr * dout; e += kBwdThreads) {
      const int r = e / dout;
      gs[e] = load(g + (row0 + r) * g_rs + static_cast<int64_t>(e - r * dout) * g_cs);
    }
    __syncthreads();

    // thread e -> (row r, unit k): pre as the forward sums it, a, dpre
    for (int e = tid; e < nr * hidden; e += kBwdThreads) {
      const int r = e / hidden;
      const int k = e - r * hidden;
      const Acc* xr = xs + r * din;
      Acc s1 = static_cast<Acc>(0);
#pragma unroll 4
      for (int i = 0; i < din; ++i) {
        const Acc w = kStaged ? to_acc(w1s[i * hidden + k]) : load(w1 + i * hidden + k);
        s1 = fma_rn(xr[i], w, s1);
      }
      const Acc pre = s1 + (kStaged ? to_acc(b1s[k]) : load(b1 + k));
      const Acc one = static_cast<Acc>(1.0);
      const Acc sg = one / (one + exp_ieee(-pre));
      const Acc ps = pre * sg;
      as[e] = to_acc(from_acc<T, Acc>(static_cast<Acc>(0.909) * ps));
      const Acc* gr = gs + r * dout;
      Acc da = static_cast<Acc>(0);
#pragma unroll 4
      for (int j = 0; j < dout; ++j) {
        const Acc w = kStaged ? to_acc(w2t[j * hidden + k]) : load(w2 + k * dout + j);
        da = fma_rn(gr[j], w, da);
      }
      ds[e] = da * (static_cast<Acc>(0.909) * (sg + ps * (one - sg)));
    }
    __syncthreads();

    // thread e -> (row r, input i): dx = dpre · W1ᵀ
    T* dxb = dx + row0 * din;
    for (int e = tid; e < nr * din; e += kBwdThreads) {
      const int r = e / din;
      const int i = e - r * din;
      const Acc* dr = ds + r * hidden;
      Acc s = static_cast<Acc>(0);
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const Acc w = kStaged ? to_acc(w1t[k * din + i]) : load(w1 + i * hidden + k);
        s = fma_rn(dr[k], w, s);
      }
      dxb[e] = from_acc<T, Acc>(s);
    }

    // the block's running sums over its rows, ascending
    for (int e = tid; e < n_w1; e += kBwdThreads) {  // e = i·H + k
      const int i = e / hidden;
      const int k = e - i * hidden;
      Acc s = t == 0 ? fma_rn(xs[i], ds[k], static_cast<Acc>(0)) : fma_rn(xs[i], ds[k], acc_w1[e]);
#pragma unroll 4
      for (int r = 1; r < nr; ++r) s = fma_rn(xs[r * din + i], ds[r * hidden + k], s);
      acc_w1[e] = s;
    }
    for (int k = tid; k < hidden; k += kBwdThreads) {
      Acc s = t == 0 ? ds[k] : acc_b1[k] + ds[k];
#pragma unroll 4
      for (int r = 1; r < nr; ++r) s = s + ds[r * hidden + k];
      acc_b1[k] = s;
    }
    for (int e = tid; e < n_w2; e += kBwdThreads) {  // e = k·Dout + j
      const int k = e / dout;
      const int j = e - k * dout;
      Acc s = t == 0 ? fma_rn(as[k], gs[j], static_cast<Acc>(0)) : fma_rn(as[k], gs[j], acc_w2[e]);
#pragma unroll 4
      for (int r = 1; r < nr; ++r) s = fma_rn(as[r * hidden + k], gs[r * dout + j], s);
      acc_w2[e] = s;
    }
    for (int j = tid; j < dout; j += kBwdThreads) {
      Acc s = t == 0 ? gs[j] : acc_b2[j] + gs[j];
#pragma unroll 4
      for (int r = 1; r < nr; ++r) s = s + gs[r * dout + j];
      acc_b2[j] = s;
    }
    __syncthreads();  // the next tile overwrites xs, gs, as, ds
  }

  if (gridDim.x == 1) {  // one block: its sums are the gradients
    for (int e = tid; e < pe; e += kBwdThreads) {
      const T v = from_acc<T, Acc>(acc[e]);
      if (e < n_w1) dw1[e] = v;
      else if (e < n_w1 + hidden) db1[e - n_w1] = v;
      else if (e < n_w1 + hidden + n_w2) dw2[e - n_w1 - hidden] = v;
      else db2[e - n_w1 - hidden - n_w2] = v;
    }
    return;
  }
  Acc* mine = partials + static_cast<int64_t>(blockIdx.x) * pe;
  if (smem_acc)
    for (int e = tid; e < pe; e += kBwdThreads) mine[e] = acc[e];
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;  // a ticket, not a sum
  __syncthreads();
  if (!last) return;
  __threadfence();
  // kBwdOwn elements a thread at a time, so that as many loads are in
  // flight; each element's partials added in ascending block order
  const int nb = gridDim.x;
  for (int e0 = tid; e0 < pe; e0 += kBwdThreads * kBwdOwn) {
    Acc s[kBwdOwn];
#pragma unroll
    for (int q = 0; q < kBwdOwn; ++q) {
      const int e = e0 + q * kBwdThreads;
      s[q] = e < pe ? __ldcg(partials + e) : static_cast<Acc>(0);
    }
#pragma unroll 2
    for (int b = 1; b < nb; ++b) {
      const Acc* pb = partials + static_cast<int64_t>(b) * pe;
#pragma unroll
      for (int q = 0; q < kBwdOwn; ++q) {
        const int e = e0 + q * kBwdThreads;
        if (e < pe) s[q] = s[q] + __ldcg(pb + e);
      }
    }
#pragma unroll
    for (int q = 0; q < kBwdOwn; ++q) {
      const int e = e0 + q * kBwdThreads;
      if (e >= pe) break;
      const T v = from_acc<T, Acc>(s[q]);
      if (e < n_w1) dw1[e] = v;
      else if (e < n_w1 + hidden) db1[e - n_w1] = v;
      else if (e < n_w1 + hidden + n_w2) dw2[e - n_w1 - hidden] = v;
      else db2[e - n_w1 - hidden - n_w2] = v;
    }
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch on this stream
}

template <typename T, typename Acc>
cudaError_t launch_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* g, int64_t g_rs, int64_t g_cs, void* dx, void* dw1,
                       void* db1, void* dw2, void* db2, void* scratch, int64_t scratch_bytes,
                       int64_t rows, int din, int hidden, int dout, cudaStream_t stream) {
  const BwdPlan p = plan_bwd<T, Acc>(rows, din, hidden, dout);
  if (p.blocks <= 0 || scratch == nullptr || p.scratch > scratch_bytes)
    return cudaErrorInvalidValue;
  unsigned* ticket = static_cast<unsigned*>(scratch);
  Acc* partials = reinterpret_cast<Acc*>(static_cast<char*>(scratch) + kTicketBytes);
  const T* px = static_cast<const T*>(x);
  const T* pw1 = static_cast<const T*>(w1);
  const T* pb1 = static_cast<const T*>(b1);
  const T* pw2 = static_cast<const T*>(w2);
  const T* pg = static_cast<const T*>(g);
  T* pdx = static_cast<T*>(dx);
  T* pdw1 = static_cast<T*>(dw1);
  T* pdb1 = static_cast<T*>(db1);
  T* pdw2 = static_cast<T*>(dw2);
  T* pdb2 = static_cast<T*>(db2);
  if (p.staged) {
    fused_mlp_bwd_kernel<T, Acc, true><<<p.blocks, kBwdThreads, p.smem, stream>>>(
        px, pw1, pb1, pw2, pg, g_rs, g_cs, pdx, pdw1, pdb1, pdw2, pdb2, partials, ticket, rows,
        din, hidden, dout, p.tile, p.tiles_per_block, p.smem_acc);
  } else {
    fused_mlp_bwd_kernel<T, Acc, false><<<p.blocks, kBwdThreads, p.smem, stream>>>(
        px, pw1, pb1, pw2, pg, g_rs, g_cs, pdx, pdw1, pdb1, pdw2, pdb2, partials, ticket, rows,
        din, hidden, dout, p.tile, p.tiles_per_block, p.smem_acc);
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

namespace repro_torch_mlp {
// The backward's plan for a dtype code (blocks 0 for a dtype or width it
// does not take).
inline BwdPlan plan_for(int dtype, int64_t rows, int din, int hidden, int dout) {
  if (rows <= 0 || din <= 0 || hidden <= 0 || dout <= 0) return BwdPlan{};
  if (dtype == 0) return plan_bwd<float, float>(rows, din, hidden, dout);
  if (dtype == 1) return plan_bwd<__nv_bfloat16, float>(rows, din, hidden, dout);
  if (dtype == 2) return plan_bwd<double, double>(rows, din, hidden, dout);
  return BwdPlan{};
}
}  // namespace repro_torch_mlp

// Scratch bytes rt_fused_mlp_bwd needs for (dtype, R, widths), or -1 for a
// dtype or width it does not take.  The scratch holds the ticket counter,
// zero before a launch and zero after it, then the partials: give each
// stream its own.
extern "C" int64_t rt_fused_mlp_bwd_scratch(int dtype, int64_t rows, int din, int hidden,
                                            int dout) {
  const auto p = repro_torch_mlp::plan_for(dtype, rows, din, hidden, dout);
  return p.blocks > 0 ? p.scratch : -1;
}

// The number of blocks rt_fused_mlp_bwd launches for (dtype, R, widths).
extern "C" int64_t rt_fused_mlp_bwd_blocks(int dtype, int64_t rows, int din, int hidden,
                                           int dout) {
  return repro_torch_mlp::plan_for(dtype, rows, din, hidden, dout).blocks;
}

extern "C" int rt_fused_mlp_bwd(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* g, int64_t g_rs, int64_t g_cs,
                                void* dx, void* dw1, void* db1, void* dw2, void* db2,
                                void* scratch, int64_t scratch_bytes, int64_t rows, int din,
                                int hidden, int dout, void* stream) {
  using namespace repro_torch_mlp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || din <= 0 || hidden <= 0 || dout <= 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float, float>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2, db2,
                                    scratch, scratch_bytes, rows, din, hidden, dout, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, float>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2,
                                            db2, scratch, scratch_bytes, rows, din, hidden,
                                            dout, s);
  if (dtype == 2)
    return launch_bwd<double, double>(x, w1, b1, w2, g, g_rs, g_cs, dx, dw1, db1, dw2, db2,
                                      scratch, scratch_bytes, rows, din, hidden, dout, s);
  return cudaErrorInvalidValue;
}
