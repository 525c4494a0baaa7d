// Causal or full GQA attention with an online softmax, for Hopper.
//
// Replaces the Pallas kernel flash_attention of the JAX package:
//   src/repro/kernels/flash_attention.py:67 (kernel body :27-64)
// It computes what that kernel computes: q (B, Hq, S, D), k and v
// (B, Hkv, Sk, D) with Hq % Hkv == 0; query head h reads KV head
// h / (Hq/Hkv) in place, with no repeat copy.  The key length Sk is the
// query length S for self-attention and its own for the encoder-decoder's
// cross-attention (decoder rows against the encoder's frames, never causal:
// causal with Sk != S is refused).  The Pallas wrapper derives its key block
// and grid from S (flash_attention.py:84-90) and so assumes Sk == S; here
// the KV loop, the tensor maps and the ragged mask run on Sk, which is what
// the reference's CPU path (blockwise_attention) computes.  Per query row:
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
// Layout.  Every operand is read through its strides (batch, head, row; the
// last axis contiguous, the others multiples of 8 elements, the base
// 16-byte aligned), so the LM's (B, S, H, D) projections go in as their
// (B, H, S, D) transposed views with no copy, and o is written through its
// strides (the launcher hands in a (B, S, Hq, D) buffer's transposed view).
// The TPU kernel runs the KV axis as its sequential innermost grid
// dimension and carries (m, l, acc) in VMEM scratch between grid steps.
// Blocks on Hopper run in no order, so here one thread block owns a
// (batch, query head, query tile) at a time and loops over the KV tiles
// itself, carrying (m, l, acc) in registers.  Under `causal` it stops at the
// diagonal tile (the TPU kernel's `needed` skip) and masks only that tile;
// it masks the ragged last tile itself (columns past S score -inf) where
// the JAX wrapper halves its block until it divides S.  The results are the
// same function.  Query tiles are issued last-first, so the long causal
// rows start first.  No atomics and no split over the KV axis: two
// launches on the same inputs give the same bits.
//
// bfloat16: warpgroup MMA fed by TMA (flash_attention_wgmma).  Persistent:
// one block of 288 threads an SM walks work items of 128 query rows, the
// longest causal ones first, dealt to the blocks in a zigzag (block c takes
// item c, then the round's G - 1 - c, ...) so the falling lengths even
// out.  Two consumer warpgroups own 64 rows each (wgmma's M); one producer
// warp's lane 0 loads each item's Q tile into one of two Q buffers and the
// 128-row K and V tiles into a ring of 2 (D = 128) or 3 stages in shared
// memory with cp.async.bulk.tensor (TMA; one 4-D tensor map per operand
// over (D, S, H, B) with the operand's strides, made on the host for each
// call), running ahead across items, so one item's epilogue overlaps the
// next one's loads.  Each buffer is signalled on an mbarrier by the bytes
// that landed and released by the 256 consumer threads once their products
// have read it.  Tiles are 128-byte swizzled (64-column blocks, two at
// D = 128), 32-byte swizzled at D = 16, so the wgmma shared-memory
// descriptors read them without bank conflicts.  Per KV tile each consumer
// warpgroup issues
//   S = Q.K^T   wgmma m64n128k16, A = Q and B = K from shared memory, both
//               K-major (D contiguous), f32 accumulators in registers;
//   softmax     on the accumulator fragment: a thread holds 2 rows x 32
//               columns; for a positive scale the exponent is one fused
//               multiply-add s·(scale·log2 e) − m', and exp2 runs on the MUFU
//               (ex2.approx); the row max reduces over the 4 lanes of a row
//               (two xor shuffles); row sums stay per thread until the end;
//               the mask runs on edge tiles only; a warp whose maxima did
//               not move skips rescaling O;
//   O += P.V    wgmma m64nDk16 with A = P from registers (the S fragment
//               rounded to bf16 pairs is exactly wgmma's A fragment, which
//               is the rounding p.astype(v.dtype) asks for) and B = V from
//               shared memory with the transpose bit (V is (keys, D), D
//               contiguous: MN-major).
// At D <= 64 the two warpgroups ping-pong: each issues its tile's Q.K^T
// together with the previous tile's P.V, hands the tensor cores to the
// other through a named barrier, and runs its softmax while both products
// run; at tinyllama's bf16 training shape (D = 64) that is 7% faster than
// back to back (PERF.md), and D = 16 shares it untimed.  At D = 128 that
// schedule holds S, the previous P and O at once (~190 registers a thread)
// while ptxas gives a block of more than 256 threads at most 168
// (setmaxnreg does not raise its allocation): it spilled and serialised the
// wgmma, and ran slower, so D = 128 runs each warpgroup's products back to
// back and leaves the overlap to the two warpgroups' independent progress.
// At D = 96 (MLA's concatenated 64 + 32 head) the back-to-back schedule
// runs too, with tiles 64-byte swizzled: three 32-column blocks, Q.K^T as
// six k-steps of m64n128k16 and P.V as m64n96k16.  ptxas gives it 145
// registers and no spill; the ping-pong schedule at D = 96 holds S, P and
// a 48-register O at once and spilled 84 bytes at 168 registers with its
// wgmma serialised (C7512; PERF.md, PR 34).  The one argument it added
// (the key length) moved D = 64's ping-pong kernel from 168 registers and
// no spill to an 8-byte spill, at no measured cost (the same PR).
// Columns past Sk are -inf and TMA zero-fills rows past S (past Sk for K
// and V), so a ragged edge needs no separate path; rows past S are not
// stored.
//
// float32: split TF32 on the tensor cores (flash_attention_f32).  Before,
// both products ran as __fmaf_rn on CUDA cores fed from shared memory (a
// thread owned 8 rows x 4 score columns), with synchronous loads and three
// barriers a tile: 2.2050 ms at tinyllama-1.1b's training shape (B 4, Hq 32,
// Hkv 4, S 2048, D 64, causal), 2.15x the 67 TFLOP/s f32 bound of 1.026 ms
// (PERF.md).  Now both products run on mma.sync.m16n8k8 TF32 tensor cores
// as three products of split halves (split_tf32: big = rna(x), small =
// x - big; small·big + big·small + big·big into f32 accumulators), which
// lands within ~5·2^-22 of each f32 product: f32 accuracy, held to 2e-5
// (tests/test_torch_attention.py emulates it; one TF32 product alone is
// ~1e-3 off).  wgmma takes TF32 only with both operands K-major, and V,
// (keys, D), is MN-major, hence mma.sync.  One block of 128 threads (4
// warps) owns 128 query rows at D <= 64 (32 a warp, two m16 tiles, so each
// split K or V fragment feeds two products) and 64 at D = 96 and 128 (16 a
// warp: two tiles would need ~240 registers at D = 128, and at D = 96 96
// accumulators and 64 scores a thread besides the fragments).  K and V tiles of 64 keys are
// double-buffered in shared memory by cp.async, one tile ahead, behind two
// barriers a tile; Q's fragments are loaded and split from shared memory a
// k-step at a time (at D = 128 they would not fit in registers, and at
// D <= 64 two tiles' worth would not either).  Q.K^T sums over D in the k
// order 0, 2, 4, 6, 1, 3, 5, 7 of each 8, so a thread's two columns are one
// 64-bit load; Q and K rows are D + 8 floats apart, V rows D + 4 (at every
// D taken, D + 8 ≡ 8 and 2·(D + 4) ≡ 8 mod 32 banks), so every fragment
// load is free of bank conflicts.  P stays f32 (the TPU kernel's
// p.astype(v.dtype) is a no-op in f32) and never leaves registers: read in
// the k order above, the S accumulator fragment is P.V's A fragment as it
// stands, and V's B fragment reads keys 2t and 2t + 1.  The softmax runs
// on the fragment in base 2 (ex2.approx on the MUFU, the scale folded into
// log2 e), row maxima over the 4 lanes of a row; a warp skips a tile whose
// keys all lie past its rows under the causal mask.  Bound: 3 x 4·D flops
// per unmasked pair on TF32 tensor cores, 0.4167 ms at the training shape
// (495 TFLOP/s); the CUDA-core bound it replaces is 1.0262 ms.  ptxas
// (-Xptxas -v): 226 registers at D = 64, 190 at 128, 168 at 16, no spills;
// dynamic shared memory 108,544 / 172,032 / 34,816 bytes, so 2, 1 and 3
// blocks an SM.  What bounds it now (1.36 ms at the training shape, 3.3x
// its bound): about five other instructions issue for each HMMA (three a
// split, the fragment loads, the softmax), and at two warps a scheduler
// (the registers) the tensor pipe waits on them.  Left on the table:
// splitting K and V once a tile into shared memory (each warp splits them
// again now; it needs 2x the tile memory) and a wgmma design with V
// transposed in shared memory.
//
// Held to a tolerance against the plain version (f32 2e-5, bf16 6e-2), not
// bitwise, since each sums in another order.
//
// Bound.  At the prefill shape of qwen2.5-14b (B = 4, Hq = 40, Hkv = 8,
// S = 2048, D = 128, bf16, causal) the work is 2·B·Hq·S²·D = 1.72e11 flops
// with the masked half skipped, against 201 MB of Q, K, V and O: bound by
// operations, 0.174 ms at the 989 TFLOP/s of bf16 tensor cores (the bytes
// alone take 0.060 ms).  What held the earlier CUDA-core bf16 design back,
// and what this one does about it:
//   - no tensor core (both products as f32 FMAs, a 67 TFLOP/s ceiling,
//     15x the bound): both products are wgmma;
//   - Q, K, V and P staged as f32 in shared memory (85 KB at D = 128, two
//     blocks an SM, shared-memory reads feeding every FMA): the tiles stay
//     bf16 in shared memory and are read by the tensor cores through
//     swizzled descriptors, and P never leaves registers;
//   - synchronous loads with three __syncthreads a tile: a producer warp
//     keeps the next K and V tiles in flight by TMA behind mbarriers while
//     the consumers compute, and the consumers never meet at a block
//     barrier;
//   - 64-row tiles: 128-row query and KV tiles, so each K and V byte read
//     from L2 feeds twice the MMA work.
// What bounds this design: the softmax.  With the softmax cut out the
// products alone run at about the speed of PyTorch's SDPA; with them cut
// out the softmax alone takes longer than the whole kernel.  The 64
// exponentials a thread a tile (~0.09 ms at this shape on 16 MUFU lanes an
// SM) and the dependent max and sum chains of two warps an SM sub-partition
// are what is left to hide.  Skipping TMA loads altogether changes nothing:
// the loads are hidden.  Left on the table: an overlapped schedule at
// D = 128 that fits 168 registers (P through shared memory), and a TMA
// store of O.
//
// Interface: a plain C function (loaded with ctypes by kernels/build.py),
// dtype code 0 = float32, 1 = bfloat16, strides (in elements) of q, k, v
// and o as (batch, head, row) triples, the query length and the key length.
// It launches on the given stream
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype,
// head dimension or layout it does not take.  The tensor maps are encoded
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace repro_torch_attention {

using namespace repro_torch_tc;

constexpr float kMasked = -1e30f;     // the TPU kernel's NEG_INF

// Strides of one operand in elements: batch, head, row (the last axis is
// contiguous).
struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// bfloat16: warpgroup MMA fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                       // query rows a work item
constexpr int kBN = 128;                       // K and V rows a tile
constexpr int kWgRows = 64;                    // query rows a consumer warpgroup
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 32;    // and one producer warp

// Shared-memory geometry at head dim D.  A tile is kBlocks column blocks of
// its rows x kRowBytes, each swizzled over its kRowBytes rows: 128-byte
// blocks (64 columns) where D is a multiple of 64, 64-byte blocks (32
// columns, three at D = 96), 32-byte at D = 16.
template <int D>
struct Geometry {
  static constexpr int kRowBytes = D % 64 == 0 ? 128 : (D % 32 == 0 ? 64 : 32);  // swizzle span
  // descriptor code: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr int kBoxCols = kRowBytes / 2;            // bf16 columns a block
  static constexpr int kBlocks = D / kBoxCols;
  static constexpr int kKSteps = kRowBytes / 32;            // k16 steps a column block
  static constexpr int kQBlockBytes = kBM * kRowBytes;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBlockBytes = kBN * kRowBytes;
  static constexpr int kKVBytes = kBN * D * 2;
  // two Q buffers, the K and V rings, their barriers, and slack to align
  // the base to 1 KB
  static constexpr int smem(int stages) {
    return 2 * kQBytes + 2 * stages * kKVBytes + 8 * (4 + 2 * stages) + 1024;
  }
  static_assert(D % kBoxCols == 0 && kKVBytes % 1024 == 0, "tile geometry");
};

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes count against the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), swizzle code in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Pins register operands of wgmma in program order: after a wait, reads
// of the accumulators stay after it; before a wgmma.fence, writes to the
// accumulators and to A stay before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D (64 x 128, f32) += A (64 x 16, shared) . B (16 x 128, shared), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, f32) += A (64 x 16, registers) . B (16 x 16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A (64 x 16, registers) . B (16 x 96, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (64 x kBN) = Q_wg . K^T over D, Q and K from shared memory (K-major).
template <int D>
__device__ __forceinline__ void scores(float (&s)[kBN / 2], uint32_t q_wg, uint32_t k_tile) {
  using G = Geometry<D>;
  constexpr uint32_t kSbo = 8 * G::kRowBytes;  // next 8-row group
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / G::kKSteps, k32 = (kk % G::kKSteps) * 32;
    wgmma_ss(s, smem_desc(q_wg + c * G::kQBlockBytes + k32, 16, kSbo, G::kSwizzle),
             smem_desc(k_tile + c * G::kKVBlockBytes + k32, 16, kSbo, G::kSwizzle), kk > 0);
  }
}

// O (64 x D) += P . V over the tile's kBN keys, P from registers, V from
// shared memory (MN-major: the transpose bit).
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 2], const uint32_t (&p)[kBN / 16][4],
                                              uint32_t v_tile) {
  using G = Geometry<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_rs(o, p[kk],
             smem_desc(v_tile + kk * 16 * G::kRowBytes, G::kKVBlockBytes, 8 * G::kRowBytes,
                       G::kSwizzle));
}

// Named barrier `id` over both consumer warpgroups: wait for the other's
// arrival, or signal it.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One tile's online-softmax step on the score fragment, in place: s (raw
// scores, s[4j + 2r + e] at row row0 + 8r, column k0 + 8j + col0 + e)
// becomes p = exp2(s·c − m') with c = scale·log2 e, f32; m (in units of
// s·c) and l advance; alpha is the factor the accumulator takes before this
// tile's P.V.  Only an edge tile (the causal diagonal, the ragged end of
// the Sk keys) pays for the mask.  For c > 0 the row maximum is taken on the raw scores (the
// rounded c·max s is the maximum of the rounded c·s, rounding being
// monotone), and each exponent is one fused multiply-add.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k0, int row0,
                                             int col0, int Sk, int causal, float c) {
  const bool fused = c > 0.f;  // the same for every thread
  if (!fused) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = __fmul_rn(s[i], c);
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = k0 + 8 * (i / 4) + col0 + i % 2;
      if (col >= Sk || (causal && col > row0 + 8 * ((i / 2) % 2))) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], fused ? __fmul_rn(mx[r], c) : mx[r]);
    mb[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_approx(__fsub_rn(m[r], mb[r]));
    m[r] = m_new;
    l[r] = __fmul_rn(l[r], alpha[r]);
  }
  if (fused) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_approx(__fmaf_rn(s[i], c, -mb[r]));
      l[r] = __fadd_rn(l[r], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_approx(__fsub_rn(s[i], mb[r]));
      l[r] = __fadd_rn(l[r], s[i]);
    }
  }
}

// acc *= alpha by rows; skipped by a warp whose maxima did not move (a
// product by 1 is exact, so the bits are the same).
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
  if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = __fmul_rn(acc[i], alpha[(i / 2) % 2]);
}

// p rounded to bf16 pairs: the k16 steps' A fragments (step kk holds the
// 16 keys of the accumulator's chunks 2kk and 2kk + 1).
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N], uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) p[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
}

// Work items (batch, query head, query tile) are numbered longest causal
// tile first, heads fastest.  Block c takes item c in round 0, G - 1 - c in
// round 1, then c again (k·G + c or k·G + G − 1 − c in round k, G blocks):
// the zigzag evens out the rounds' falling lengths between blocks.
__device__ __forceinline__ int item_index(int round) {
  const int G = gridDim.x, c = blockIdx.x;
  return round * G + (round % 2 == 0 ? c : G - 1 - c);
}

struct Item {
  int h, b, q0, n_tiles;
};

// KV tiles over the Sk keys (under `causal`, Sk == S).
__device__ __forceinline__ Item item_at(int w, int Hq, int B, int n_qt, int Sk, int causal) {
  const int qt = n_qt - 1 - w / (Hq * B), r = w % (Hq * B);
  const int q0 = qt * kBM, kv_tiles = (Sk + kBN - 1) / kBN;
  return Item{r % Hq, r / Hq, q0, causal ? min(kv_tiles, (q0 + kBM) / kBN) : kv_tiles};
}

template <int D, int kStages, bool kPipelined>
__device__ __forceinline__ void consume(uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                        uint32_t q_full0, uint32_t q_empty0, uint32_t full0,
                                        uint32_t empty0, __nv_bfloat16* __restrict__ o,
                                        Strides so, int S, int Sk, int Hq, int B, int n_qt,
                                        int causal, float scale_log2) {
  using G = Geometry<D>;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row_in_block = wg * kWgRows + (t / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int n_items = n_qt * Hq * B;
  int tile = 0;  // this block's K/V tiles so far: the ring's stage and phase
  if (kPipelined && wg == 1) named_arrive(1);
  for (int it = 0; item_index(it) < n_items; ++it) {
    const Item item = item_at(item_index(it), Hq, B, n_qt, Sk, causal);
    const bool last_item = item_index(it + 1) >= n_items;
    const int q0 = item.q0, n_tiles = item.n_tiles, row0 = q0 + row_in_block;
    const uint32_t qb = it & 1, q_wg = q_s + qb * G::kQBytes + wg * kWgRows * G::kRowBytes;
    auto edge = [&](int kt) {
      return (causal && (kt + 1) * kBN - 1 > q0) || (kt + 1) * kBN > Sk;
    };
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float s[kBN / 2];
    uint32_t p[kBN / 16][4];

    mbar_wait(q_full0 + 8 * qb, (it >> 1) & 1);
    if (kPipelined) {
      // each warpgroup in turn issues this tile's Q.K^T and the previous
      // tile's P.V, hands the tensor cores to the other by a named barrier,
      // and runs its softmax while both products run
      int st = tile % kStages;
      mbar_wait(full0 + 8 * st, (tile / kStages) & 1);
      named_sync(1 + wg);
      fence_regs(s);
      wgmma_fence();
      scores<D>(s, q_wg, k_s + st * G::kKVBytes);
      wgmma_commit();
      if (wg == 0 || !(last_item && n_tiles == 1)) named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1) mbar_arrive(q_empty0 + 8 * qb);
      softmax_tile(s, m, l, alpha, edge(0), 0, row0, col0, Sk, causal, scale_log2);
      pack_p(s, p);
      for (int kt = 1; kt < n_tiles; ++kt) {
        const int prev = st;
        st = (tile + kt) % kStages;
        mbar_wait(full0 + 8 * st, ((tile + kt) / kStages) & 1);
        named_sync(1 + wg);
        fence_regs(s);
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
        scores<D>(s, q_wg, k_s + st * G::kKVBytes);
        wgmma_commit();
        accumulate_pv<D>(acc, p, v_s + prev * G::kKVBytes);
        wgmma_commit();
        if (wg == 0 || !(last_item && kt + 1 == n_tiles)) named_arrive(2 - wg);
        wgmma_wait<1>();
        fence_regs(s);
        if (kt + 1 == n_tiles) mbar_arrive(q_empty0 + 8 * qb);
        softmax_tile(s, m, l, alpha, edge(kt), kt * kBN, row0, col0, Sk, causal, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty0 + 8 * prev);
        rescale<D>(acc, alpha);
        pack_p(s, p);
      }
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      accumulate_pv<D>(acc, p, v_s + st * G::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * st);
    } else {
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = (tile + kt) % kStages;
        mbar_wait(full0 + 8 * st, ((tile + kt) / kStages) & 1);
        fence_regs(s);
        wgmma_fence();
        scores<D>(s, q_wg, k_s + st * G::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (kt + 1 == n_tiles) mbar_arrive(q_empty0 + 8 * qb);
        softmax_tile(s, m, l, alpha, edge(kt), kt * kBN, row0, col0, Sk, causal, scale_log2);
        rescale<D>(acc, alpha);
        pack_p(s, p);
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
        accumulate_pv<D>(acc, p, v_s + st * G::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty0 + 8 * st);
      }
    }
    tile += n_tiles;

    __nv_bfloat16* ob = o + item.b * so.b + item.h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + 8 * j + col0) =
            __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * r], denom),
                                  __fdiv_rn(acc[4 * j + 2 * r + 1], denom));
    }
  }
}

// Persistent: one block an SM walks its work items; the producer loads the
// next item's Q into the other of two Q buffers and keeps the K/V ring full
// across items, so one item's epilogue and the next one's first loads
// overlap.
template <int D, int kStages, bool kPipelined>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      Strides so, int S, int Sk, int Hq, int B, int group, int causal,
                      float scale_log2) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // two Q buffers
  const uint32_t k_s = q_s + 2 * G::kQBytes;              // stage i at + i * kKVBytes
  const uint32_t v_s = k_s + kStages * G::kKVBytes;
  const uint32_t q_full0 = v_s + kStages * G::kKVBytes;  // q_full[2], q_empty[2],
  const uint32_t q_empty0 = q_full0 + 16;                 // full[i], empty[i]
  const uint32_t full0 = q_empty0 + 16, empty0 = full0 + 8 * kStages;
  const int n_qt = (S + kBM - 1) / kBM, n_items = n_qt * Hq * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: lane 0 issues every load
    if (threadIdx.x == kConsumers) {
      int tile = 0;
      for (int it = 0; item_index(it) < n_items; ++it) {
        const Item item = item_at(item_index(it), Hq, B, n_qt, Sk, causal);
        const int qb = it & 1, hk = item.h / group;
        if (it >= 2) mbar_wait(q_empty0 + 8 * qb, ((it >> 1) - 1) & 1);
        mbar_expect_tx(q_full0 + 8 * qb, G::kQBytes);
        for (int c = 0; c < G::kBlocks; ++c)
          tma_load(q_s + qb * G::kQBytes + c * G::kQBlockBytes, &tq, q_full0 + 8 * qb,
                   c * G::kBoxCols, item.q0, item.h, item.b);
        for (int kt = 0; kt < item.n_tiles; ++kt, ++tile) {
          const int st = tile % kStages;
          if (tile >= kStages) mbar_wait(empty0 + 8 * st, (tile / kStages - 1) & 1);
          const uint32_t full = full0 + 8 * st;
          mbar_expect_tx(full, 2 * G::kKVBytes);
          for (int c = 0; c < G::kBlocks; ++c) {
            const uint32_t off = st * G::kKVBytes + c * G::kKVBlockBytes;
            tma_load(k_s + off, &tk, full, c * G::kBoxCols, kt * kBN, hk, item.b);
            tma_load(v_s + off, &tv, full, c * G::kBoxCols, kt * kBN, hk, item.b);
          }
        }
      }
    }
  } else {
    consume<D, kStages, kPipelined>(q_s, k_s, v_s, q_full0, q_empty0, full0, empty0, o, so,
                                    S, Sk, Hq, B, n_qt, causal, scale_log2);
  }
}

// cuTensorMapEncodeTiled, looked up once through cudaGetDriverEntryPoint.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over (D, S, H, B) with the operand's strides (S its own row
// count: the query or the key length); boxes of kBoxCols x rows x 1 x 1,
// zero-filled past S.
template <int D>
bool encode(CUtensorMap* map, const void* base, Strides st, int64_t S, int64_t H, int64_t B,
            int rows) {
  using G = Geometry<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {G::kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, G::kTmaSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int kStages, bool kPipelined>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const Strides* st, int64_t B, int64_t Hq, int64_t Hkv, int64_t S,
                        int64_t Sk, int causal, float scale, cudaStream_t stream) {
  using G = Geometry<D>;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, st[0], S, Hq, B, kBM) || !encode<D>(&tk, k, st[1], Sk, Hkv, B, kBN) ||
      !encode<D>(&tv, v, st[2], Sk, Hkv, B, kBN))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma<D, kStages, kPipelined>;
  constexpr int smem = G::smem(kStages);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const int64_t items = (S + kBM - 1) / kBM * Hq * B;
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  kernel<<<static_cast<unsigned>(items < sms ? items : sms), kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], static_cast<int>(S),
      static_cast<int>(Sk), static_cast<int>(Hq), static_cast<int>(B), static_cast<int>(Hq / Hkv), causal,
      scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;  // K and V rows a tile
constexpr int kF32Threads = 128;

// Geometry at head dim D.  A warp owns kM m16 row tiles (two at D <= 64, so
// each split K or V fragment feeds two products; one at D = 128, where two
// would need ~240 registers), a block 4 warps.  Shared tiles: Q's, then two
// stages of (K, V).  Q and K rows are kLdQK = D + 8 floats apart (≡ 8 mod 32
// banks), so the 64-bit fragment loads of Q.K^T (8 rows x 4 column pairs a
// warp) hit distinct banks in each half-warp; V rows are kLdV = D + 4 apart
// (2·kLdV ≡ 8 mod 32), so P.V's loads (4 row pairs x 8 columns) do too.
template <int D>
struct F32Geometry {
  static constexpr int kM = D <= 64 ? 2 : 1;
  static constexpr int kWarpRows = 16 * kM;
  static constexpr int kRows = 4 * kWarpRows;                     // query rows a block
  static constexpr int kLdQK = D + 8, kLdV = D + 4;
  static constexpr int kKTile = kF32Keys * kLdQK, kVTile = kF32Keys * kLdV;  // floats
  static constexpr int kStage = kKTile + kVTile;
  static constexpr int kSmem = (kRows * kLdQK + 2 * kStage) * static_cast<int>(sizeof(float));
  static_assert(kRows % kF32Keys == 0, "query tiles are whole key tiles");
};

// Rows row0 .. row0 + kRowsT - 1 of one head's (S, D) slab, rows `ld`
// elements apart, into a tile at `dst` with rows kLdT apart; rows at or
// past S are zero.
template <int D, int kRowsT, int kLdT>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                int64_t ld, int row0, int S) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kRowsT * kVec; idx += kF32Threads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    const bool in = row0 + r < S;
    cp_async16(smem_addr(dst + r * kLdT + c),
               in ? src + static_cast<int64_t>(row0 + r) * ld + c : src, in ? 16 : 0);
  }
}

// Q.K^T sums over D in the k order 0, 2, 4, 6, 1, 3, 5, 7 of each 8: a
// thread's k = t and t + 4 are columns 2t and 2t + 1, one 64-bit load.
// The A fragment of Q rows (row, row + 8) at columns (col, col + 1), split.
template <int kLd>
__device__ __forceinline__ Split4 load_q_split(const float* tile, int row, int col) {
  const float2 lo = *reinterpret_cast<const float2*>(tile + row * kLd + col);
  const float2 hi = *reinterpret_cast<const float2*>(tile + (row + 8) * kLd + col);
  Split4 a;
  split_tf32(lo.x, a.big[0], a.small[0]);
  split_tf32(hi.x, a.big[1], a.small[1]);
  split_tf32(lo.y, a.big[2], a.small[2]);
  split_tf32(hi.y, a.big[3], a.small[3]);
  return a;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, Strides sq,
                    Strides sk, Strides sv, Strides so, int S, int Sk, int group, int causal,
                    float scale_log2) {
  using G = F32Geometry<D>;
  constexpr int kM = G::kM, kLdQK = G::kLdQK, kLdV = G::kLdV;
  constexpr int kDSteps = D / 8;           // k-steps of Q.K^T, n-tiles of P.V
  constexpr int kKeySteps = kF32Keys / 8;  // n-tiles of Q.K^T, k-steps of P.V
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kv0 = qs + G::kRows * kLdQK;  // stage st: K at kv0 + st·kStage, V kKTile after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the long causal rows first
  const int q0 = qt * G::kRows;
  const int wrow = warp * G::kWarpRows;       // the warp's first row in the tile
  const int first = q0 + wrow, last = first + G::kWarpRows - 1;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  const int kv_tiles = (Sk + kF32Keys - 1) / kF32Keys;  // under `causal`, Sk == S
  const int n_tiles = causal ? min(kv_tiles, (q0 + G::kRows) / kF32Keys) : kv_tiles;

  // two cp.async groups a tile, K then V, one tile ahead
  load_tile_async<D, G::kRows, kLdQK>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile_async<D, kF32Keys, kLdQK>(kv0, kb, sk.s, 0, Sk);
  cp_async_commit();
  load_tile_async<D, kF32Keys, kLdV>(kv0 + G::kKTile, vb, sv.s, 0, Sk);
  cp_async_commit();

  float acc[kM][kDSteps][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < kDSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  // m in units of s·scale·log2 e; l sums this thread's columns only
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
    m[mi][0] = m[mi][1] = kMasked;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const float* kst = kv0 + (kt & 1) * G::kStage;
    const float* vst = kst + G::kKTile;
    const int k0 = kt * kF32Keys;
    cp_async_wait<1>();  // K (and Q) of this tile landed
    __syncthreads();     // ... for every thread, and every warp is done with tile kt - 1
    if (kt + 1 < n_tiles) {
      float* next = kv0 + ((kt + 1) & 1) * G::kStage;
      load_tile_async<D, kF32Keys, kLdQK>(next, kb, sk.s, k0 + kF32Keys, Sk);
      cp_async_commit();
      load_tile_async<D, kF32Keys, kLdV>(next + G::kKTile, vb, sv.s, k0 + kF32Keys, Sk);
    } else {
      cp_async_commit();
    }
    cp_async_commit();
    // a warp whose rows all lie above the causal diagonal, or past S,
    // takes nothing from this tile
    const bool active = first < S && !(causal && k0 > last);

    float s[kM][kKeySteps][4];
    if (active) {
      // S = Q.K^T: kWarpRows rows x 64 keys a warp
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        Split4 a[kM];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi)
          a[mi] = load_q_split<kLdQK>(qs, wrow + 16 * mi + g, kk * 8 + 2 * t);
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
          // K row = key; columns 2t, 2t + 1 are the k order's t, t + 4
          const float2 kr =
              *reinterpret_cast<const float2*>(kst + (j * 8 + g) * kLdQK + kk * 8 + 2 * t);
          Split2 bk;
          split_tf32(kr.x, bk.big[0], bk.small[0]);
          split_tf32(kr.y, bk.big[1], bk.small[1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) mma_3xtf32(s[mi][j], a[mi], bk);
        }
      }

      // online softmax on the fragment: s[mi][j][e] at row first + 16mi +
      // g + 8·(e / 2), key k0 + 8j + 2t + e % 2; exponents in base 2
      const bool edge = (causal && k0 + kF32Keys - 1 > first) || k0 + kF32Keys > Sk;
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(s[mi][j][e], scale_log2);
            if (edge) {
              const int col = k0 + 8 * j + 2 * t + e % 2;
              const int row = first + 16 * mi + g + 8 * (e / 2);
              if (col >= Sk) x = -INFINITY;  // past the ragged end: p = 0
              else if (causal && col > row) x = kMasked;
            }
            s[mi][j][e] = x;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[mi][r], mx[r]);
          alpha[r] = exp2_approx(__fsub_rn(m[mi][r], m_new));
          m[mi][r] = m_new;
          l[mi][r] = __fmul_rn(alpha[r], l[mi][r]);
        }
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mi][j][e] = exp2_approx(__fsub_rn(s[mi][j][e], m[mi][e / 2]));
            l[mi][e / 2] = __fadd_rn(l[mi][e / 2], s[mi][j][e]);
          }
#pragma unroll
        for (int n = 0; n < kDSteps; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = __fmul_rn(alpha[e / 2], acc[mi][n][e]);
      }
    }

    cp_async_wait<2>();  // V of this tile landed
    __syncthreads();

    if (active) {
      // O += P.V.  The S fragment holds keys (2t, 2t + 1) of each 8; A
      // wants (t, t + 4).  Read in the k order 0, 2, 4, 6, 1, 3, 5, 7, the
      // S fragment is A's fragment as it stands ((c0, c2, c1, c3) are A's
      // (a0, a1, a2, a3)), so V's B fragment reads keys 2t and 2t + 1 (rows
      // kLdV apart): no shuffle and no trip through shared memory.
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        Split4 pa[kM];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          split_tf32(s[mi][kk][0], pa[mi].big[0], pa[mi].small[0]);
          split_tf32(s[mi][kk][2], pa[mi].big[1], pa[mi].small[1]);
          split_tf32(s[mi][kk][1], pa[mi].big[2], pa[mi].small[2]);
          split_tf32(s[mi][kk][3], pa[mi].big[3], pa[mi].small[3]);
        }
        const float* vr = vst + (kk * 8 + 2 * t) * kLdV + g;
#pragma unroll
        for (int n = 0; n < kDSteps; ++n) {
          Split2 bv;
          split_tf32(vr[n * 8], bv.big[0], bv.small[0]);
          split_tf32(vr[kLdV + n * 8], bv.big[1], bv.small[1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) mma_3xtf32(acc[mi][n], pa[mi], bv);
        }
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = __fadd_rn(l[mi][r], __shfl_xor_sync(0xffffffffu, l[mi][r], 1));
      lr = __fadd_rn(lr, __shfl_xor_sync(0xffffffffu, lr, 2));
      const int row = first + 16 * mi + g + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
      for (int n = 0; n < kDSteps; ++n)
        *reinterpret_cast<float2*>(ob + row * so.s + n * 8 + 2 * t) = make_float2(
            __fdiv_rn(acc[mi][n][2 * r], denom), __fdiv_rn(acc[mi][n][2 * r + 1], denom));
    }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, int64_t B, int64_t Hq, int64_t Hkv, int64_t S,
                       int64_t Sk, int causal, float scale, cudaStream_t stream) {
  using G = F32Geometry<D>;
  auto kernel = flash_attention_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + G::kRows - 1) / G::kRows),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  kernel<<<grid, kF32Threads, G::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3],
      static_cast<int>(S), static_cast<int>(Sk), static_cast<int>(Hq / Hkv), causal,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   const Strides* st, int64_t B, int64_t Hq, int64_t Hkv, int64_t S,
                   int64_t Sk, int causal, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, st, B, Hq, Hkv, S, Sk, causal, scale, stream);
  // D = 96 and 128: each warpgroup's products back to back (the overlapped
  // schedule needs more than the 168 registers a thread of a block this
  // size); D <= 64: ping-pong with P.V overlapped.  Three K/V stages where
  // they fit in shared memory (all but D = 128).
  constexpr bool kPipelined = D <= 64;
  constexpr int kStages = D == 128 ? 2 : 3;
  if (dtype == 1)
    return launch_bf16<D, kStages, kPipelined>(q, k, v, o, st, B, Hq, Hkv, S, Sk, causal, scale,
                                               stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch_attention

extern "C" int rt_flash_attention(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, void* o, int64_t batch, int64_t heads_q,
                                  int64_t heads_kv, int64_t seq, int64_t seq_k, int causal,
                                  double scale, const int64_t* strides, void* stream) {
  using namespace repro_torch_attention;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  if (heads_kv <= 0 || heads_q % heads_kv != 0) return cudaErrorInvalidValue;
  if (causal && seq_k != seq) return cudaErrorInvalidValue;
  if (batch * heads_q * seq == 0) return cudaGetLastError();
  if (seq_k <= 0 || seq_k > 0x7fffffff || batch > 65535 || heads_q > 65535 ||
      (seq + 127) / 128 * heads_q * batch > 0x7fffffff)
    return cudaErrorInvalidValue;
  Strides st[4];  // q, k, v, o
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, o, st, batch, heads_q, heads_kv, seq, seq_k, causal, sc, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, st, batch, heads_q, heads_kv, seq, seq_k, causal, sc, s);
    case 96:
      return launch<96>(dtype, q, k, v, o, st, batch, heads_q, heads_kv, seq, seq_k, causal, sc, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, st, batch, heads_q, heads_kv, seq, seq_k, causal, sc,
                         s);
    default: return cudaErrorInvalidValue;
  }
}
