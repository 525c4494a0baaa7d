// Tensor-core, copy and barrier helpers shared by the hand-written kernels:
// the shared-memory address of a pointer, cp.async (16 bytes, global ->
// shared, zero fill; or one 4- or 8-byte element), mbarriers (init,
// expect-tx, arrive, wait), a bulk copy completing on an mbarrier, exp2 on
// the MUFU, split-TF32 products on mma.sync.m16n8k8 (float32 at nearly f32
// accuracy from three TF32 products of split halves) and float64 products
// on mma.sync.m8n8k4 (DMMA), and the cluster's pieces: another block's
// shared-memory address, stores into it counted on its mbarrier, a relaxed
// cluster barrier.  Used by flash_attention.cu, ssd_chunk.cu and
// fused_mlp.cu.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch_tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// One element of `Bytes` (4 or 8) global -> shared without registers; both
// addresses aligned to the element.
template <int Bytes>
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const void* src) {
  static_assert(Bytes == 4 || Bytes == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(Bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.  A phase
// that never completes (a lost arrival) traps after ~10 s instead of
// hanging the card, and the launcher's next CUDA call reports it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000ll) __trap();
}

// The address of the same shared-memory location in block `rank` of the
// cluster (mapa), for the shared::cluster operations below.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// A store into another block's shared memory (cluster addresses) that
// counts its bytes against that block's mbarrier (complete_tx): the
// receiver learns of it by waiting on its own barrier, with no fence.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
               ::"r"(addr), "l"(__double_as_longlong(v)), "r"(bar)
               : "memory");
}

// An mbarrier initialised here visible to the other blocks of the cluster.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The cluster barrier split in two and relaxed: no memory ordering (no
// GPU-scope fence), only "every block of the cluster has got this far".
// Every thread of every block arrives and waits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the bulk-copy unit; they count against the barrier's
// transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero on the magnitude: cvt.rna.tf32.f32's value, low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big = rna(x) and small = x - big (exact, |small| <=
// 2^-11 |x|), handed to the tensor core as f32 bits, which reads their TF32
// part (it drops the low 13 bits: small rounded toward zero, as CUTLASS's
// fast-f32 products do).  big·y_big + big·y_small + small·y_big then misses
// at most ~5·2^-22 of x·y (small·small, and the two truncated smalls), and
// costs 3 instructions a split where rounding small too would cost 5.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// c (16 x 8, f32) += a (16 x 8, TF32) . b (8 x 8, TF32).  Fragments, with
// g = lane / 4 and t = lane % 4: a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (k t, n g), (k t + 4, n g); c = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split pair of fragments (big, small).
struct Split4 {
  uint32_t big[4], small[4];
};
struct Split2 {
  uint32_t big[2], small[2];
};

// c += a . b at f32 accuracy: the two small cross products, then big·big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split4& a, const Split2& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// c (8 x 8, f64) += a (8 x 4, f64) . b (4 x 8, f64), each product and sum
// in float64.  Fragments, with g = lane / 4 and t = lane % 4: a = (g, t);
// b = (k t, n g); c = (g, 2t), (g, 2t + 1).
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

}  // namespace repro_torch_tc
