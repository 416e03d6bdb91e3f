// mma_sync.cuh: the warp-level tensor-core and async-copy primitives that
// qail_update.cu, ssd_chunk.cu, flash_decode.cu, am_search_packed.cu,
// am_search_sparse.cu, am_search_imc.cu, am_search.cu and
// am_search_multibit.cu share:
// 16-byte cp.async copies into shared memory (with a zero-fill form for
// rows past an operand's end), ldmatrix, and mma.sync in int8 (m16n8k32,
// s8 x s8 or s8 x u8, s32 accumulate: exact), in 1 bit (m16n8k256, AND +
// popcount, s32: exact), in
// bf16 (m16n8k16, f32 accumulate) and in TF32 (m16n8k8, f32 accumulate),
// with the splits that carry a float32 operand through them: TF32 hi/lo
// (~2^-21 relative) and three bf16 terms against an exact bf16 operand.
//
// Fragment coordinates of a lane: gid = lane / 4, tig = lane % 4. An m16n8
// accumulator holds (row gid, cols 2 tig, 2 tig + 1) in c[0], c[1] and
// (row gid + 8, the same cols) in c[2], c[3]. A TF32 A fragment (16 x 8)
// holds (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4);
// a TF32 B fragment (8 x 8, k x n) holds (tig, gid) and (tig + 4, gid).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy to shared memory (L2 only: the tile is read once per block).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
// ... or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// Lanes 0-15 give the addresses; the others' are ignored.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The products are plain (not volatile) asm: they have no side effects,
// so the compiler may interleave independent ones and hide their latency.

// d += a (16x32 int8, row) @ b (32x8 int8, col), s32 accumulate: exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 int8, row) @ b (32x8 uint8, col), s32 accumulate: exact.
// Fragments as for mma_s8; each byte of b is read as 0 .. 255.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += popc(a AND b) over k: a 16x256 and b 256x8 1-bit matrices, s32
// accumulate: exact. Fragments as for mma_s8 with each byte 8 bits along
// k: a[0] / a[2] row gid, k words tig / 4 + tig (a[1] / a[3] row gid + 8),
// b0 / b1 column gid, k words tig / 4 + tig. The sum is symmetric in k,
// so A and B need only the same assignment of bits to k.
__device__ __forceinline__ void mma_b1_and(int (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = popc(a AND b) over k, from a zero accumulator (no register to clear).
__device__ __forceinline__ void mma_b1_and_init(int (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// d += a (16x8 tf32, row) @ b (8x8 tf32, col), f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16 bf16, row) @ b (16x8 bf16, col), f32 accumulate: every
// product exact. Fragments as for TF32, each register a pair of bf16 at
// adjacent k (the lower k in the low half).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v0, v1 (adjacent k) as three bf16 pairs t[0] + t[1] + t[2], each term
// the bf16 rounding of what the terms before leave: the sum is v to
// ~2^-24 relative, so three bf16 products against an exact bf16 operand
// carry a float32 operand at float32 accuracy.
__device__ __forceinline__ void split_bf16x3(float v0, float v1,
                                             uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    t[i] = *reinterpret_cast<const uint32_t*>(&p);
    v0 -= __low2float(p);
    v1 -= __high2float(p);
  }
}

// v = hi + lo + O(2^-22 |v|): hi = tf32(v), lo = tf32(v - hi), both
// rounded to nearest. hi*hi' + hi*lo' + lo*hi' is then the product of two
// such values to ~2^-21 relative (the lo*lo' term and lo's own rounding
// are dropped). A value with a bfloat16's 8-bit significand is its own
// hi, with lo = 0.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

}  // namespace mma
