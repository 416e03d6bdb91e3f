// b1_slab.cuh: the staging and fragments of a search on the 1-bit tensor
// cores straight from packed bytes (mma.sync.m16n8k256 .b1 .and.popc),
// which am_search_packed.cu's popcount tile route and am_shortlist.cu's
// tile route share:
// * A ring of STAGES k slabs of SLAB packed bytes (256 dims, one m16n8k256
//   step) of both operands: the query rows, QSTR bytes apart, then the
//   AM's SLAB byte rows of the block's columns, am_stride(cols) bytes
//   apart, byte row 4w + k of the slab stored at row k * KW + w, so that a
//   warp's four k-lanes gather their B words from distinct banks.
// * Bytes past Dp (and columns past C) are staged as 0 in BOTH operands,
//   so a ragged Dp such as D = 100 (Dp = 13) needs no padding pass: they
//   add nothing to popc(q AND a) nor to either operand's popcount.
// * A fragments of an m16 query tile by ldmatrix; a column's B words
//   gathered byte by byte from the slab. With P_q and P_a the popcounts of
//   the query's and the column's bits, hamming = P_q + P_a -
//   2 popc(q AND a), exact.
// * The sweep route's staging and fragments, at the end: a whole column
//   tile for ldmatrix .trans, and A fragments at any row stride.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace b1 {

constexpr int SLAB = 32;      // packed bytes (256 dims) per k slab
constexpr int STAGES = 4;     // ring stages
constexpr int KW = SLAB / 4;  // 32-bit words of a slab
constexpr int QSTR = 48;      // ring row stride of a query (32 bytes used)

// Ring row stride of the AM slab for `cols` columns: a multiple of 16
// bytes that puts the 4 k-lanes' rows in distinct banks.
__host__ __device__ inline int am_stride(int cols) {
  return cols + 16 > 32 ? cols + 16 : 32;
}
// Bytes of one ring stage: `rows` query rows and the AM slab of `cols`.
__host__ __device__ inline int stage_bytes(int rows, int cols) {
  return rows * QSTR + SLAB * am_stride(cols);
}

// Copy 16 bytes to shared memory, zero where !ok: cp.async when the
// source is 16-byte aligned (vec), else byte by byte. n limits the byte
// copy to the bytes in range.
__device__ __forceinline__ void stage16(uint8_t* dst, const uint8_t* src,
                                        bool ok, int n, bool vec) {
  if (vec) {
    mma::cp_async16_zfill(dst, src, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = ok && i < n ? src[i] : 0;
  }
}
// ... 8 bytes, cp.async when the source is 8-byte aligned.
__device__ __forceinline__ void stage8(uint8_t* dst, const uint8_t* src,
                                       bool ok, int n, bool vec) {
  if (vec) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     mma::smem_u32(dst)),
                 "l"(src), "r"(ok ? 8 : 0));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = ok && i < n ? src[i] : 0;
  }
}

// Slab t into a ring stage: query rows b0 .. b0 + R - 1 of q (B, Dp) to qd
// (row r at r * QSTR), the AM (Dp, C) columns c0 .. c0 + cols - 1 to ad
// (byte row 4w + k of the slab at row k * KW + w, am_stride(cols) bytes
// apart). cols is 8 or a multiple of 16; the block's threads share the
// copies. q_vec / a_vec / a_vec8: the 16- and 8-byte copies are aligned.
template <int R>
__device__ __forceinline__ void load_slab(uint8_t* qd, uint8_t* ad,
                                          const uint8_t* __restrict__ q,
                                          const uint8_t* __restrict__ am_t,
                                          int t, int b0, int B, int Dp,
                                          int c0, int cols, int C,
                                          bool q_vec, bool a_vec,
                                          bool a_vec8) {
  const int kb = t * SLAB, as_ld = am_stride(cols);
  for (int e = threadIdx.x; e < R * 2; e += blockDim.x) {
    const int r = e >> 1, h = e & 1, byte = kb + 16 * h, b = b0 + r;
    const bool ok = b < B && byte < Dp;
    stage16(qd + r * QSTR + 16 * h, ok ? q + (size_t)b * Dp + byte : q, ok,
            Dp - byte, q_vec);
  }
  if (cols >= 16) {
    for (int e = threadIdx.x; e < SLAB * (cols / 16); e += blockDim.x) {
      const int r = e / (cols / 16), ch = e % (cols / 16);
      const int byte = kb + r, c = c0 + 16 * ch;
      const bool ok = byte < Dp && c < C;
      stage16(ad + ((r & 3) * KW + (r >> 2)) * as_ld + 16 * ch,
              ok ? am_t + (size_t)byte * C + c : am_t, ok, C - c, a_vec);
    }
  } else {  // 8 columns: one 8-byte copy a byte row
    for (int r = threadIdx.x; r < SLAB; r += blockDim.x) {
      const int byte = kb + r;
      const bool ok = byte < Dp && c0 < C;
      stage8(ad + ((r & 3) * KW + (r >> 2)) * as_ld,
             ok ? am_t + (size_t)byte * C + c0 : am_t, ok, C - c0, a_vec8);
    }
  }
}

// Every slab at once, when n_slabs <= STAGES: slab t into ring stage t, in
// the layout of load_slab, each thread issuing its copies with no division
// in the loop (a thread keeps one 16-column chunk and strides over the
// byte rows). cols is a multiple of 16, at most 16 * blockDim.x.
template <int R>
__device__ __forceinline__ void load_resident(
    uint8_t* qring, uint8_t* aring, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ am_t, int n_slabs, int b0, int B, int Dp,
    int c0, int cols, int C, bool q_vec, bool a_vec) {
  const int as_ld = am_stride(cols);
  for (int e = threadIdx.x; e < R * 2 * n_slabs; e += blockDim.x) {
    const int r = e % R, h = (e / R) & 1, t = e / (2 * R);
    const int byte = t * SLAB + 16 * h, b = b0 + r;
    const bool ok = b < B && byte < Dp;
    stage16(qring + (t * R + r) * QSTR + 16 * h,
            ok ? q + (size_t)b * Dp + byte : q, ok, Dp - byte, q_vec);
  }
  const int nch = cols / 16, rstep = blockDim.x / nch;
  if (threadIdx.x >= rstep * nch) return;
  const int ch = threadIdx.x % nch, c = c0 + 16 * ch;
  for (int row = threadIdx.x / nch; row < SLAB * n_slabs; row += rstep) {
    const int r = row & (SLAB - 1);
    const bool ok = row < Dp && c < C;
    stage16(aring + ((row - r) + (r & 3) * KW + (r >> 2)) * as_ld + 16 * ch,
            ok ? am_t + (size_t)row * C + c : am_t, ok, C - c, a_vec);
  }
}

// A fragment of the m16 query tile whose 16 rows start at qs: rows gid /
// gid + 8, words tig and 4 + tig of the slab.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint8_t* qs,
                                       int lane) {
  mma::ldmatrix_x4(a, qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * QSTR +
                          16 * (lane >> 4));
}

// B fragment of one column: words tig and 4 + tig of the slab, byte k of
// word w from row k * KW + w. col: the column's byte in the stage's row 0.
__device__ __forceinline__ void b_frag(uint32_t (&b)[2], const uint8_t* col,
                                       int tig, int as_ld) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint8_t* pb = col + (4 * h + tig) * as_ld;
    b[h] = (uint32_t)pb[0] | (uint32_t)pb[KW * as_ld] << 8 |
           (uint32_t)pb[2 * KW * as_ld] << 16 |
           (uint32_t)pb[3 * KW * as_ld] << 24;
  }
}

// -- The sweep route of am_search_packed.cu's popcount mode ---------------
// A column tile of the AM (all of Dp, 128 columns) is staged whole, byte
// row r of each 32-byte slab (r = 16 h + 4 a + 2 b + c) at the slab's row
// sweep_row(r) = 16 h + 8 b + 2 a + c, SWEEP_ASTR bytes apart. Then one
// ldmatrix .x4 .trans of the slab's 32 rows (lane l gives row l) at 16
// columns hands lane (gid, tig) four registers, each two k bytes of the
// columns 2 gid and 2 gid + 1: rows 2 tig and 2 tig + 1 of the four 8-row
// matrices, that is k bytes 4 tig, 4 tig + 1 (r0), 4 tig + 2, 4 tig + 3
// (r1), and the same plus 16 (r2, r3). Two byte permutes a register pair
// give each column its B words tig and 4 + tig in the query's byte order,
// with no byte-by-byte gather and no shuffle.
constexpr int SWEEP_ASTR = 144;  // 128 columns + 16: 8 rows, 8 bank groups

__host__ __device__ inline int sweep_row(int r) {
  return (r & 16) | ((r >> 1) & 1) << 3 | ((r >> 2) & 3) << 1 | (r & 1);
}

// A fragment of the m16 query tile whose 16 rows start at qs, rows
// `stride` bytes apart: as a_frag.
__device__ __forceinline__ void a_frag_at(uint32_t (&a)[4], const uint8_t* qs,
                                          int lane, int stride) {
  mma::ldmatrix_x4(a, qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * stride +
                          16 * (lane >> 4));
}

// B words of a warp's 32 columns at one k slab (slab: the stage's row 32 s
// at the warp's first column): n8 tile 2 p + e takes column 16 p + 2 gid +
// e of the warp as its column gid.
__device__ __forceinline__ void sweep_b_frags(uint32_t (&b)[4][2],
                                              const uint8_t* slab, int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    mma::ldmatrix_x4_trans(r, slab + lane * SWEEP_ASTR + 16 * p);
    b[2 * p][0] = __byte_perm(r[0], r[1], 0x6420);
    b[2 * p][1] = __byte_perm(r[2], r[3], 0x6420);
    b[2 * p + 1][0] = __byte_perm(r[0], r[1], 0x7531);
    b[2 * p + 1][1] = __byte_perm(r[2], r[3], 0x7531);
  }
}

}  // namespace b1
