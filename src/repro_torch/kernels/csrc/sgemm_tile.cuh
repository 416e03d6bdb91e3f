// sgemm_tile.cuh: the true-fp32 projection product shared by
// encode_pack.cu and binary_mvm.cu.
//
// A block of 256 threads computes one 128-row x 64-column tile of
// H = x @ w, x (B, f) and w (f, D) row major, K in steps of 16 staged in
// shared memory. Thread (tr = tid / 8, tc = tid % 8) accumulates rows
// m0 + 4tr .. +3 and columns n0 + 8tc .. +7 in a 4 x 8 register tile with
// __fmaf_rn — one fused fp32 multiply-add per term in increasing k, never
// TF32 or bf16. Rows >= B, dims >= f and columns >= D load as zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int BM = 128;        // batch rows per block
constexpr int BN = 64;         // output columns per block
constexpr int BK = 16;         // K step
constexpr int AS_LD = BM + 4;  // padded row of the transposed A tile
constexpr int NT = 256;        // threads: 32 row groups x 8 column groups

__device__ __forceinline__ void tile(const float* __restrict__ x,
                                     const float* __restrict__ w, int B,
                                     int f, int D, int m0, int n0,
                                     float (*As)[AS_LD], float (*Bs)[BN],
                                     float (&acc)[4][8]) {
  const int tid = threadIdx.x;
  const int tc = tid % 8;
  const int tr = tid / 8;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < f; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = tid + NT * i;
      const int row = e / BK, kk = e % BK;
      const int gr = m0 + row, gk = k0 + kk;
      As[kk][row] = (gr < B && gk < f) ? x[(size_t)gr * f + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / NT; ++i) {
      const int e = tid + NT * i;
      const int kk = e / BN, col = e % BN;
      const int gk = k0 + kk, gc = n0 + col;
      Bs[kk][col] = (gk < f && gc < D) ? w[(size_t)gk * D + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * tr]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][8 * tc]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][8 * tc + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace sgemm
