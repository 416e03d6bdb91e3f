// sims_argmax.cuh: the SIMT fp32 similarity tile and the first-wins
// comparison shared by qail_update.cu and (through adc_tile.cuh)
// am_search_multibit.cu's fp32 route and the ADC searches' fold.
//
// A block of 256 threads (16 x 16) computes one (16*TM) x 64 tile of
// sims = q @ am_t: thread (ty, tx) owns queries row0 + ty*TM + i (i < TM)
// and columns col0 + tx + 16*j (j < 4). K walks the D axis in slabs of
// BK dims staged in shared memory, ascending, with one fmaf per product:
// over ±1 AM cells and ±1 (or dyadic) queries every partial sum is an
// exact float32, so the tile equals torch's q @ am_t bit for bit. No TF32
// and no tensor cores: queries may be float H.
//
// better() compares (sim, idx) lexicographically — a larger sim wins, an
// equal sim goes to the lower index — so a fold of it keeps the first
// maximal column, as torch.argmax and the TPU kernels' strict '>' running
// compare give.
#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sims {

constexpr int BN = 64;    // AM columns per tile
constexpr int BK = 16;    // dims per shared-memory slab
constexpr int TN = 4;     // columns per thread (strided by 16)
constexpr int TPB = 256;  // threads per block: 16 x 16

// (s, i) beats (bs, bi): larger similarity, or equal and lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// The AM operand of a tile: a (D, C) float32 view with element strides
// (sd, sc), so the transposed view of a (C, D) row-major AM needs no copy.
struct StridedAm {
  const float* __restrict__ am_t;
  long long sd, sc;

  // Stage dims [k0, k0 + BK) x columns [col0, col0 + BN) into as[k][n];
  // dims >= k_end and columns >= C load as 0. Walks whichever axis is
  // contiguous in memory fastest.
  __device__ void stage(float (*as)[BN + 1], int k0, int k_end, int col0,
                        int C) const {
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      int k, n;
      if (sc == 1) {
        k = e / BN;
        n = e % BN;
      } else {
        k = e % BK;
        n = e / BK;
      }
      const int d = k0 + k, c = col0 + n;
      as[k][n] = (d < k_end && c < C) ? am_t[d * sd + c * sc] : 0.0f;
    }
  }
};

// acc += q[rows, k_begin:k_end] @ am[k_begin:k_end, cols] for the
// (16*TM) x BN tile at (row0, col0). q is (B, D) row major; ``am`` stages
// the AM slabs (StridedAm, or the bit-plane decoder of
// am_search_multibit.cu). Dims are walked ascending, one fmaf each.
template <int TM, class Am>
__device__ void accumulate(const float* __restrict__ q, int B, int D, int C,
                           int row0, int col0, int k_begin, int k_end,
                           const Am& am, float (*qs)[16 * TM + 1],
                           float (*as)[BN + 1], float (&acc)[TM][TN]) {
  constexpr int BM = 16 * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // Queries: BK consecutive dims of a row are contiguous.
    for (int e = tid; e < BM * BK; e += TPB) {
      const int m = e / BK, k = e % BK;
      const int r = row0 + m, d = k0 + k;
      qs[k][m] = (r < B && d < k_end) ? q[(size_t)r * D + d] : 0.0f;
    }
    am.stage(as, k0, k_end, col0, C);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = as[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The (16*TM) x BN tile of q @ am_t at (row0, col0), over all D dims.
// Out-of-range rows, dims and columns load as 0.
template <int TM>
__device__ void tile(const float* __restrict__ q,
                     const float* __restrict__ am_t, long long sd,
                     long long sc, int B, int D, int C, int row0, int col0,
                     float (*qs)[16 * TM + 1], float (*as)[BN + 1],
                     float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  accumulate<TM>(q, B, D, C, row0, col0, 0, D, StridedAm{am_t, sd, sc}, qs,
                 as, acc);
}

}  // namespace sims
