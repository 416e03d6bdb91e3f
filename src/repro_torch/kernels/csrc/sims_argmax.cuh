// sims_argmax.cuh: the fp32 similarity tile and the first-wins argmax
// fold shared by am_search.cu and qail_update.cu.
//
// A block of 256 threads (16 x 16) computes one (16*TM) x 64 tile of
// sims = q @ am_t: thread (ty, tx) owns queries row0 + ty*TM + i (i < TM)
// and columns col0 + tx + 16*j (j < 4). K walks the D axis in slabs of
// BK dims staged in shared memory, ascending, with one fmaf per product:
// over ±1 AM cells and ±1 (or dyadic) queries every partial sum is an
// exact float32, so the tile equals torch's q @ am_t bit for bit. No TF32
// and no tensor cores: queries may be float H.
//
// The fold writes, for every query row of the tile, the best (sim, idx)
// among the tile's eligible columns to a (B, n_ct) partial buffer; a
// second pass folds the partials across column tiles. Both folds compare
// (sim, idx) lexicographically — a larger sim wins, an equal sim goes to
// the lower index — so the winner is the first maximal column, as
// torch.argmax and the TPU kernels' strict '>' running compare give.
// Columns >= C are never eligible, so padding can never win.
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

// The (16*TM) x BN tile of q @ am_t at (row0, col0). q is (B, D) row
// major; am_t (D, C) with element strides (sd, sc), so the transposed
// view of a (C, D) row-major AM needs no copy. Out-of-range rows, dims
// and columns load as 0.
template <int TM>
__device__ void tile(const float* __restrict__ q,
                     const float* __restrict__ am_t, long long sd,
                     long long sc, int B, int D, int C, int row0, int col0,
                     float (*qs)[16 * TM + 1], float (*as)[BN + 1],
                     float (&acc)[TM][TN]) {
  constexpr int BM = 16 * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // Queries: BK consecutive dims of a row are contiguous.
    for (int e = tid; e < BM * BK; e += TPB) {
      const int m = e / BK, k = e % BK;
      const int r = row0 + m, d = k0 + k;
      qs[k][m] = (r < B && d < D) ? q[(size_t)r * D + d] : 0.0f;
    }
    // AM slab: walk whichever axis is contiguous in memory fastest.
    for (int e = tid; e < BK * BN; e += TPB) {
      int k, n;
      if (sc == 1) {
        k = e / BN;
        n = e % BN;
      } else {
        k = e % BK;
        n = e / BK;
      }
      const int d = k0 + k, c = col0 + n;
      as[k][n] = (d < D && c < C) ? am_t[d * sd + c * sc] : 0.0f;
    }
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

// Every column is eligible (am_search, Eq. 4).
struct AnyColumn {
  __device__ bool operator()(int, int) const { return true; }
};

// Columns owned by the row's label (Eq. 5): owners (C,), labels (B,).
struct OwnedColumn {
  const int32_t* owners;
  const int32_t* labels;
  __device__ bool operator()(int row, int col) const {
    return owners[col] == labels[row];
  }
};

// Fold the tile's eligible columns into part_s/part_i[row * n_ct + ct].
// A row with no eligible column writes (-inf, INT_MAX). red_s/red_i hold
// 16*TM*16 entries each; the trailing barrier lets a second fold reuse them.
template <int TM, class Eligible>
__device__ void fold_tile(const float (&acc)[TM][TN], int row0, int col0,
                          int B, int C, Eligible ok, float* red_s,
                          int* red_i, float* __restrict__ part_s,
                          int* __restrict__ part_i, int n_ct, int ct) {
  constexpr int BM = 16 * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    float bs = -INFINITY;
    int bi = INT_MAX;
    if (row0 + r < B) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // this thread's columns, ascending
        const int c = col0 + tx + 16 * j;
        if (c < C && ok(row0 + r, c) && better(acc[i][j], c, bs, bi)) {
          bs = acc[i][j];
          bi = c;
        }
      }
    }
    red_s[r * 16 + tx] = bs;
    red_i[r * 16 + tx] = bi;
  }
  __syncthreads();
  if (tid < BM && row0 + tid < B) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int t = 0; t < 16; ++t) {
      const float s = red_s[tid * 16 + t];
      const int i = red_i[tid * 16 + t];
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    part_s[(size_t)(row0 + tid) * n_ct + ct] = bs;
    part_i[(size_t)(row0 + tid) * n_ct + ct] = bi;
  }
  __syncthreads();
}

// Fold one row's n_ct partials, in column-tile order.
__device__ __forceinline__ void fold_partials(const float* __restrict__ ps,
                                              const int* __restrict__ pi,
                                              int n_ct, int row, float& bs,
                                              int& bi) {
  bs = -INFINITY;
  bi = INT_MAX;
  for (int ct = 0; ct < n_ct; ++ct) {
    const float s = ps[(size_t)row * n_ct + ct];
    const int i = pi[(size_t)row * n_ct + ct];
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
}

}  // namespace sims
