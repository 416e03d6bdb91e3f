// int8_convert.cuh: the convert tile of the passes that pick an exact int8
// tensor-core route on the device (qail_update.cu, am_search_imc.cu,
// am_search_multibit.cu, am_search.cu). A 64 x 64 tile of a float32 operand becomes int8
// rows, and one flag word says whether every value of the tile is an
// integer in [-127, 127] and, if so, the largest |value|: the search pass
// reads the flags of all tiles and takes the int8 route only when the
// products and partial sums it needs are exact.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv {

constexpr int TILE = 64;          // rows x dims of a convert tile
constexpr int THREADS = 256;      // threads of a convert block
constexpr unsigned INEXACT = 0x80000000u;

// The tile at (rows r0 .., dims k0 ..) of src, read with element strides
// sk along dims and sr along rows (along whichever axis is contiguous),
// rows >= `rows` and dims >= D as 0, and written as int8 rows
// dst + r * dp, 4 dims a word, for rows < rows_pad: straight from 16-byte
// loads when the dims are contiguous and aligned, else transposed in
// shared memory.
// t and s_max are the block's shared scratch. Returns the tile's flag in
// every thread: its largest |value|, or INEXACT if a value is not an
// integer in [-127, 127] (also NaN and inf).
__device__ __forceinline__ unsigned tile(const float* __restrict__ src,
                                         long long sk, long long sr,
                                         int rows, int rows_pad, int D,
                                         int dp, int r0, int k0,
                                         int8_t* __restrict__ dst,
                                         float (*t)[TILE + 1], int* s_max) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_max = 0;
  __syncthreads();
  bool inexact = false;
  int mx = 0;
  auto check = [&](float v) {
    const float a = fabsf(v);
    if (!(a <= 127.f) || v != rintf(v))
      inexact = true;  // also NaN and inf
    else
      mx = max(mx, (int)a);
  };
  if (sk == 1 && sr % 4 == 0 && ((uintptr_t)src & 15) == 0 && D % 4 == 0) {
    // Rows of 16-byte dim runs: no transpose, one word a thread a run.
#pragma unroll
    for (int w = tid; w < TILE * TILE / 4; w += THREADS) {
      const int r = w / (TILE / 4), kw = w % (TILE / 4);
      const int gk = k0 + 4 * kw, gr = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < D && gr < rows)
        v = *reinterpret_cast<const float4*>(src + gk + gr * sr);
      check(v.x), check(v.y), check(v.z), check(v.w);
      if (gr < rows_pad)
        *reinterpret_cast<uint32_t*>(dst + (size_t)gr * dp + gk) =
            (uint32_t)(__float2int_rn(v.x) & 0xff) |
            (uint32_t)(__float2int_rn(v.y) & 0xff) << 8 |
            (uint32_t)(__float2int_rn(v.z) & 0xff) << 16 |
            (uint32_t)(__float2int_rn(v.w) & 0xff) << 24;
    }
    atomicMax(s_max, mx);
    inexact = __syncthreads_or(inexact);
    return inexact ? INEXACT : (unsigned)*s_max;
  }
#pragma unroll
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    int k, r;  // walk the contiguous axis fastest
    if (sk == 1) {
      r = e / TILE, k = e % TILE;
    } else {
      k = e / TILE, r = e % TILE;
    }
    const int gk = k0 + k, gr = r0 + r;
    float v = 0.f;
    if (gk < D && gr < rows) v = src[gk * sk + gr * sr];
    check(v);
    t[r][k] = v;
  }
  atomicMax(s_max, mx);
  inexact = __syncthreads_or(inexact);
  // 4 dims per 32-bit word, one row's 16 words per 16 threads.
  for (int w = tid; w < TILE * TILE / 4; w += THREADS) {
    const int r = w / (TILE / 4), kw = w % (TILE / 4), gr = r0 + r;
    if (gr >= rows_pad) continue;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      word |= (uint32_t)(__float2int_rn(t[r][4 * kw + e]) & 0xff) << (8 * e);
    *reinterpret_cast<uint32_t*>(dst + (size_t)gr * dp + k0 + 4 * kw) = word;
  }
  return inexact ? INEXACT : (unsigned)*s_max;
}

}  // namespace conv
