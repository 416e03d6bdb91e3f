// adc_tile.cuh: the per-array ADC and the tiled analog search loop shared
// by am_search_imc.cu and am_search_multibit.cu.
//
// The AM is cut into (tile_rows x tile_cols) physical arrays. For every
// (query, column) the K loop closes each tile_rows slab before it moves
// on: the slab's partial sum is finished (sims::accumulate, one fmaf per
// dim, ascending), the array's readout offset offsets[g, col / tile_cols]
// is added, the result goes through the ADC, and only the quantized value
// is added to the running similarity, slab after slab in order g = 0, 1,
// ... — the order of ref.imc_sims.
//
// The ADC is ref.adc_quantize / jnp.round(jnp.clip(x, -clip, clip) / step)
// * step bit for bit: clip by min/max, a true IEEE division by step
// (__fdiv_rn: step = 2 * clip / 2^bits need not be a power of two),
// rintf (round half to even, as jnp.round and torch.round; roundf would
// round half away from zero), and the product and the accumulation kept
// apart (__fmul_rn, __fadd_rn), so the compiler cannot fuse them into an
// FMA. Build without --use_fast_math.
#pragma once

#include "sims_argmax.cuh"

namespace adc {

__device__ __forceinline__ float quantize(float x, float clip, float step) {
  x = fminf(fmaxf(x, -clip), clip);
  return __fmul_rn(rintf(__fdiv_rn(x, step)), step);
}

// acc = the ADC-quantized similarity of the (16*TM) x BN tile at
// (row0, col0): sum over row tiles g of ADC(q[:, slab g] . am[slab g, :]
// + offsets[g, col / tile_cols]). offsets is a (gd, gc) row-major grid,
// or null for drift-free readout.
template <int TM, class Am>
__device__ void imc_tile(const float* __restrict__ q, int B, int D, int C,
                         int row0, int col0, int tile_rows, int tile_cols,
                         const float* __restrict__ offsets, int gc,
                         float clip, float step, const Am& am,
                         float (*qs)[16 * TM + 1],
                         float (*as)[sims::BN + 1],
                         float (&acc)[TM][sims::TN]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < sims::TN; ++j) acc[i][j] = 0.0f;
  int g = 0;
  for (int s0 = 0; s0 < D; s0 += tile_rows, ++g) {
    float part[TM][sims::TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < sims::TN; ++j) part[i][j] = 0.0f;
    const int s1 = min(s0 + tile_rows, D);
    sims::accumulate<TM>(q, B, D, C, row0, col0, s0, s1, am, qs, as, part);
#pragma unroll
    for (int j = 0; j < sims::TN; ++j) {
      const int c = col0 + tx + 16 * j;
      const float off = (offsets != nullptr && c < C)
                            ? offsets[(size_t)g * gc + c / tile_cols]
                            : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        acc[i][j] = __fadd_rn(
            acc[i][j], quantize(__fadd_rn(part[i][j], off), clip, step));
    }
  }
}

}  // namespace adc
