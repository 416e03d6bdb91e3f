// am_search_imc: the associative search as tiled analog IMC arrays
// compute it — per-array partial sums, per-array readout offset, ADC,
// digital accumulation, first-wins argmax.
//
//   q        (B, D) float32  queries
//   am_t     (D, C) float32  the resident (possibly perturbed) AM,
//                            element strides (sd, sc): the transposed
//                            view of the (C, D) device instance
//   offsets  (gd, gc) float32 per-array readout offsets, or null;
//                            gd = ceil(D/tile_rows), gc = ceil(C/tile_cols)
//   idx      (B,) int32      winning centroid
//   sim      (B,) float32    its ADC-quantized accumulated similarity
//
// Replaces the TPU kernel src/repro/kernels/am_search_imc.py:
// am_search_imc (a (B/bB, C/cols, D/rows) Pallas grid, one step per
// physical array pass, accumulating the ADC'd tile outputs in VMEM and
// carrying the running winner across C steps in scratch).
//
// Bound on the H100: operations. The AM carries conductance noise, so
// both operands are float: at B = C = D = 1024 the search is 2*B*C*D =
// 2.15 GFLOP of fp32 FMA, 32 us at 67 TFLOP/s; its 8 MB take 2.4 us.
//
// Design: am_search.cu's (64-query, 64-column) register tiles and the
// two-pass (sim, idx) fold of sims_argmax.cuh; the K loop runs through
// adc_tile.cuh, which closes every tile_rows slab (offset, ADC,
// accumulate) before the next. tile_rows and tile_cols are runtime
// values: any array geometry works, since a slab boundary may fall
// inside a 16-dim shared-memory chunk (the chunk stops there) and a
// 64-column block may straddle two array columns (each column reads its
// own offset). Nothing carries between blocks and no atomics are used.
#include "adc_tile.cuh"

namespace {

constexpr int TM = 4;  // queries per thread: 64-query tiles

__global__ void __launch_bounds__(sims::TPB)
am_search_imc_partial(const float* __restrict__ q,
                      const float* __restrict__ am_t, long long sd,
                      long long sc, const float* __restrict__ offsets,
                      float* __restrict__ part_s, int* __restrict__ part_i,
                      int B, int D, int C, int tile_rows, int tile_cols,
                      float clip, float step) {
  __shared__ float qs[sims::BK][16 * TM + 1];
  __shared__ float as[sims::BK][sims::BN + 1];
  __shared__ float red_s[16 * TM * 16];
  __shared__ int red_i[16 * TM * 16];
  float acc[TM][sims::TN];
  const int row0 = blockIdx.y * 16 * TM, col0 = blockIdx.x * sims::BN;
  const int gc = (C + tile_cols - 1) / tile_cols;
  adc::imc_tile<TM>(q, B, D, C, row0, col0, tile_rows, tile_cols, offsets,
                    gc, clip, step, sims::StridedAm{am_t, sd, sc}, qs, as,
                    acc);
  sims::fold_tile<TM>(acc, row0, col0, B, C, sims::AnyColumn{}, red_s,
                      red_i, part_s, part_i, gridDim.x, blockIdx.x);
}

}  // namespace

// part_s / part_i: (B, ceil(C/64)) scratch from the caller. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int am_search_imc_launch(const void* q, const void* am_t,
                                    long long sd, long long sc,
                                    const void* offsets, void* part_s,
                                    void* part_i, void* idx, void* sim,
                                    int B, int D, int C, int tile_rows,
                                    int tile_cols, float clip, float step,
                                    void* stream) {
  if (B <= 0) return 0;
  if (tile_rows <= 0 || tile_cols <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_ct = (C + sims::BN - 1) / sims::BN;
  const int n_rt = (B + 16 * TM - 1) / (16 * TM);
  if (n_rt > 65535) return (int)cudaErrorInvalidValue;
  am_search_imc_partial<<<dim3(n_ct, n_rt), sims::TPB, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(am_t), sd, sc,
      static_cast<const float*>(offsets), static_cast<float*>(part_s),
      static_cast<int*>(part_i), B, D, C, tile_rows, tile_cols, clip, step);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sims::fold_rows<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      n_ct, B, static_cast<int32_t*>(idx), static_cast<float*>(sim));
  return (int)cudaGetLastError();
}
