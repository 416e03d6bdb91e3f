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
//   routes   (2,) int32      in/out: +1 to [0] (int8 route) or [1] (fp32)
//   scratch                  int8 copies, flags, keys and tickets (layout:
//                            adc::Plan, mirrored by the wrapper)
//
// Replaces the TPU kernel src/repro/kernels/am_search_imc.py:
// am_search_imc (a (B/bB, C/cols, D/rows) Pallas grid, one step per
// physical array pass, accumulating the ADC'd tile outputs in VMEM and
// carrying the running winner across C steps in scratch).
//
// Bound on the H100. A noisy AM (conductance noise, stuck-at faults) is
// float: the search is 2*B*C*D fp32 FMA terms, 2.15 GFLOP at B = C = D =
// 1024, 32 us at 67 TFLOP/s, while its 8 MB take 2.4 us. An ideal AM is
// ±1 against ±1 queries: every product and slab partial is an integer, so
// the same product is 2.15 G-op of exact int8 tensor-core work (1.1 us at
// 1,979 TOP/s) and the 8 MB of float operands bound it (2.5 us).
//
// Design: the two launches of search_pass.cuh with its ADC readout: the
// convert pass writes int8 copies of q and the AM view with a flag per
// 64 x 64 tile; the search pass, 128-query x 64-column blocks, takes one
// of two routes, the same in every block:
// * int8 (every value an integer in [-127, 127], every slab partial
//   exact): mma.sync.m16n8k32 through a 4-stage cp.async ring, closing
//   each tile_rows slab (offset, ADC, slab-ordered sum, in registers) at
//   its boundary, which may cut a 32-dim k step (adc::Int8Walk), or none
//   where the flags show the ADC is the identity on every partial (the
//   ideal instance: ±1 operands, a 16-bit ADC clipped at the rows);
// * fp32 (a float AM): the pipelined true-fp32 mainloop of sgemm_tile.cuh
//   (one __fmaf_rn per term in increasing k within each slab), closing
//   each slab the same way. Over ±1 queries every product is exact, so
//   each slab partial is the plain version's sequential float32 sum bit
//   for bit, whatever the AM.
// The first-wins fold is a 64-bit key per query (atomicMin). What bounds
// the fp32 route: at 4 x 8 outputs a thread each FMA needs 1.5 bytes of
// shared memory, and an SM delivers 128 bytes a clock against 128 FMAs
// (the 64 x 64, 8 x 8 tile needs 1 byte, but its 64-thread blocks leave an
// SM 4 warps).
#include "search_pass.cuh"

// scratch: scratch_bytes bytes from the caller; routes: (2,) int32 route
// counts. grid_x, grid_y, threads, smem, slabs, k_stages, k_steps,
// conv_grid and scratch_bytes are the wrapper's launch plan
// (kernels/am_search_imc.py: launch_plan), refused (cudaErrorInvalidValue)
// unless it is adc::Plan's for (B, D, C, tile_rows) with this kernel's
// threads and shared memory. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int am_search_imc_launch(
    const void* q, const void* am_t, long long sd, long long sc,
    const void* offsets, void* scratch, long long scratch_bytes,
    void* routes, void* idx, void* sim, int B, int D, int C, int tile_rows,
    int tile_cols, float clip, float step, int grid_x, int grid_y,
    int threads, int smem, int slabs, int k_stages, int k_steps,
    int conv_grid, void* stream) {
  if (B <= 0) return 0;
  if (tile_rows <= 0 || tile_cols <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const adc::Plan pl(B, D, C, tile_rows, search_pass::BM, true,
                     search_pass::FT::BK);
  if (!search_pass::is_plan(pl, threads, smem, grid_x, grid_y, slabs,
                            k_stages, k_steps, conv_grid, scratch_bytes))
    return (int)cudaErrorInvalidValue;
  return search_pass::launch<true>(
      static_cast<const float*>(q), static_cast<const float*>(am_t), sd, sc,
      static_cast<const float*>(offsets), scratch, pl,
      static_cast<int*>(routes), static_cast<int32_t*>(idx),
      static_cast<float*>(sim), B, D, C, tile_rows, tile_cols,
      adc::Adc(clip, step, offsets, pl.gd), (cudaStream_t)stream);
}
