// am_search: associative search over the unpacked AM with a first-wins
// argmax.
//
//   q        (B, D) float32  queries (±1, or float H when queries are not
//                            binarized)
//   am_t     (D, C) float32  the transposed AM, element strides (sd, sc):
//                            the transposed view of the resident (C, D) AM
//   idx      (B,) int32      winning centroid
//   sim      (B,) float32    its similarity q . am[:, idx]
//   routes   (2,) int32      in/out: +1 to [0] (int8 route) or [1] (fp32)
//   scratch                  int8 copies, flags, keys and tickets (layout:
//                            adc::Plan with one slab of D, mirrored by the
//                            wrapper)
//
// Replaces the TPU kernel src/repro/kernels/am_search.py: am_search (a
// (B/bB, C/128, D/128) Pallas grid accumulating 128x128 MXU products in
// VMEM and carrying the running winner across C steps in scratch).
//
// Bound on the H100. On the main path (unpacked serving) both operands
// are ±1: the search is 2*B*C*D = 2.15 G-op of exact int8 tensor-core
// work at B = C = D = 1024 (1.1 us at 1,979 TOP/s), and the 8 MB of float
// operands bound it: 2.5 us at 3.35 TB/s. Float queries (H, not
// binarized) need true fp32: 2.15 GFLOP at 67 TFLOP/s, 32 us (TF32 keeps
// 10 mantissa bits; float queries need all 24).
//
// Design: am_search_imc's two launches (search_pass.cuh) without its ADC:
// the convert pass writes int8 copies of q and of the AM view with a flag
// per 64 x 64 tile; the search pass (128-query x 64-column blocks of 256
// threads, one wave at the main shape) takes, on the device, the same
// route in every block:
// * int8, when every value is an integer in [-127, 127] and
//   max|q| * max|am| * D <= 2^24: mma.sync.m16n8k32 (s32) through a
//   4-stage cp.async ring of 128-dim slabs, one slab of D, no close: the
//   exact integer dot, which converts to the same float32 the plain
//   version's sum gives;
// * fp32 otherwise: the pipelined mainloop of sgemm_tile.cuh (binary_mvm's
//   128 x 64 tile, one __fmaf_rn per term in increasing k, no TF32),
//   reading the AM view k-major with no copy: over ±1 and dyadic queries
//   every partial sum is exact, so the sims equal the plain version's.
// Each block folds its rows into a 64-bit key per query (atomicMin:
// larger sim, then lower index, in any block order), and the row tile's
// last block writes (idx, sim): no partial buffer and no second fold.
#include "search_pass.cuh"

// scratch: scratch_bytes bytes from the caller; routes: (2,) int32 route
// counts. grid_x, grid_y, threads, smem, slabs, k_stages, k_steps,
// conv_grid and scratch_bytes are the wrapper's launch plan
// (kernels/am_search.py: launch_plan), refused (cudaErrorInvalidValue)
// unless it is adc::Plan's for (B, D, C) with one slab of D and this
// kernel's threads and shared memory. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int am_search_launch(const void* q, const void* am_t,
                                long long sd, long long sc, void* scratch,
                                long long scratch_bytes, void* routes,
                                void* idx, void* sim, int B, int D, int C,
                                int grid_x, int grid_y, int threads,
                                int smem, int slabs, int k_stages,
                                int k_steps, int conv_grid, void* stream) {
  if (B <= 0) return 0;
  if (C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const adc::Plan pl(B, D, C, D, search_pass::BM, true,
                     search_pass::FT::BK);
  if (!search_pass::is_plan(pl, threads, smem, grid_x, grid_y, slabs,
                            k_stages, k_steps, conv_grid, scratch_bytes))
    return (int)cudaErrorInvalidValue;
  // No readout: the ADC argument only feeds the route's identity test,
  // which this search does not read.
  return search_pass::launch<false>(
      static_cast<const float*>(q), static_cast<const float*>(am_t), sd, sc,
      nullptr, scratch, pl, static_cast<int*>(routes),
      static_cast<int32_t*>(idx), static_cast<float*>(sim), B, D, C, D,
      adc::BN, adc::Adc(1.f, 1.f, nullptr, 1), (cudaStream_t)stream);
}
