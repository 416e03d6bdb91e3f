// am_search: fp32 associative search over the unpacked ±1 AM with a
// first-wins argmax.
//
//   q     (B, D) float32  queries (±1, or float H when queries are not
//                         binarized)
//   am_t  (D, C) float32  ±1 transposed AM, element strides (sd, sc): the
//                         transposed view of the resident (C, D) AM
//   idx   (B,)   int32    winning centroid
//   sim   (B,)   float32  its similarity q . am[:, idx]
//
// Replaces the TPU kernel src/repro/kernels/am_search.py: am_search (a
// (B/bB, C/128, D/128) Pallas grid accumulating 128x128 MXU products in
// VMEM and carrying the running winner across C steps in scratch).
//
// Bound on the H100: operations. At B = C = D = 1024 it reads 8 MB but
// does 2*B*C*D = 2.15 GFLOP of fp32 FMA, 32 us at the 67 TFLOP/s fp32 rate
// outside the tensor cores (which TF32 would reach, but TF32 keeps 10
// mantissa bits and float queries need all 24).
//
// Design (sims_argmax.cuh): pass 1 gives each (64-query, 64-column) tile
// its own block — 16 x 16 = 256 blocks at the main path's shape, where a
// TPU-style "one block walks all C" would fill only 16 SMs — and writes
// each row's tile winner to a (B, C/64) partial buffer; pass 2 folds the
// partials per query in column-tile order. Nothing carries between blocks
// and no atomics are used, so the result is deterministic.
#include "sims_argmax.cuh"

namespace {

constexpr int TM = 4;  // queries per thread: 64-query tiles

__global__ void __launch_bounds__(sims::TPB)
am_search_partial(const float* __restrict__ q,
                  const float* __restrict__ am_t, long long sd,
                  long long sc, float* __restrict__ part_s,
                  int* __restrict__ part_i, int B, int D, int C) {
  __shared__ float qs[sims::BK][16 * TM + 1];
  __shared__ float as[sims::BK][sims::BN + 1];
  __shared__ float red_s[16 * TM * 16];
  __shared__ int red_i[16 * TM * 16];
  float acc[TM][sims::TN];
  const int row0 = blockIdx.y * 16 * TM, col0 = blockIdx.x * sims::BN;
  sims::tile<TM>(q, am_t, sd, sc, B, D, C, row0, col0, qs, as, acc);
  sims::fold_tile<TM>(acc, row0, col0, B, C, sims::AnyColumn{}, red_s,
                      red_i, part_s, part_i, gridDim.x, blockIdx.x);
}

}  // namespace

// part_s / part_i: (B, ceil(C/64)) scratch from the caller. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int am_search_launch(const void* q, const void* am_t,
                                long long sd, long long sc, void* part_s,
                                void* part_i, void* idx, void* sim, int B,
                                int D, int C, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_ct = (C + sims::BN - 1) / sims::BN;
  const int n_rt = (B + 16 * TM - 1) / (16 * TM);
  if (n_rt > 65535) return (int)cudaErrorInvalidValue;
  am_search_partial<<<dim3(n_ct, n_rt), sims::TPB, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(am_t), sd, sc,
      static_cast<float*>(part_s), static_cast<int*>(part_i), B, D, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sims::fold_rows<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      n_ct, B, static_cast<int32_t*>(idx), static_cast<float*>(sim));
  return (int)cudaGetLastError();
}
