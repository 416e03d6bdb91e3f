// encode_pack: fused projection MVM + sign + bitpack.
//
//   x    (B, f) float32 features
//   w    (f, D) float32 +-1 projection
//   out  (B, ceil(D/8)) uint8, bit 1 iff H = x @ w >= 0, LSB-first along
//        D; columns >= D pack as 0
//
// Replaces the TPU kernel src/repro/kernels/encode_fused.py:encode_pack
// (128x128 MXU tiles accumulating in VMEM across K, sign-and-pack
// epilogue on the last K step).
//
// Bound on the H100: operations. At the main path's B = 1024, f = 784,
// D = 1024 it does 2*B*f*D = 1.64 GFLOP and must do them in true fp32
// (TF32 flips sign bits near zero), so the least time is 1.64 GFLOP over
// the 67 TFLOP/s of fp32 FMA outside the tensor cores — 24.5 us — while
// its 3.3 MB of bytes take 1 us.
//
// Design: the plain shared-memory SGEMM tile of sgemm_tile.cuh, 128 rows
// x 64 columns per block, K in steps of 16. Each of the 256 threads
// accumulates a 4 x 8 register tile with __fmaf_rn — one fused fp32
// multiply-add per term in increasing k, never TF32 or bf16 (the loop is
// shared with binary_mvm.cu). The 8 columns a thread owns are one
// packed byte, so the epilogue signs and packs straight from registers:
// the float H never reaches device memory. Features padded beyond f and
// columns beyond D load as zero; columns >= D are masked to bit 0.
#include "sgemm_tile.cuh"

namespace {

using sgemm::BM;
using sgemm::BN;  // D columns per block = 8 packed bytes
using sgemm::NT;

__global__ void __launch_bounds__(NT)
encode_pack_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   uint8_t* __restrict__ out, int B, int f, int D) {
  __shared__ __align__(16) float As[sgemm::BK][sgemm::AS_LD];  // As[k][row]
  __shared__ __align__(16) float Bs[sgemm::BK][BN];            // Bs[k][col]

  const int tid = threadIdx.x;
  const int tc = tid % 8;  // packed byte (columns 8tc .. 8tc+7)
  const int tr = tid / 8;  // rows 4tr .. 4tr+3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][8];
  sgemm::tile(x, w, B, f, D, m0, n0, As, Bs, acc);

  // Sign + pack epilogue: bit c of the byte is column n0 + 8tc + c.
  const int dpb = (D + 7) / 8;
  const int byte_col = n0 / 8 + tc;
  if (byte_col >= dpb) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + 4 * tr + r;
    if (row >= B) continue;
    unsigned v = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + 8 * tc + c;
      if (col < D && acc[r][c] >= 0.f) v |= 1u << c;  // -0.0 >= 0 holds
    }
    out[(size_t)row * dpb + byte_col] = (uint8_t)v;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int encode_pack_launch(const void* x, const void* w, void* out,
                                  int B, int f, int D, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM);
  encode_pack_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<uint8_t*>(out), B, f, D);
  return (int)cudaGetLastError();
}
