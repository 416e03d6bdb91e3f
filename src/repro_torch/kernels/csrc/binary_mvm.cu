// binary_mvm: the projection MVM H = x @ w in true fp32.
//
//   x    (B, K) float32 features (or queries)
//   w    (K, N) float32 ±1 weights (the projection, or an AM)
//   out  (B, N) float32
//
// Replaces the TPU kernel src/repro/kernels/binary_mvm.py: binary_mvm (a
// (B/bB, N/128, K/128) Pallas grid of 128x128 MXU tiles, K innermost,
// accumulating in VMEM; one grid step is one IMC array cycle).
//
// Bound on the H100: operations. The features are float, so there is no
// int8 or bf16 shortcut: at B = 1024, K = 784, N = 1024 it is 2*B*K*N =
// 1.64 GFLOP of fp32 FMA, 24.5 us at 67 TFLOP/s, while its 10.4 MB take
// 3.1 us. (cuBLAS SGEMM computes the same function; chip_smoke.py times
// it as the library yardstick. The port does not call it here.)
//
// Design: encode_pack.cu's product loop (sgemm_tile.cuh: 128 x 64 tiles,
// K in steps of 16, a 4 x 8 register tile per thread, __fmaf_rn in
// increasing k, never TF32) with a plain store epilogue: each thread
// writes its 4 rows x 8 consecutive columns. Dims past K and columns past
// N load as zero; rows past B and columns past N are not stored.
#include "sgemm_tile.cuh"

namespace {

__global__ void __launch_bounds__(sgemm::NT)
binary_mvm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int B, int K, int N) {
  __shared__ __align__(16) float As[sgemm::BK][sgemm::AS_LD];
  __shared__ __align__(16) float Bs[sgemm::BK][sgemm::BN];
  const int tid = threadIdx.x;
  const int tc = tid % 8, tr = tid / 8;
  const int m0 = blockIdx.y * sgemm::BM;
  const int n0 = blockIdx.x * sgemm::BN;
  float acc[4][8];
  sgemm::tile(x, w, B, K, N, m0, n0, As, Bs, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + 4 * tr + r;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + 8 * tc + c;
      if (col < N) out[(size_t)row * N + col] = acc[r][c];
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int binary_mvm_launch(const void* x, const void* w, void* out,
                                 int B, int K, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + sgemm::BN - 1) / sgemm::BN,
                  (B + sgemm::BM - 1) / sgemm::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  binary_mvm_kernel<<<grid, sgemm::NT, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), B, K, N);
  return (int)cudaGetLastError();
}
