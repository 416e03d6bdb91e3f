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
// Design: the pipelined mainloop of sgemm_tile.cuh (K through a 3-stage
// cp.async ring, a TM x 8 register tile per thread, __fmaf_rn per term in
// increasing k, never TF32), shared with encode_pack.cu, with a plain
// store epilogue: each thread writes its TM rows x 8 consecutive columns
// (two float4 stores per row where N allows). The tile shape is the
// wrapper's choice (binary_mvm.SGEMM_TILE: 64 x 64 blocks of 64 threads,
// 8 x 8 outputs each, K steps of 16, the fastest of the sweep that
// chip_smoke.py prints). Rows past B and columns past N are not stored.
// What holds it above the bound: with 8 x 8 outputs per thread every FMA
// needs 1 byte from shared memory (8 A and 8 B floats per 64 FMAs), and an
// H100 SM delivers 128 bytes of shared memory per clock against 128 fp32
// FMAs per clock, so both pipes must run flat out together to reach it.
#include "sgemm_tile.cuh"

namespace {

template <class TL, bool VEC>
__global__ void __launch_bounds__(TL::NT)
binary_mvm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int B, int K, int N) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int tc = tid % TL::COLS, tr = tid / TL::COLS;
  const int m0 = blockIdx.y * TL::BM;
  const int n0 = blockIdx.x * TL::BN;
  float acc[TL::TM][8];
  sgemm::tile<TL, VEC>(x, w, B, K, N, m0, n0,
                       reinterpret_cast<float*>(smem4), acc);
  const int col0 = n0 + 8 * tc;
#pragma unroll
  for (int r = 0; r < TL::TM; ++r) {
    const int row = m0 + TL::TM * tr + r;
    if (row >= B) continue;
    float* o = out + (size_t)row * N + col0;
    if (VEC && col0 + 8 <= N) {  // N % 4 == 0: 16-byte aligned
      reinterpret_cast<float4*>(o)[0] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      reinterpret_cast<float4*>(o)[1] =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      continue;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (col0 + c < N) o[c] = acc[r][c];
  }
}

template <class TL, bool VEC>
cudaError_t launch(const float* x, const float* w, float* out, int B, int K,
                   int N, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      binary_mvm_kernel<TL, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (B + TL::BM - 1) / TL::BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  binary_mvm_kernel<TL, VEC><<<grid, TL::NT, TL::SMEM, st>>>(x, w, out, B,
                                                             K, N);
  return cudaGetLastError();
}

}  // namespace

// tile: the index into binary_mvm.SGEMM_TILES (sgemm::with_tile). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int binary_mvm_launch(const void* x, const void* w, void* out,
                                 int B, int K, int N, int tile,
                                 void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = sgemm::vec_ok(x, w, K, N);
  return (int)sgemm::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    return vec ? launch<TL, true>(xf, wf, of, B, K, N, st)
               : launch<TL, false>(xf, wf, of, B, K, N, st);
  });
}
