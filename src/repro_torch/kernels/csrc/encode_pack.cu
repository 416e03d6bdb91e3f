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
// Design: the mainloop of sgemm_tile.cuh, shared with binary_mvm.cu and
// with the same tile shape (binary_mvm.SGEMM_TILE): K through a 3-stage
// cp.async ring, each thread a TM x 8 register tile summed with
// __fmaf_rn, one fused fp32 multiply-add per term in increasing k, never
// TF32 or bf16. The 8 columns a thread owns are one packed byte, so the
// epilogue signs and packs straight from registers: the float H never
// reaches device memory. Features padded beyond f and columns beyond D
// load as zero; columns >= D are masked to bit 0. As for binary_mvm, the
// shared-memory reads (1 byte per FMA at 8 x 8 outputs per thread) keep it
// above the fp32 bound.
#include "sgemm_tile.cuh"

namespace {

template <class TL, bool VEC>
__global__ void __launch_bounds__(TL::NT)
encode_pack_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   uint8_t* __restrict__ out, int B, int f, int D) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int tc = tid % TL::COLS;  // packed byte (columns 8tc .. 8tc+7)
  const int tr = tid / TL::COLS;  // rows TM*tr .. TM*tr + TM-1
  const int m0 = blockIdx.y * TL::BM;
  const int n0 = blockIdx.x * TL::BN;

  float acc[TL::TM][8];
  sgemm::tile<TL, VEC>(x, w, B, f, D, m0, n0,
                       reinterpret_cast<float*>(smem4), acc);

  // Sign + pack epilogue: bit c of the byte is column n0 + 8tc + c.
  const int dpb = (D + 7) / 8;
  const int byte_col = n0 / 8 + tc;
  if (byte_col >= dpb) return;
#pragma unroll
  for (int r = 0; r < TL::TM; ++r) {
    const int row = m0 + TL::TM * tr + r;
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

template <class TL, bool VEC>
cudaError_t launch(const float* x, const float* w, uint8_t* out, int B,
                   int f, int D, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      encode_pack_kernel<TL, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D + TL::BN - 1) / TL::BN, (B + TL::BM - 1) / TL::BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  encode_pack_kernel<TL, VEC><<<grid, TL::NT, TL::SMEM, st>>>(x, w, out, B,
                                                              f, D);
  return cudaGetLastError();
}

}  // namespace

// tile: as binary_mvm_launch's. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int encode_pack_launch(const void* x, const void* w, void* out,
                                  int B, int f, int D, int tile,
                                  void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = sgemm::vec_ok(x, w, f, D);
  return (int)sgemm::with_tile(tile, [&](auto tl) {
    using TL = decltype(tl);
    return vec ? launch<TL, true>(xf, wf, o, B, f, D, st)
               : launch<TL, false>(xf, wf, o, B, f, D, st);
  });
}
