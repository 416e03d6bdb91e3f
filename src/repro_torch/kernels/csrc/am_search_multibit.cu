// am_search_multibit: the bit-sliced multi-bit associative search, in the
// integer code domain, through the same tiled ADC pipeline as
// am_search_imc.
//
//   q        (B, D) float32          queries (bipolar on the serving path)
//   planes   (P, Dp, C) uint8        offset-code bit planes: bit p of
//                                    u = code + Qmax, 8 dims per byte
//                                    LSB-first, Dp = ceil(D/8),
//                                    P = cell_bits, Qmax = 2^(P-1) - 1
//   offsets  (gd, gc) float32        per-array code-domain offsets, or null
//   idx, sim (B,) int32 / float32    first-wins winner and its similarity
//
// Replaces the TPU kernel src/repro/kernels/am_search_multibit.py:
// am_search_multibit (per array pass, one {0,1} plane product per bit on
// the MXU, combined as sum_p 2^p (q @ U_p) - Qmax * rowsum(q), then
// am_search_imc's ADC epilogue).
//
// Bound on the H100: bytes. The codes are small integers and the queries
// ±1, so the 2*B*C*D code product is exact in int8: at 4 bits, B = C = D
// = 1024 it is 2.15 G-op, 1.09 us at the int8 tensor-core 1,979 TOP/s,
// while reading the 4 MB of float32 queries takes 1.25 us.
//
// Design: no separate plane products — those would cost P times the
// arithmetic on the CUDA cores. While staging a 16-dim chunk of the AM,
// each thread decodes one (byte, column) pair of every plane into 8
// recentred codes u - Qmax in shared memory; the chunk then goes through
// the same fp32 register-tile product as am_search_imc (adc_tile.cuh),
// and each tile_rows slab is closed with offset, ADC and accumulation.
// Every partial sum is an integer of magnitude <= Qmax * tile_rows (<=
// 16,256 at 8 bits), exact in fp32 in any order, so the kernel equals
// ref.am_search_multibit bit for bit. tile_rows must be a multiple of 8,
// so every chunk starts on a byte. Dims >= D stage as 0: the reference
// reads -Qmax there but against zero-padded queries, which adds nothing.
#include "adc_tile.cuh"

namespace {

constexpr int TM = 4;  // queries per thread: 64-query tiles
static_assert(sims::BK % 8 == 0, "chunks must cover whole bytes");

struct PlaneAm {
  const uint8_t* __restrict__ planes;
  int n_planes, dp;
  float qmax;

  __device__ void stage(float (*as)[sims::BN + 1], int k0, int k_end,
                        int col0, int C) const {
    constexpr int BYTES = sims::BK / 8;
    for (int e = threadIdx.x; e < BYTES * sims::BN; e += sims::TPB) {
      const int j = e / sims::BN, n = e % sims::BN;
      const int c = col0 + n, byte = k0 / 8 + j;
      int u[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (c < C && byte < dp) {
        for (int p = 0; p < n_planes; ++p) {
          const int v = planes[((size_t)p * dp + byte) * C + c];
#pragma unroll
          for (int bit = 0; bit < 8; ++bit) u[bit] |= ((v >> bit) & 1) << p;
        }
      }
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const int d = k0 + 8 * j + bit;
        as[8 * j + bit][n] =
            (d < k_end && c < C) ? (float)u[bit] - qmax : 0.0f;
      }
    }
  }
};

__global__ void __launch_bounds__(sims::TPB)
am_search_multibit_partial(const float* __restrict__ q,
                           const uint8_t* __restrict__ planes,
                           const float* __restrict__ offsets,
                           float* __restrict__ part_s,
                           int* __restrict__ part_i, int B, int D, int C,
                           int n_planes, int dp, int tile_rows,
                           int tile_cols, float clip, float step) {
  __shared__ float qs[sims::BK][16 * TM + 1];
  __shared__ float as[sims::BK][sims::BN + 1];
  __shared__ float red_s[16 * TM * 16];
  __shared__ int red_i[16 * TM * 16];
  float acc[TM][sims::TN];
  const int row0 = blockIdx.y * 16 * TM, col0 = blockIdx.x * sims::BN;
  const int gc = (C + tile_cols - 1) / tile_cols;
  const PlaneAm am{planes, n_planes, dp,
                   (float)((1 << (n_planes - 1)) - 1)};
  adc::imc_tile<TM>(q, B, D, C, row0, col0, tile_rows, tile_cols, offsets,
                    gc, clip, step, am, qs, as, acc);
  sims::fold_tile<TM>(acc, row0, col0, B, C, sims::AnyColumn{}, red_s,
                      red_i, part_s, part_i, gridDim.x, blockIdx.x);
}

}  // namespace

// part_s / part_i: (B, ceil(C/64)) scratch from the caller. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int am_search_multibit_launch(
    const void* q, const void* planes, const void* offsets, void* part_s,
    void* part_i, void* idx, void* sim, int B, int D, int C, int n_planes,
    int dp, int tile_rows, int tile_cols, float clip, float step,
    void* stream) {
  if (B <= 0) return 0;
  if (tile_rows <= 0 || tile_rows % 8 || tile_cols <= 0 || C <= 0 ||
      D <= 0 || n_planes < 2 || n_planes > 8 || dp * 8 < D ||
      (dp - 1) * 8 >= D)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_ct = (C + sims::BN - 1) / sims::BN;
  const int n_rt = (B + 16 * TM - 1) / (16 * TM);
  if (n_rt > 65535) return (int)cudaErrorInvalidValue;
  am_search_multibit_partial<<<dim3(n_ct, n_rt), sims::TPB, 0, s>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(planes),
      static_cast<const float*>(offsets), static_cast<float*>(part_s),
      static_cast<int*>(part_i), B, D, C, n_planes, dp, tile_rows,
      tile_cols, clip, step);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sims::fold_rows<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      n_ct, B, static_cast<int32_t*>(idx), static_cast<float*>(sim));
  return (int)cudaGetLastError();
}
