// search_pass.cuh: the two launches of am_search_imc.cu and am_search.cu
// — adc::convert_pass, then the search pass below — which pick one of
// two routes per call on the device.
//
// The convert pass (adc_tile.cuh, int8_convert.cuh) writes int8 copies of
// q and of the (D, C) AM view, with a flag per 64 x 64 tile, and resets
// the fold's keys and tickets. The search pass, one block of 256 threads
// per 128-query x 64-column tile (128 blocks at B = C = 1024, one an SM:
// one wave), reads every flag and takes one route, the same in every
// block; block (0, 0) counts it in routes[] (0: int8, 1: fp32):
// * int8 (every value an integer in [-127, 127], every slab partial
//   exact): 8 warps of 32 x 32 stream the int8 rows through a 4-stage
//   cp.async ring of 128-dim slabs into mma.sync.m16n8k32 (s32, exact;
//   adc::Int8Walk);
// * fp32 (a float operand): the pipelined true-fp32 mainloop of
//   sgemm_tile.cuh at binary_mvm's 128 x 64 tile (3-stage cp.async ring,
//   4 x 8 outputs a thread, one __fmaf_rn per term in increasing k within
//   each slab), reading the AM view k-major with no copy (tile_k_slabs).
// Each block then writes its similarities to a shared-memory sum tile and
// folds each row's first-wins best into a 64-bit key per query
// (adc::fold_keys: atomicMin); the row tile's last block writes
// (idx, sim).
//
// ADC = true (am_search_imc): the K walk is cut into tile_rows slabs, and
// each slab's partial goes through the array's readout offset and the ADC
// before it is added (adc::Readout), on both routes; on the int8 route
// the walk closes no slab where the flags show the ADC is the identity on
// every partial. ADC = false (am_search): the plain dot, one slab of D —
// the int8 route's exact integer dot (every partial below 2^24, so the
// same float32 integer the plain version's sum gives), the fp32 route's
// sequential float32 sum over increasing k.
#pragma once

#include "adc_tile.cuh"
#include "sgemm_tile.cuh"

namespace search_pass {

using FT = sgemm::T0;               // fp32 route: 128 x 64, 4 x 8 a thread
constexpr int BM = 128, BN = adc::BN, THREADS = adc::THREADS;
using I8 = adc::Int8<4, 2, false, BM>;  // int8 route: 8 warps of 32 x 32
static_assert(FT::NT == THREADS && FT::BM == BM && FT::BN == BN,
              "one block tile for both routes");
constexpr int STAGE8 = (BM + BN) * adc::KB;  // query rows, then column rows
constexpr size_t RING8 = (size_t)adc::NST8 * STAGE8;
constexpr size_t RING = RING8 > FT::SMEM ? RING8 : FT::SMEM;
constexpr size_t SMEM = RING + sizeof(float) * BM * adc::SUM_LD;

namespace {

template <bool ADC, bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
search(const float* __restrict__ q, const float* __restrict__ am_t,
       long long sd, long long sc, const float* __restrict__ offsets,
       const int8_t* __restrict__ q8, const int8_t* __restrict__ am8,
       const unsigned* __restrict__ flags, int n_am_tiles, int n_conv,
       unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
       int* __restrict__ routes, int32_t* __restrict__ out_idx,
       float* __restrict__ out_sim, int B, int D, int C, int kp,
       int tile_rows, int tile_cols, adc::Adc adc_cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_max[2], s_colg[BN];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* sum = reinterpret_cast<float*>(smem + RING);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_stages = kp / adc::KB;
  // Stage s of the int8 route: the tile's query rows, then its column
  // rows, 128 bytes of k each.
  auto load8 = [&](int s) {
    int8_t* st = ring + (s % adc::NST8) * STAGE8;
#pragma unroll
    for (int i = tid; i < (BM + BN) * (adc::KB / 16); i += THREADS) {
      const int r = i / (adc::KB / 16), c = i % (adc::KB / 16);
      const int8_t* src = r < BM ? q8 + (size_t)(row0 + r) * kp
                                 : am8 + (size_t)(col0 + r - BM) * kp;
      mma::cp_async16(st + adc::swz(r, c), src + (size_t)s * adc::KB + 16 * c);
    }
  };
  // The int8 route's first stages load while the flags are read (the
  // fp32 route drops them).
#pragma unroll
  for (int s = 0; s < adc::NST8 - 1; ++s) {
    if (s < n_stages) load8(s);
    mma::cp_async_commit();
  }
  if constexpr (ADC) adc::tile_columns(s_colg, col0, C, tile_cols);
  const adc::Route route = adc::pick_route(flags, n_conv, n_am_tiles, 0,
                                           tile_rows, D, adc_cfg, s_max);
  const bool use8 = route.int8;
  const int gd = (D + tile_rows - 1) / tile_rows;
  const int gc = (C + tile_cols - 1) / tile_cols;
  const adc::Readout ro{offsets, s_colg, gd, gc, tile_rows, D, 0, adc_cfg};
  if (use8) {
    const bool identity = !ADC || route.identity;
    adc::Int8Walk<I8> wk(ro, identity);
    adc::int8_walk(wk, n_stages, load8,
                   [&](int t, const int8_t*& sa, const int8_t*& sb) {
                     sa = ring + (t % adc::NST8) * STAGE8;
                     sb = sa + BM * adc::KB;
                   });
    if (identity) wk.close();
    wk.finish(sum);
  } else {
    mma::cp_async_wait<0>();
    __syncthreads();  // the int8 stages landed: the fp32 ring reuses them
    const int tc = tid % FT::COLS, tr = tid / FT::COLS;
    float* fring = reinterpret_cast<float*>(smem);
    if constexpr (ADC) {
      float run[FT::TM][8], off[8];  // off: the open slab's, loaded ahead
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        off[c] = ro.offset(0, tc + FT::COLS * c);
#pragma unroll
        for (int r = 0; r < FT::TM; ++r) run[r][c] = 0.f;
      }
      auto close = [&](float (&acc)[FT::TM][8], int g) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int r = 0; r < FT::TM; ++r) {
            run[r][c] = ro.add(run[r][c], acc[r][c], off[c]);
            acc[r][c] = 0.f;
          }
          if (g + 1 < gd) off[c] = ro.offset(g + 1, tc + FT::COLS * c);
        }
      };
      sgemm::tile_k_slabs<FT, VA, VB>(q, am_t, sc, sd, B, D, C, row0, col0,
                                      tile_rows, fring, close);
#pragma unroll
      for (int r = 0; r < FT::TM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          sum[(FT::TM * tr + r) * adc::SUM_LD + tc + FT::COLS * c] =
              run[r][c];
    } else {
      // One slab of D: its one close hands over the finished sums.
      auto close = [&](float (&acc)[FT::TM][8], int) {
#pragma unroll
        for (int r = 0; r < FT::TM; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            sum[(FT::TM * tr + r) * adc::SUM_LD + tc + FT::COLS * c] =
                acc[r][c];
      };
      sgemm::tile_k_slabs<FT, VA, VB>(q, am_t, sc, sd, B, D, C, row0, col0,
                                      D, fring, close);
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(&routes[use8 ? 0 : 1], 1);
  adc::fold_keys<BM>(sum, row0, col0, B, C, keys, tickets, out_idx,
                     out_sim);
}

template <bool ADC, bool VA, bool VB>
cudaError_t launch_search(dim3 grid, cudaStream_t st, const float* q,
                          const float* am_t, long long sd, long long sc,
                          const float* offsets, const int8_t* q8,
                          const int8_t* am8, const unsigned* flags,
                          int n_am_tiles, int n_conv,
                          unsigned long long* keys, unsigned* tickets,
                          int* routes, int32_t* idx, float* sim, int B, int D,
                          int C, int kp, int tile_rows, int tile_cols,
                          adc::Adc adc_cfg) {
  const cudaError_t e = cudaFuncSetAttribute(
      search<ADC, VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  search<ADC, VA, VB><<<grid, THREADS, SMEM, st>>>(
      q, am_t, sd, sc, offsets, q8, am8, flags, n_am_tiles, n_conv, keys,
      tickets, routes, idx, sim, B, D, C, kp, tile_rows, tile_cols, adc_cfg);
  return cudaGetLastError();
}

// Whether the launch (threads, smem and the adc::Plan fields) is this
// search's own for (B, D, C, tile_rows).
inline bool is_plan(const adc::Plan& pl, int threads, int smem, int grid_x,
                    int grid_y, int slabs, int k_stages, int k_steps,
                    int conv_grid, long long scratch_bytes) {
  return threads == THREADS && smem == (int)SMEM &&
         pl.is(grid_x, grid_y, slabs, k_stages, k_steps, conv_grid,
               scratch_bytes);
}

// Both launches on stream s, the scratch laid out by pl (the launcher has
// checked the plan). Returns the cudaError_t of the launches.
template <bool ADC>
int launch(const float* q, const float* am_t, long long sd, long long sc,
           const float* offsets, void* scratch, const adc::Plan& pl,
           int* routes, int32_t* idx, float* sim, int B, int D, int C,
           int tile_rows, int tile_cols, const adc::Adc& adc_cfg,
           cudaStream_t s) {
  char* base = static_cast<char*>(scratch);
  int8_t* q8 = reinterpret_cast<int8_t*>(base + pl.q8);
  int8_t* am8 = reinterpret_cast<int8_t*>(base + pl.am8);
  unsigned* flags = reinterpret_cast<unsigned*>(base + pl.flags);
  auto* keys = reinterpret_cast<unsigned long long*>(base + pl.keys);
  unsigned* tickets = reinterpret_cast<unsigned*>(base + pl.tickets);
  adc::convert_pass<<<pl.n_conv, conv::THREADS, 0, s>>>(
      q, am_t, sd, sc, B, D, C, pl.bp, pl.cp, pl.kp, pl.n_am_tiles, pl.n_rt,
      q8, am8, flags, keys, tickets);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool va = D % 4 == 0 && (uintptr_t)q % 16 == 0;
  const bool vb = va && sd == 1 && sc % 4 == 0 && (uintptr_t)am_t % 16 == 0;
#define SEARCH_ARGS                                                          \
  dim3(pl.n_ct, pl.n_rt), s, q, am_t, sd, sc, offsets, (const int8_t*)q8,  \
      (const int8_t*)am8, (const unsigned*)flags, pl.n_am_tiles, pl.n_conv,  \
      keys, tickets, routes, idx, sim, B, D, C, pl.kp, tile_rows, tile_cols, \
      adc_cfg
  if (vb)
    e = launch_search<ADC, true, true>(SEARCH_ARGS);
  else if (va)
    e = launch_search<ADC, true, false>(SEARCH_ARGS);
  else
    e = launch_search<ADC, false, false>(SEARCH_ARGS);
#undef SEARCH_ARGS
  return (int)e;
}

}  // namespace

}  // namespace search_pass
