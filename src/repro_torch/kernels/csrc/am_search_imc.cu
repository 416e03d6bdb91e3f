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
// Design: two launches (adc_tile.cuh): the convert pass writes int8
// copies of q and the AM view with a flag per 64 x 64 tile and resets the
// fold's keys; the search pass, one block of 256 threads per 128-query x
// 64-column tile (128 blocks at B = C = 1024, one an SM: one wave), reads
// the flags and takes one of two routes, the same in every block:
// * int8 (every value an integer in [-127, 127], every slab partial
//   exact): 8 warps of 32 x 32 stream the int8 rows through a 4-stage
//   cp.async ring of 128-dim slabs into mma.sync.m16n8k32 (s32, exact),
//   closing each tile_rows slab (offset, ADC, slab-ordered sum, in
//   registers) at its boundary, which may cut a 32-dim k step (Int8Walk),
//   or none where the flags show the ADC is the identity on every partial
//   (the ideal instance: ±1 operands, a 16-bit ADC clipped at the rows);
// * fp32 (a float AM): the pipelined true-fp32 mainloop of sgemm_tile.cuh
//   at binary_mvm's 128 x 64 tile (3-stage cp.async ring, 4 x 8 outputs a
//   thread, one __fmaf_rn per term in increasing k within each slab),
//   reading the AM view k-major with no copy (tile_k_slabs), closing each
//   slab the same way. Over ±1 queries every product is exact, so each
//   slab partial is the plain version's sequential float32 sum bit for
//   bit, whatever the AM.
// Each block then writes its running sums to shared memory and folds each
// row's first-wins best into a 64-bit key per query (atomicMin); the row
// tile's last block writes (idx, sim). What bounds the fp32 route: at
// 4 x 8 outputs a thread each FMA needs 1.5 bytes of shared memory, and an
// SM delivers 128 bytes a clock against 128 FMAs (the 64 x 64, 8 x 8 tile
// needs 1 byte, but its 64-thread blocks leave an SM 4 warps).
#include "adc_tile.cuh"
#include "sgemm_tile.cuh"

namespace {

using FT = sgemm::T0;               // fp32 route: 128 x 64, 4 x 8 a thread
constexpr int BM = 128, BN = adc::BN, THREADS = adc::THREADS;
using I8 = adc::Int8<4, 2, false, BM>;  // int8 route: 8 warps of 32 x 32
static_assert(FT::NT == THREADS && FT::BM == BM && FT::BN == BN,
              "one block tile for both routes");
constexpr int STAGE8 = (BM + BN) * adc::KB;  // query rows, then column rows
constexpr size_t RING8 = (size_t)adc::NST8 * STAGE8;
constexpr size_t RING = RING8 > FT::SMEM ? RING8 : FT::SMEM;
constexpr size_t SMEM = RING + sizeof(float) * BM * adc::SUM_LD;

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
imc_search(const float* __restrict__ q, const float* __restrict__ am_t,
           long long sd, long long sc, const float* __restrict__ offsets,
           const int8_t* __restrict__ q8, const int8_t* __restrict__ am8,
           const unsigned* __restrict__ flags, int n_am_tiles, int n_conv,
           unsigned long long* __restrict__ keys,
           unsigned* __restrict__ tickets, int* __restrict__ routes,
           int32_t* __restrict__ out_idx, float* __restrict__ out_sim, int B,
           int D, int C, int kp, int tile_rows, int tile_cols,
           adc::Adc adc_cfg) {
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
  adc::tile_columns(s_colg, col0, C, tile_cols);
  const adc::Route route = adc::pick_route(flags, n_conv, n_am_tiles, 0,
                                           tile_rows, D, adc_cfg, s_max);
  const bool use8 = route.int8;
  const int gd = (D + tile_rows - 1) / tile_rows;
  const int gc = (C + tile_cols - 1) / tile_cols;
  const adc::Readout ro{offsets, s_colg, gd, gc, tile_rows, D, 0, adc_cfg};
  if (use8) {
    adc::Int8Walk<I8> wk(ro, route.identity);
    adc::int8_walk(wk, n_stages, load8,
                   [&](int t, const int8_t*& sa, const int8_t*& sb) {
                     sa = ring + (t % adc::NST8) * STAGE8;
                     sb = sa + BM * adc::KB;
                   });
    if (route.identity) wk.close();
    wk.finish(sum);
  } else {
    mma::cp_async_wait<0>();
    __syncthreads();  // the int8 stages landed: the fp32 ring reuses them
    const int tc = tid % FT::COLS, tr = tid / FT::COLS;
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
                                    tile_rows, reinterpret_cast<float*>(smem),
                                    close);
#pragma unroll
    for (int r = 0; r < FT::TM; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sum[(FT::TM * tr + r) * adc::SUM_LD + tc + FT::COLS * c] = run[r][c];
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(&routes[use8 ? 0 : 1], 1);
  adc::fold_keys<BM>(sum, row0, col0, B, C, keys, tickets, out_idx,
                     out_sim);
}

template <bool VA, bool VB>
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
      imc_search<VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  imc_search<VA, VB><<<grid, THREADS, SMEM, st>>>(
      q, am_t, sd, sc, offsets, q8, am8, flags, n_am_tiles, n_conv, keys,
      tickets, routes, idx, sim, B, D, C, kp, tile_rows, tile_cols, adc_cfg);
  return cudaGetLastError();
}

}  // namespace

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
  const adc::Plan pl(B, D, C, tile_rows, BM, true, FT::BK);
  if (threads != THREADS || smem != (int)SMEM ||
      !pl.is(grid_x, grid_y, slabs, k_stages, k_steps, conv_grid,
             scratch_bytes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  char* base = static_cast<char*>(scratch);
  int8_t* q8 = reinterpret_cast<int8_t*>(base + pl.q8);
  int8_t* am8 = reinterpret_cast<int8_t*>(base + pl.am8);
  unsigned* flags = reinterpret_cast<unsigned*>(base + pl.flags);
  auto* keys = reinterpret_cast<unsigned long long*>(base + pl.keys);
  unsigned* tickets = reinterpret_cast<unsigned*>(base + pl.tickets);
  const float* fq = static_cast<const float*>(q);
  const float* fam = static_cast<const float*>(am_t);
  adc::convert_pass<<<pl.n_conv, conv::THREADS, 0, s>>>(
      fq, fam, sd, sc, B, D, C, pl.bp, pl.cp, pl.kp, pl.n_am_tiles, pl.n_rt,
      q8, am8, flags, keys, tickets);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool va = D % 4 == 0 && (uintptr_t)q % 16 == 0;
  const bool vb = va && sd == 1 && sc % 4 == 0 && (uintptr_t)am_t % 16 == 0;
#define SEARCH_ARGS                                                          \
  dim3(pl.n_ct, pl.n_rt), s, fq, fam, sd, sc,                                \
      static_cast<const float*>(offsets), (const int8_t*)q8,                 \
      (const int8_t*)am8, (const unsigned*)flags, pl.n_am_tiles, pl.n_conv,  \
      keys, tickets, static_cast<int*>(routes), static_cast<int32_t*>(idx),  \
      static_cast<float*>(sim), B, D, C, pl.kp, tile_rows, tile_cols,       \
      adc::Adc(clip, step, offsets, pl.gd)
  if (vb)
    e = launch_search<true, true>(SEARCH_ARGS);
  else if (va)
    e = launch_search<true, false>(SEARCH_ARGS);
  else
    e = launch_search<false, false>(SEARCH_ARGS);
#undef SEARCH_ARGS
  return (int)e;
}
