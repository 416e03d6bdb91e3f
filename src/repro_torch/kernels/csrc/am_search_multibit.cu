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
//   routes   (2,) int32              in/out: +1 to [0] (int8) or [1] (fp32)
//   scratch                          the int8 queries, flags, keys and
//                                    tickets (adc::Plan, mirrored by the
//                                    wrapper)
//
// Replaces the TPU kernel src/repro/kernels/am_search_multibit.py:
// am_search_multibit (per array pass, one {0,1} plane product per bit on
// the MXU, combined as sum_p 2^p (q @ U_p) - Qmax * rowsum(q), then
// am_search_imc's ADC epilogue).
//
// Bound on the H100: bytes. The codes are small integers and the queries
// ±1, so the 2*B*C*D code product is exact in int8: at 4 bits, B = C = D
// = 1024 it is 2.15 G-op, 1.09 us at the int8 tensor-core 1,979 TOP/s,
// while reading the 4 MB of float32 queries (and 0.5 MB of planes) takes
// 1.41 us.
//
// Design: two launches (adc_tile.cuh). The convert pass writes an int8
// copy of q with a flag per 64 x 64 tile and resets the fold's keys. The
// search pass, one block of 256 threads per 64-query x 64-column tile
// (256 blocks at B = C = 1024, two an SM: one wave), reads the flags:
// * int8 route (every query an integer in [-127, 127] and
//   max|q| * (Qmax + 1) * min(tile_rows, D) <= 2^24, so every slab partial
//   is exact): each 128-dim stage of a 4-stage cp.async ring holds the
//   tile's int8 query rows and its columns' bytes of all P planes (16
//   bytes of k a column a plane), staged once, not once per plane. All 256
//   threads decode them, one (column, byte) each, into the u8 codes
//   u = sum_p 2^p bit_p of 8 dims (one 8 x 8 bit transpose of the P plane
//   bytes), written as the k-contiguous, swizzled rows that ldmatrix reads
//   as mma B fragments. 8 warps of 16 x 32 run
//   mma.sync.m16n8k32 s8 x u8 -> s32 and take sum q over the same masked
//   query fragments (__dp4a); a slab closes with sum q*u - Qmax * sum q,
//   exact for every u in [0, 2^P - 1] (u - Qmax reaches 128 at 8 bits, so
//   recentred s8 codes would overflow), then offset, ADC and the
//   slab-ordered sum (Int8Walk), bit-equal to ref.am_search_multibit; at
//   the default ADC (a step <= 1, a clip no partial can reach) the ADC is
//   the identity and no slab closes. The decode and the mma steps share
//   the block's instruction issue, the int8 rows' L2 reads its memory
//   pipe (a 128-query tile, decoding each column once for 128 queries, was
//   no faster and left the SIMT route half the warps).
// * fp32 route (queries that are not small integers): the SIMT path the
//   kernel ran before it had an int8 route, unchanged: each 16-dim chunk
//   of the AM is decoded (PlaneAm) into recentred float codes and goes
//   through the SIMT tile of adc::imc_tile (one fmaf per dim, ascending),
//   slab by slab, a 64 x 64 tile a block.
// Every block then folds its rows' first-wins bests into a 64-bit key per
// query (atomicMin); the row tile's last block writes (idx, sim). Dims
// >= D add nothing: the int8 queries are 0 there (the plain version reads
// -Qmax against zero-padded queries). tile_rows must be a multiple of 8.
#include "adc_tile.cuh"

namespace {

constexpr int BM = 64, BN = adc::BN, THREADS = adc::THREADS;
using I8 = adc::Int8<4, 2, true, BM>;  // 8 warps of 16 x 32
constexpr int MAX_PLANES = 8;
constexpr int KBYTES = adc::KB / 8;  // plane bytes of a column in a stage
// A stage: the tile's query rows, then plane p's byte j of column n at
// (p * KBYTES + j) * BN + n.
constexpr int RAW = MAX_PLANES * KBYTES * BN;
constexpr int STAGE = BM * adc::KB + RAW;
constexpr size_t RING = (size_t)adc::NST8 * STAGE;
constexpr size_t CODES = (size_t)BN * adc::KB;  // decoded u8 code rows
constexpr size_t SMEM = RING + CODES + sizeof(float) * BM * adc::SUM_LD;
static_assert(THREADS == sims::TPB, "the fp32 route is sims' 256 threads");
static_assert(sizeof(float) * sims::BK * (BM + 1 + sims::BN + 1) <= RING &&
                  sims::BN == BN,
              "the fp32 route's SIMT tile is the block's");

// The fp32 route's AM operand: stages a 16-dim chunk of the AM as
// recentred float codes u - Qmax.
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

// The u8 codes of 8 dims from their plane bytes, v_p in byte p of x (0
// for p >= P): u_i = sum_p bit_i(v_p) 2^p is bit column i of the 8 x 8 bit
// matrix whose row p is v_p, so a bit transpose (three masked swaps about
// the diagonal) leaves u_i in byte i.
__device__ __forceinline__ unsigned long long transpose8(
    unsigned long long x) {
  unsigned long long t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

__global__ void __launch_bounds__(THREADS)
multibit_search(const float* __restrict__ q,
                const uint8_t* __restrict__ planes,
                const float* __restrict__ offsets,
                const int8_t* __restrict__ q8,
                const unsigned* __restrict__ flags, int n_conv,
                unsigned long long* __restrict__ keys,
                unsigned* __restrict__ tickets, int* __restrict__ routes,
                int32_t* __restrict__ out_idx, float* __restrict__ out_sim,
                int B, int D, int C, int n_planes, int dp, int kp,
                int tile_rows, int tile_cols, adc::Adc adc_cfg, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_max[2], s_colg[BN];
  uint8_t* ring = smem;
  uint8_t* codes = smem + RING;
  float* sum = reinterpret_cast<float*>(smem + RING + CODES);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_stages = kp / adc::KB;
  const int qmax = (1 << (n_planes - 1)) - 1;
  auto load = [&](int s) {
    uint8_t* st = ring + (s % adc::NST8) * STAGE;
#pragma unroll
    for (int i = tid; i < BM * (adc::KB / 16); i += THREADS) {
      const int r = i / (adc::KB / 16), c = i % (adc::KB / 16);
      mma::cp_async16(st + adc::swz(r, c),
                      q8 + (size_t)(row0 + r) * kp + s * adc::KB + 16 * c);
    }
    uint8_t* raw = st + BM * adc::KB;
    const int kb = s * KBYTES;
    if (vec) {  // C % 16 == 0: a 16-column chunk is whole or past C
      for (int i = tid; i < n_planes * KBYTES * (BN / 16); i += THREADS) {
        const int p = i / (KBYTES * (BN / 16));
        const int j = (i / (BN / 16)) % KBYTES, ch = i % (BN / 16);
        const int byte = kb + j, c = col0 + 16 * ch;
        const bool ok = byte < dp && c < C;
        mma::cp_async16_zfill(
            raw + (p * KBYTES + j) * BN + 16 * ch,
            ok ? planes + ((size_t)p * dp + byte) * C + c : planes, ok);
      }
    } else {
      for (int i = tid; i < n_planes * KBYTES * BN; i += THREADS) {
        const int p = i / (KBYTES * BN);
        const int j = (i / BN) % KBYTES, n = i % BN;
        const int byte = kb + j, c = col0 + n;
        raw[(p * KBYTES + j) * BN + n] =
            byte < dp && c < C ? planes[((size_t)p * dp + byte) * C + c] : 0;
      }
    }
  };
  // Stage t's plane bytes -> u8 code rows (column n, dims 8j .. 8j + 7 at
  // bytes 8j ..), then the stage's query rows and the codes. The stage's
  // rows of planes >= P are never written: masked off.
  const unsigned long long planes_mask =
      n_planes == MAX_PLANES ? ~0ull : (1ull << (8 * n_planes)) - 1;
  auto ready = [&](int t, const int8_t*& sa, const int8_t*& sb) {
    const uint8_t* st = ring + (t % adc::NST8) * STAGE;
    const uint8_t* raw = st + BM * adc::KB;
#pragma unroll
    for (int i = tid; i < BN * KBYTES; i += THREADS) {
      const int n = i % BN, j = i / BN;
      unsigned long long x = 0;
#pragma unroll
      for (int p = 0; p < MAX_PLANES; ++p)
        x |= (unsigned long long)raw[(p * KBYTES + j) * BN + n] << (8 * p);
      *reinterpret_cast<unsigned long long*>(codes + adc::swz(n, j >> 1) +
                                             8 * (j & 1)) =
          transpose8(x & planes_mask);
    }
    __syncthreads();  // the codes are complete
    sa = reinterpret_cast<const int8_t*>(st);
    sb = reinterpret_cast<const int8_t*>(codes);
  };
  // The int8 route's first stages load while the flags are read (the
  // fp32 route drops them).
#pragma unroll
  for (int s = 0; s < adc::NST8 - 1; ++s) {
    if (s < n_stages) load(s);
    mma::cp_async_commit();
  }
  adc::tile_columns(s_colg, col0, C, tile_cols);
  const adc::Route route = adc::pick_route(flags, n_conv, 0, qmax + 1,
                                           tile_rows, D, adc_cfg, s_max);
  const bool use8 = route.int8;
  const int gd = (D + tile_rows - 1) / tile_rows;
  const int gc = (C + tile_cols - 1) / tile_cols;
  if (use8) {
    adc::Int8Walk<I8> wk(
        adc::Readout{offsets, s_colg, gd, gc, tile_rows, D, qmax, adc_cfg},
        route.identity);
    adc::int8_walk(wk, n_stages, load, ready);
    if (route.identity) wk.close();
    wk.finish(sum);
  } else {
    mma::cp_async_wait<0>();
    __syncthreads();  // the int8 stages landed: the fp32 staging reuses them
    constexpr int TM = BM / 16;  // queries a thread: 4, a 64 x 64 tile
    auto* qs = reinterpret_cast<float(*)[16 * TM + 1]>(ring);
    auto* as = reinterpret_cast<float(*)[sims::BN + 1]>(
        ring + sizeof(float) * sims::BK * (16 * TM + 1));
    float acc[TM][sims::TN];
    adc::imc_tile<TM>(q, B, D, C, row0, col0, tile_rows, tile_cols, offsets,
                      gc, adc_cfg.clip, adc_cfg.step,
                      PlaneAm{planes, n_planes, dp, (float)qmax}, qs, as, acc);
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < sims::TN; ++j)
        sum[(ty * TM + i) * adc::SUM_LD + tx + 16 * j] = acc[i][j];
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(&routes[use8 ? 0 : 1], 1);
  adc::fold_keys<BM>(sum, row0, col0, B, C, keys, tickets, out_idx,
                     out_sim);
}

}  // namespace

// scratch: scratch_bytes bytes from the caller; routes: (2,) int32 route
// counts. grid_x, grid_y, threads, smem, slabs, k_stages, k_steps,
// conv_grid and scratch_bytes are the wrapper's launch plan
// (kernels/am_search_multibit.py: launch_plan), refused
// (cudaErrorInvalidValue) unless it is adc::Plan's for (B, D, C,
// tile_rows) with this kernel's threads and shared memory. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int am_search_multibit_launch(
    const void* q, const void* planes, const void* offsets, void* scratch,
    long long scratch_bytes, void* routes, void* idx, void* sim, int B,
    int D, int C, int n_planes, int dp, int tile_rows, int tile_cols,
    float clip, float step, int grid_x, int grid_y, int threads, int smem,
    int slabs, int k_stages, int k_steps, int conv_grid, void* stream) {
  if (B <= 0) return 0;
  if (tile_rows <= 0 || tile_rows % 8 || tile_cols <= 0 || C <= 0 ||
      D <= 0 || n_planes < 2 || n_planes > MAX_PLANES || dp * 8 < D ||
      (dp - 1) * 8 >= D)
    return (int)cudaErrorInvalidValue;
  const adc::Plan pl(B, D, C, tile_rows, BM, false, sims::BK);
  if (threads != THREADS || smem != (int)SMEM ||
      !pl.is(grid_x, grid_y, slabs, k_stages, k_steps, conv_grid,
             scratch_bytes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  char* base = static_cast<char*>(scratch);
  int8_t* q8 = reinterpret_cast<int8_t*>(base + pl.q8);
  unsigned* flags = reinterpret_cast<unsigned*>(base + pl.flags);
  auto* keys = reinterpret_cast<unsigned long long*>(base + pl.keys);
  unsigned* tickets = reinterpret_cast<unsigned*>(base + pl.tickets);
  const float* fq = static_cast<const float*>(q);
  adc::convert_pass<<<pl.n_conv, conv::THREADS, 0, s>>>(
      fq, nullptr, 0, 0, B, D, C, pl.bp, pl.cp, pl.kp, 0, pl.n_rt, q8,
      nullptr, flags, keys, tickets);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(multibit_search,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const bool vec = C % 16 == 0 && (uintptr_t)planes % 16 == 0;
  multibit_search<<<dim3(pl.n_ct, pl.n_rt), THREADS, SMEM, s>>>(
      fq, static_cast<const uint8_t*>(planes),
      static_cast<const float*>(offsets), q8, flags, pl.n_conv, keys, tickets,
      static_cast<int*>(routes), static_cast<int32_t*>(idx),
      static_cast<float*>(sim), B, D, C, n_planes, dp, pl.kp, tile_rows,
      tile_cols, adc::Adc(clip, step, offsets, pl.gd), vec);
  return (int)cudaGetLastError();
}
