// am_search_packed: associative search over the packed 1-bit AM, with a
// first-wins argmax, in two modes that return the same (idx, sim) bit for
// bit: XOR + popcount, or mode="unpack", the exact integer dot of the
// operands unpacked to ±1 (0 past n_dims) on the int8 tensor cores.
//
//   q     (B, Dp) uint8   packed queries, LSB-first along D, tail bits 0
//   am_t  (Dp, C) uint8   packed transposed AM (column c = centroid c)
//   idx   (B,)    int32   winning centroid
//   sim   (B,)    float32 n_dims - 2 * popcount(q XOR am[:, idx])
//   scratch               both modes: (B,) uint64 keys, then one ticket
//                         word per query tile, all ones when the kernel
//                         starts, and left all ones when it ends (the
//                         wrapper fills a buffer with ones once and
//                         keeps it for its device and stream)
//
// Replaces the TPU kernel src/repro/kernels/am_search_packed.py:
// am_search_packed, both modes (a (B/bB, C/128, Dp/16) Pallas grid doing
// 8-bit SWAR popcounts on the VPU — or, with mode="unpack", unpacking each
// slab to ±1 in VMEM for the MXU — and carrying the running winner across
// C steps in VMEM scratch).
//
// Bound on the H100: operations. At the main path's B = C = D = 1024 the
// operands are 128 KB + 128 KB (0.08 us at 3.35 TB/s), and popcount mode
// is 2*B*C*D = 2.1 G AND + popcount ops on the 1-bit tensor cores. An
// m16n8k256 .b1 mma issues at the rate of an m16n8k32 .s8 one and covers
// 8x its elements (tools/mma_rate.cu), so the 1-bit peak is 8 x 1,979 =
// 15,832 TOP/s: 0.136 us. Unpack mode is the same 2.1 G ops on the int8
// tensor cores: 1.1 us at 1,979 TOP/s. (Counted as 32-bit popcounts on
// the SMs' popc units, B*C*D/32 = 33.6 M __popc at 16 per clock per SM,
// the first version's arithmetic had a floor of about 8 us.)
//
// Popcount mode runs one algorithm (AND + popcount on the 1-bit tensor
// cores, then the first-wins key fold) by two routes, picked on the host
// from (B, Dp, C, SMs) alone (kernels/am_search_packed.py popcount_route):
// the tile route (popcount::search) below, tuned at B = C = 1024 and B =
// 32, and the sweep route (popcount::search_sweep) after it, for large B
// x C: D <= 1024, B >= 128, B x C >= 2^21 and a grid of query tiles x
// column groups of a quarter of the SMs or more. On the H100: B = C =
// 1024, tile 0.0089 ms, sweep 0.0091; B 4,096 x C 1,024, 0.020 / 0.0094;
// B 4,096 x C 100,000, 1.48 / 0.185 (PERF.md §6).
//
// Tile route (popcount::search). What held the first version back (0.0548
// ms at the main shape):
// one block per block_b queries walked all C columns alone (128 blocks at
// B = 1024, 4 at B = 32), each 64-column AM tile was staged byte by byte
// with nothing in flight, and every thread did 1 + QPT shared loads per
// QPT XOR + __popc. Now:
// * Arithmetic: mma.sync.m16n8k256 .b1 .and.popc counts popc(q AND a)
//   over 256 dims a step (the packed bytes are its operands as they are);
//   with P_q and P_a the popcounts of the query's and the column's bits,
//   hamming = P_q + P_a - 2 popc(q AND a), exact (bits past n_dims are 0
//   in both operands). One instruction covers 16 x 8 x 256 bits, eight
//   times the elements of an int8 m16n8k32 step.
// * Grid: (query tiles of max(16, block_b) rows: one or two m16 tiles) x
//   (column splits of 128 columns, halved down to 8 while the grid has
//   fewer blocks than the device has SMs, 132 on an H100): 512 blocks at
//   B = 1024, 256 blocks of 8
//   columns at B = 32. A block has up to 4 warps, each owning 1, 2 or 4 n8
//   tiles of the split and every row of the tile.
// * Staging (b1_slab.cuh, shared with am_shortlist.cu): both operands'
//   packed bytes stream through a 4-stage cp.async ring of 32-byte k slabs
//   (one m16n8k256 step), three slabs ahead, one barrier a slab: 16-byte
//   copies where Dp, C and the pointers allow (8-byte ones for an
//   8-column split), byte copies otherwise. Bytes past Dp are staged as 0
//   in BOTH operands, so D = 100 (Dp = 13) needs no host-side padding
//   pass. A fragments come from the query rows by ldmatrix; a column's B
//   words are gathered byte by byte from the AM slab, whose byte row
//   4w + k is stored at row 8k + w, so a warp's four k-lanes read
//   distinct banks.
// * Fold: each row's least key (hamming << 32) | idx over the lane's
//   columns (columns >= C skipped), its four lanes and the block's warps
//   goes to the query's scratch key with a 64-bit atomicMin: the least
//   key is the first-wins winner whatever the block order, ties across
//   splits included. The query tile's last block to finish (a ticket word
//   per tile) writes idx and sim = n_dims - 2 * hamming and restores the
//   scratch to all ones (finish_tile), so no memset launch runs before
//   the kernel.
//
// Sweep route (popcount::search_sweep). What held the tile route back at
// the benchmark's B 4,096 x C 100,000 (1.46-1.50 ms against a 1-bit bound
// of 0.053 ms): 200,192 blocks of 16 rows x 128 columns, each staging 16
// KB of AM for 64 mma (the ring never in steady state), the 12.8 MB AM
// read from L2 once per 16 query rows (3.7 GB a batch), B words gathered
// byte by byte for one m16 tile each, and 3.2 M 64-bit atomics. Now:
// * Grid: (query tiles of 128 rows) x (column groups): sms / query tiles
//   groups, each walking at least 4 column tiles of 128, so the grid is
//   one wave of 8-warp blocks (225 registers, one block an SM): (32, 4)
//   at B = 4,096, (2, 66) at B = 256. The AM is read from L2 once per
//   128 query rows (0.41 GB a batch).
// * Resident queries: the block stages its 128 query rows once and each
//   warp (64 rows x 32 columns of a tile: 4 m16 x 4 n8) holds its A
//   fragments for all of D in registers (D <= 1024) for the whole walk.
// * Column walk: whole column tiles (all of Dp x 128 columns) stream
//   through a 4-stage cp.async ring in column order, one barrier a tile;
//   each thread's KS copies of a tile come from pointers set once (a
//   template instance for 16-byte aligned AM rows, C % 16 == 0, keeps the
//   byte path out of the loop) and go out after the tile's products are
//   issued (0.224 -> 0.187 ms at B 4,096 x C 100,000; an SM sub-partition
//   issues a warp's b1 mma every 6 cycles, so the copies' and the fold's
//   integer instructions do not hide under the products: taking the
//   loads or the fold away each saved 0.048 ms, and neither a fold
//   deferred into the next tile's products, nor the two row groups of
//   warps taking the phases in turn, nor a 6-stage ring saved anything).
//   A tile's byte rows are staged permuted (b1::sweep_row) so that one
//   ldmatrix .x4 .trans and four byte permutes give a lane the B words of
//   two n8 tiles at one k slab, no byte-by-byte gather, each B fragment
//   feeding 4 m16 tiles; P_a comes from one more mma a fragment, of an
//   all-ones A, so no popc of B words.
// * Keys in registers: each (row, column) becomes the 32-bit key (P_a - 2
//   popc(q AND a) + 1024) << 20 | column - the group's first column (one
//   IMAD from the column's (P_a + 1024) << 20 | column) and the lane keeps
//   each row's least with a three-way min: lexicographic on (hamming,
//   column), so the lowest column wins a tie in any order.
// * Fold: once a block, after the walk: the four lanes of a row, the four
//   column warps in shared memory, then hamming = P_q + (key >> 20) -
//   1024 and one 64-bit atomicMin a row on (hamming << 32) | idx, and
//   finish_tile as the tile route: 4,096 x 4 atomics a batch.
//
// Unpack mode (am_search_packed_unpack_kernel). What held the SIMT version
// back (0.31 ms at the main shape): one block per 8 queries walked all C
// columns alone (128 blocks), and every 128-dim slab was unpacked to
// float32 bit by bit and multiplied with scalar fmaf. Now:
// * Grid: (query tiles of BM = 16 or 32 rows) x (column splits of 128):
//   512 blocks of 4 warps at B = C = 1024, BM 16. Warp w owns columns
//   32w .. 32w+31 of the split (four n8 tiles) and every row of the tile.
// * The packed bytes stream through a 4-stage ring of 32-byte k slabs
//   (256 dims; 16-byte cp.async copies where Dp, C and the pointers
//   allow, byte copies otherwise), three slabs ahead, one barrier a slab:
//   at D = 1024 every load is in flight before the first product.
// * Each lane builds its mma.sync.m16n8k32.s8 fragments straight from
//   the packed bytes, with no unpacked tile in shared memory. The k order
//   inside a 32-dim step is permuted (the same permutation for A and B,
//   so the dot is unchanged) so that the 8 dims of lane tig's A and B
//   registers are byte tig of the step's packed word: the low nibble feeds
//   a[0] / b[0], the high nibble a[2] / b[1]. A nibble spreads to four
//   bytes with one multiply and one AND ((x * 0x204081) & 0x01010101);
//   the query side then becomes ±1 with one more multiply (~(s * 0xFE)),
//   and, in the step that n_dims cuts, 0 past n_dims. The AM side stays
//   {0, 1}. The s32 accumulator is then the exact sum_i q_i y_i with
//   q_i in {-1, 0, 1}, y_i in {0, 1}, and with P = the popcount of the
//   query's valid bits, hamming = P - sum_i q_i y_i exactly (what differs
//   is x=1,y=0 plus x=0,y=1): the dot of the ±1 operands is
//   n_dims - 2 * hamming. Each warp counts P over a quarter of the k
//   steps from the bytes it already read. Columns >= C are skipped.
// * Fold: each lane keeps min((hamming << 32) | idx) over its columns,
//   the four lanes of a row fold with shuffles, the four warps in shared
//   memory, and the block folds its keys into the query's scratch key with
//   a 64-bit atomicMin. The least key is the first-wins winner whatever
//   the block order. The last block of a query tile to finish (a ticket
//   word per tile) writes idx = key & 0xffffffff and
//   sim = n_dims - 2 * hamming (finish_tile, shared with popcount mode). (A fold over a thread block cluster
//   through distributed shared memory, with no scratch, ran slower on the
//   H100: its barrier holds every split for the slowest.)
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "b1_slab.cuh"
#include "mma_sync.cuh"

namespace {

using b1::SLAB;    // packed bytes (256 dims) per k slab, both modes
using b1::STAGES;  // ring stages, both modes
using b1::stage16;
constexpr unsigned FULL = 0xffffffffu;

// The end of both modes' fold, after the block's atomicMins: the query
// tile's last block to finish (tickets start at ~0: the first block draws
// 0) writes each of its rows' winner from the key (hamming << 32) | idx,
// and puts the rows' keys and the tile's ticket back to ~0, so the
// scratch is ready for the next launch on the stream with no memset.
// last: a shared int of the block.
__device__ __forceinline__ void finish_tile(
    unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
    int b0, int rows, int B, int n_dims, int32_t* __restrict__ out_idx,
    float* __restrict__ out_sim, int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(&tickets[blockIdx.x], 1u) + 1u == gridDim.y - 1u;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows && b0 + i < B; i += blockDim.x) {
    const unsigned long long key =
        *reinterpret_cast<volatile unsigned long long*>(&keys[b0 + i]);
    out_idx[b0 + i] = (int32_t)(key & 0xffffffffu);
    out_sim[b0 + i] = (float)(n_dims - 2 * (int)(key >> 32));
    keys[b0 + i] = ~0ull;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = ~0u;
}

// The fold's scratch is (B,) uint64 keys, then a ticket word per query
// tile, scratch_bytes of it, all ones (a key of ~0 loses to any
// column's).
inline bool scratch_is(const void* scratch, long long scratch_bytes, int B,
                       int tiles) {
  return scratch != nullptr && scratch_bytes == 8LL * B + 4LL * tiles;
}

namespace popcount {

using b1::am_stride;
using b1::QSTR;
constexpr int MAX_COLS = 128;      // columns of a block: 128, 64, ..., 8
constexpr int MIN_COLS = 8;

// Columns of a block for query tiles of `rows` on a device of `sms` SMs:
// the widest whose grid has a block per SM, else MIN_COLS
// (kernels/am_search_packed.py: popcount_cols mirrors it).
inline int block_cols(int B, int C, int rows, int sms) {
  const long long tiles = (B + rows - 1) / rows;
  int cols = MAX_COLS;
  while (cols > MIN_COLS && tiles * ((C + cols - 1) / cols) < sms)
    cols /= 2;
  return cols;
}
// Warps of a block: one per 8 n8 columns up to 4, each owning NI =
// cols / 8 / warps n8 tiles.
inline int block_warps(int cols) { return cols >= 32 ? 4 : cols / 8; }
// Dynamic shared memory: the ring (query rows, then AM byte rows), then
// the warps' keys of each row.
inline int smem_bytes(int rows, int cols) {
  return STAGES * b1::stage_bytes(rows, cols) + 8 * block_warps(cols) * rows;
}

template <int MI, int NI>
__global__ void __launch_bounds__(128)
search(const uint8_t* __restrict__ q, const uint8_t* __restrict__ am_t,
       unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
       int32_t* __restrict__ out_idx, float* __restrict__ out_sim, int B,
       int Dp, int C, int n_dims, bool q_vec, bool a_vec, bool a_vec8) {
  constexpr int R = 16 * MI;       // query rows of the block
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nw = blockDim.x >> 5, cols = 8 * NI * nw;
  const int as_ld = am_stride(cols);
  const int b0 = blockIdx.x * R, c0 = blockIdx.y * cols;
  const int n_slabs = (Dp + SLAB - 1) / SLAB;
  uint8_t* qring = smem;                          // [STAGES][R][QSTR]
  uint8_t* aring = smem + STAGES * R * QSTR;      // [STAGES][SLAB][as_ld]
  auto* red = reinterpret_cast<unsigned long long*>(
      aring + STAGES * SLAB * as_ld);             // [nw][R]

  // Slab t into ring stage st (b1_slab.cuh).
  auto load = [&](int t, int st) {
    b1::load_slab<R>(qring + st * R * QSTR, aring + st * SLAB * as_ld, q,
                     am_t, t, b0, B, Dp, c0, cols, C, q_vec, a_vec, a_vec8);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_slabs) load(t, t);
    mma::cp_async_commit();
  }

  int acc[MI][NI][4];  // popc(q AND a) of the lane's accumulator entries
  int pq[MI][2];       // the lane's share of rows gid, gid + 8's popcounts
  int pa[NI];          // ... of column gid's, in each n8 tile
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    pq[mi][0] = pq[mi][1] = 0;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) pa[ni] = 0;
  for (int t = 0; t < n_slabs; ++t) {
    mma::cp_async_wait<STAGES - 2>();  // slab t landed (this thread's)
    __syncthreads();  // ... everyone's copies; slab t-1's stage is free
    if (t + STAGES - 1 < n_slabs)
      load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    mma::cp_async_commit();
    const uint8_t* qs = qring + (t % STAGES) * R * QSTR;
    const uint8_t* as =
        aring + (t % STAGES) * SLAB * as_ld + 8 * NI * warp + gid;
    // A: rows gid / gid + 8, words tig and 4 + tig of the slab.
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      b1::a_frag(a[mi], qs + 16 * mi * QSTR, lane);
      pq[mi][0] += __popc(a[mi][0]) + __popc(a[mi][2]);
      pq[mi][1] += __popc(a[mi][1]) + __popc(a[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      // B: column gid's words tig and 4 + tig, byte k from row k KW + w.
      uint32_t b[2];
      b1::b_frag(b, as + 8 * ni, tig, as_ld);
      pa[ni] += __popc(b[0]) + __popc(b[1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma::mma_b1_and(acc[mi][ni], a[mi], b[0], b[1]);
    }
  }
  mma::cp_async_wait<0>();

  // hamming = P_q + P_a - 2 popc(q AND a): the bits past n_dims are 0 in
  // both operands. The four lanes of a row (column) hold a quarter of its
  // popcount each; column 2 tig + j's total sits in lanes 4 (2 tig + j).
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      pq[mi][0] += __shfl_xor_sync(FULL, pq[mi][0], o);
      pq[mi][1] += __shfl_xor_sync(FULL, pq[mi][1], o);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) pa[ni] += __shfl_xor_sync(FULL, pa[ni], o);
  }
  int pc[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      pc[ni][j] = __shfl_sync(FULL, pa[ni], 4 * (2 * tig + j));
  // Each row's least key (hamming << 32) | idx: over the lane's columns,
  // its row's four lanes, then the block's warps.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned long long best = ~0ull;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + 8 * (NI * warp + ni) + 2 * tig + j;
          const int ham =
              pq[mi][half] + pc[ni][j] - 2 * acc[mi][ni][2 * half + j];
          const unsigned long long key =
              (unsigned long long)ham << 32 | (unsigned)c;
          if (c < C && key < best) best = key;
        }
      }
      best = min(best, __shfl_xor_sync(FULL, best, 1));
      best = min(best, __shfl_xor_sync(FULL, best, 2));
      if (tig == 0) red[warp * R + 16 * mi + 8 * half + gid] = best;
    }
  }
  __syncthreads();
  if (tid < R && b0 + tid < B) {
    unsigned long long key = red[tid];
    for (int w = 1; w < nw; ++w) key = min(key, red[w * R + tid]);
    atomicMin(&keys[b0 + tid], key);  // warp 0 holds a column < C
  }
  finish_tile(keys, tickets, b0, R, B, n_dims, out_idx, out_sim, &s_last);
}

template <int MI>
int launch(const uint8_t* q, const uint8_t* am_t, void* scratch, void* idx,
           void* sim, int B, int Dp, int C, int n_dims, int cols,
           int grid_x, int grid_y, int smem, long long scratch_bytes,
           int sms, cudaStream_t stream) {
  constexpr int R = 16 * MI;
  const int tiles = (B + R - 1) / R;
  if (cols != block_cols(B, C, R, sms) || grid_x != tiles ||
      grid_y != (C + cols - 1) / cols || smem != smem_bytes(R, cols) ||
      !scratch_is(scratch, scratch_bytes, B, tiles) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(keys + B);
  const bool q_vec = Dp % 16 == 0 && (uintptr_t)q % 16 == 0;
  const bool a_vec = C % 16 == 0 && (uintptr_t)am_t % 16 == 0;
  const bool a_vec8 = C % 8 == 0 && (uintptr_t)am_t % 8 == 0;
  const int nw = block_warps(cols), ni = cols / 8 / nw;
  const dim3 grid(grid_x, grid_y);
#define POPCOUNT(NI)                                                        \
  search<MI, NI><<<grid, 32 * nw, smem, stream>>>(                          \
      q, am_t, keys, tickets, static_cast<int32_t*>(idx),                   \
      static_cast<float*>(sim), B, Dp, C, n_dims, q_vec, a_vec, a_vec8)
  switch (ni) {
    case 4: POPCOUNT(4); break;
    case 2: POPCOUNT(2); break;
    default: POPCOUNT(1); break;
  }
#undef POPCOUNT
  return (int)cudaGetLastError();
}

// -- The sweep route (search_sweep) ------------------------------------------
constexpr int SW_ROWS = 128;     // query rows of a block, resident
constexpr int SW_COLS = 128;     // columns of a tile of the walk
constexpr int SW_WARPS = 8;      // 2 x 4 warps of 64 rows x 32 columns
constexpr int SW_STAGES = 4;     // column tiles in the ring
constexpr int SW_MAX_DP = 128;   // D <= 1024: the A fragments in registers
constexpr int SW_MIN_WALK = 4;   // column tiles a group walks at least
constexpr int SW_LOCAL = 20;     // bits of a key's column within its group
constexpr int SW_OFS = 1024;     // >= any P_q >= 2 popc(q AND a) - P_a
constexpr int SW_MAX_WALK = ((1 << SW_LOCAL) - 1) / SW_COLS;

// Column groups: one wave of blocks (sms / query tiles), each walking at
// least SW_MIN_WALK column tiles, and each group's columns within
// SW_LOCAL bits (kernels/am_search_packed.py: sweep_groups mirrors it).
inline int sweep_groups(int B, int C, int sms) {
  const int tiles = (B + SW_ROWS - 1) / SW_ROWS;
  const int ct = (C + SW_COLS - 1) / SW_COLS;
  int g = sms / tiles < ct / SW_MIN_WALK ? sms / tiles : ct / SW_MIN_WALK;
  if (g < 1) g = 1;
  const int need = (ct + SW_MAX_WALK - 1) / SW_MAX_WALK;
  return g < need ? need : g;
}
// Dynamic shared memory: the query tile (rows 32 KS + 16 bytes apart), the
// ring of column tiles, the four column warps' keys of each row.
inline int sweep_smem(int ks) {
  return SW_ROWS * (32 * ks + 16) + SW_STAGES * 32 * ks * b1::SWEEP_ASTR +
         4 * 4 * SW_ROWS;
}

// KS: 32-byte k slabs of D (Dp <= 32 KS); AVEC: the AM's rows are 16-byte
// aligned (C % 16 == 0), so its copies are cp.async. Grid: (query tiles
// of 128 rows) x (column groups); group g walks column tiles
// [g ct / G, (g+1) ct / G).
template <int KS, bool AVEC>
__global__ void __launch_bounds__(32 * SW_WARPS, 1)
search_sweep(const uint8_t* __restrict__ q, const uint8_t* __restrict__ am_t,
             unsigned long long* __restrict__ keys,
             unsigned* __restrict__ tickets, int32_t* __restrict__ out_idx,
             float* __restrict__ out_sim, int B, int Dp, int C, int n_dims,
             bool q_vec) {
  constexpr int QS = 32 * KS + 16;  // query row stride: 8 bank groups
  constexpr int AROWS = 32 * KS;    // AM byte rows of a column tile
  constexpr int ASTR = b1::SWEEP_ASTR;
  constexpr int MI = 4, NI = 4;     // a warp's m16 and n8 tiles
  constexpr unsigned LOCAL_MASK = (1u << SW_LOCAL) - 1u;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  uint8_t* qt = smem;                                    // [128][QS]
  uint8_t* ring = smem + SW_ROWS * QS;                   // [STAGES][AROWS][ASTR]
  auto* red = reinterpret_cast<unsigned*>(
      ring + SW_STAGES * AROWS * ASTR);                  // [4][128]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int b0 = blockIdx.x * SW_ROWS;
  const int ct = (C + SW_COLS - 1) / SW_COLS;
  const int t0 = (int)((long long)blockIdx.y * ct / gridDim.y);
  const int n_t = (int)((long long)(blockIdx.y + 1) * ct / gridDim.y) - t0;
  const int col0 = t0 * SW_COLS;  // the group's first column

  // The query tile, once: bytes past Dp and rows past B are 0.
  for (int e = tid; e < SW_ROWS * 2 * KS; e += 32 * SW_WARPS) {
    const int r = e / (2 * KS), byte = 16 * (e % (2 * KS)), b = b0 + r;
    const bool ok = b < B && byte < Dp;
    b1::stage16(qt + r * QS + byte, ok ? q + (size_t)b * Dp + byte : q, ok,
                Dp - byte, q_vec);
  }
  // Column tile t of the walk into ring stage st: byte row kb to row
  // 32 (kb / 32) + sweep_row(kb % 32); bytes past Dp and columns past C
  // are 0. KS 16-byte copies a thread: byte rows tid / 8 + 32 i, the 16
  // columns at 16 (tid % 8), from pointers set once.
  const int krow = tid >> 3, chunk = 16 * (tid & 7);
  const uint8_t* src0 = am_t + (size_t)krow * C + col0 + chunk;
  uint8_t* dst0 = ring + b1::sweep_row(krow) * ASTR + chunk;
  auto load = [&](int t, int st) {
    const int cc = col0 + t * SW_COLS + chunk;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const bool ok = krow + 32 * i < Dp && cc < C;
      uint8_t* dst = dst0 + (st * AROWS + 32 * i) * ASTR;
      const uint8_t* src = src0 + t * SW_COLS + (size_t)32 * i * C;
      if (AVEC)
        mma::cp_async16_zfill(dst, ok ? src : am_t, ok);
      else
        b1::stage16(dst, ok ? src : am_t, ok, C - cc, false);
    }
  };
#pragma unroll
  for (int t = 0; t < SW_STAGES - 1; ++t) {
    if (t < n_t) load(t, t);
    mma::cp_async_commit();  // the query tile rides in the first group
  }
  mma::cp_async_wait<SW_STAGES - 2>();
  __syncthreads();
  // The warp's 64 query rows over all of D, held for the whole walk.
  uint32_t a[MI][KS][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int s = 0; s < KS; ++s)
      b1::a_frag_at(a[mi][s], qt + (64 * wm + 16 * mi) * QS + 32 * s, lane,
                    QS);
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
  // Running best key of rows gid, gid + 8 of each m16 tile:
  // (P_a - 2 popc(q AND a) + SW_OFS) << SW_LOCAL | column - col0.
  unsigned best[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) best[mi][0] = best[mi][1] = ~0u;

  for (int t = 0; t < n_t; ++t) {
    mma::cp_async_wait<SW_STAGES - 2>();  // tile t landed (this thread's)
    __syncthreads();  // ... everyone's copies; tile t-1's stage is free
    const uint8_t* st = ring + (t % SW_STAGES) * AROWS * ASTR + 32 * wn;
    int acc[MI][NI][4];  // popc(q AND a)
    int pa[NI][4];       // P_a: an all-ones query row's popc(1 AND a)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t b[NI][2];
      b1::sweep_b_frags(b, st + 32 * s * ASTR, lane);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        if (s == 0) {
          mma::mma_b1_and_init(pa[ni], ones, b[ni][0], b[ni][1]);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma::mma_b1_and_init(acc[mi][ni], a[mi][s], b[ni][0], b[ni][1]);
        } else {
          mma::mma_b1_and(pa[ni], ones, b[ni][0], b[ni][1]);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma::mma_b1_and(acc[mi][ni], a[mi][s], b[ni][0], b[ni][1]);
        }
      }
    }
    // The copies of tile t + 3 go out while the products are in flight.
    if (t + SW_STAGES - 1 < n_t)
      load(t + SW_STAGES - 1, (t + SW_STAGES - 1) % SW_STAGES);
    mma::cp_async_commit();
    // n8 tile ni = 2 p + e: accumulator entries 0 / 2 hold the warp's column
    // 16 p + 4 tig + e, entries 1 / 3 column 16 p + 4 tig + 2 + e. A column's
    // key base is (P_a + SW_OFS) << SW_LOCAL | its column - col0; a key is
    // base - popc(q AND a) << (SW_LOCAL + 1): one IMAD, and the fold a
    // three-way min, per (row, column). Columns past C: ~0, never least.
    const unsigned kt = ((unsigned)SW_OFS << SW_LOCAL) +
                        (unsigned)(t * SW_COLS + 32 * wn + 4 * tig);
    const int cl = col0 + t * SW_COLS + 32 * wn + 4 * tig;
    const bool ragged = col0 + (t + 1) * SW_COLS > C;
    unsigned kc[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = 16 * (ni >> 1) + 2 * j + (ni & 1);
        kc[ni][j] = ((unsigned)pa[ni][j] << SW_LOCAL) + kt + off;
        if (ragged && cl + off >= C) kc[ni][j] = ~0u;
      }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          best[mi][h] = __vimin3_u32(
              best[mi][h],
              kc[ni][0] - ((unsigned)acc[mi][ni][2 * h] << (SW_LOCAL + 1)),
              kc[ni][1] -
                  ((unsigned)acc[mi][ni][2 * h + 1] << (SW_LOCAL + 1)));
  }
  mma::cp_async_wait<0>();

  // Each row's least key: its four lanes, then the four column warps;
  // then hamming = P_q + (key >> SW_LOCAL) - SW_OFS, one 64-bit atomicMin
  // a row into the query's (hamming << 32) | idx, and finish_tile.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned v = best[mi][h];
      v = min(v, __shfl_xor_sync(FULL, v, 1));
      v = min(v, __shfl_xor_sync(FULL, v, 2));
      if (tig == 0) red[wn * SW_ROWS + 64 * wm + 16 * mi + 8 * h + gid] = v;
    }
  __syncthreads();
  if (tid < SW_ROWS && b0 + tid < B) {
    const unsigned k = min(min(red[tid], red[SW_ROWS + tid]),
                           min(red[2 * SW_ROWS + tid], red[3 * SW_ROWS + tid]));
    const auto* row = reinterpret_cast<const uint32_t*>(qt + tid * QS);
    int pq = 0;
#pragma unroll
    for (int w = 0; w < 8 * KS; ++w) pq += __popc(row[w]);
    const int ham = pq + (int)(k >> SW_LOCAL) - SW_OFS;
    atomicMin(&keys[b0 + tid], (unsigned long long)ham << 32 |
                                   (unsigned)(col0 + (int)(k & LOCAL_MASK)));
  }
  finish_tile(keys, tickets, b0, SW_ROWS, B, n_dims, out_idx, out_sim,
              &s_last);
}

template <int KS, bool AVEC>
int launch_sweep(const uint8_t* q, const uint8_t* am_t, void* scratch,
                 void* idx, void* sim, int B, int Dp, int C, int n_dims,
                 int grid_x, int grid_y, int smem, long long scratch_bytes,
                 int sms, cudaStream_t stream) {
  const int tiles = (B + SW_ROWS - 1) / SW_ROWS;
  if (grid_x != tiles || grid_y != sweep_groups(B, C, sms) ||
      smem != sweep_smem(KS) ||
      !scratch_is(scratch, scratch_bytes, B, tiles) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      search_sweep<KS, AVEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sweep_smem(KS));
  if (attr != cudaSuccess) return (int)attr;
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(keys + B);
  const bool q_vec = Dp % 16 == 0 && (uintptr_t)q % 16 == 0;
  search_sweep<KS, AVEC>
      <<<dim3(grid_x, grid_y), 32 * SW_WARPS, smem, stream>>>(
          q, am_t, keys, tickets, static_cast<int32_t*>(idx),
          static_cast<float*>(sim), B, Dp, C, n_dims, q_vec);
  return (int)cudaGetLastError();
}

int launch_sweep_ks(const uint8_t* q, const uint8_t* am_t, void* scratch,
                    void* idx, void* sim, int B, int Dp, int C, int n_dims,
                    int rows, int cols, int grid_x, int grid_y, int smem,
                    long long scratch_bytes, int sms, cudaStream_t stream) {
  if (rows != SW_ROWS || cols != SW_COLS || Dp > SW_MAX_DP)
    return (int)cudaErrorInvalidValue;
  const bool a_vec = C % 16 == 0 && (uintptr_t)am_t % 16 == 0;
#define SWEEP(KS)                                                            \
  (a_vec ? launch_sweep<KS, true>(q, am_t, scratch, idx, sim, B, Dp, C,      \
                                  n_dims, grid_x, grid_y, smem,              \
                                  scratch_bytes, sms, stream)                \
         : launch_sweep<KS, false>(q, am_t, scratch, idx, sim, B, Dp, C,     \
                                   n_dims, grid_x, grid_y, smem,             \
                                   scratch_bytes, sms, stream))
  switch ((Dp + 31) / 32) {
    case 1: return SWEEP(1);
    case 2: return SWEEP(2);
    case 3: return SWEEP(3);
    default: return SWEEP(4);
  }
#undef SWEEP
}

}  // namespace popcount

namespace unpack {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 128;           // columns per block: 4 n8 tiles a warp
constexpr int NI = BN / WARPS / 8;
// Shared row strides, multiples of 16 bytes for cp.async; a warp's byte
// reads then fall in distinct banks (query rows 12 words apart, AM rows
// 36).
constexpr int QSTR = 48;
constexpr int ASTR = BN + 16;

template <int MI>
struct Smem {
  uint8_t q[STAGES][16 * MI * QSTR];  // query rows x slab bytes
  uint8_t a[STAGES][SLAB * ASTR];     // slab bytes x the block's columns
  unsigned long long red[WARPS][16 * MI];
  int pop[WARPS][16 * MI];            // the warps' shares of P a row
  int last;                           // finish_tile's flag
};

// Bits 0-3 of x (< 16) -> bytes 0-3, each 0 or 1.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}
// ... -> bytes of -1 (bit 0) or +1 (bit 1).
__device__ __forceinline__ uint32_t plus_minus(uint32_t x) {
  return ~(spread(x) * 0xfeu);
}

template <int MI>
__global__ void __launch_bounds__(THREADS)
am_search_packed_unpack_kernel(const uint8_t* __restrict__ q,
                               const uint8_t* __restrict__ am_t,
                               unsigned long long* __restrict__ keys,
                               unsigned* __restrict__ tickets,
                               int32_t* __restrict__ out_idx,
                               float* __restrict__ out_sim, int B, int Dp,
                               int C, int n_dims, bool q_vec, bool a_vec) {
  constexpr int BM = 16 * MI;
  __shared__ __align__(16) Smem<MI> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int n_kw = (n_dims + 31) / 32;  // 32-dim k steps
  const int n_slabs = (n_kw + 7) / 8;

  auto load = [&](int s, int st) {
    const int kb = s * SLAB;
    for (int e = tid; e < BM * 2; e += THREADS) {
      const int r = e >> 1, byte = kb + 16 * (e & 1), b = b0 + r;
      const bool ok = b < B && byte < Dp;
      stage16(sm.q[st] + r * QSTR + 16 * (e & 1),
              ok ? q + (size_t)b * Dp + byte : q, ok, Dp - byte, q_vec);
    }
    for (int e = tid; e < SLAB * (BN / 16); e += THREADS) {
      const int r = e / (BN / 16), ch = e % (BN / 16);
      const int byte = kb + r, c = c0 + 16 * ch;
      const bool ok = byte < Dp && c < C;
      stage16(sm.a[st] + r * ASTR + 16 * ch,
              ok ? am_t + (size_t)byte * C + c : am_t, ok, C - c, a_vec);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load(s, s);
    mma::cp_async_commit();
  }

  int acc[MI][NI][4];
  int pop[MI][2] = {};  // this lane's share of P for rows gid, gid + 8
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int s = 0; s < n_slabs; ++s) {
    mma::cp_async_wait<STAGES - 2>();  // slab s landed (this thread's)
    __syncthreads();  // ... everyone's copies; slab s-1's stage is free
    if (s + STAGES - 1 < n_slabs)
      load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    mma::cp_async_commit();
    const uint8_t* qs = sm.q[s % STAGES] + gid * QSTR + tig;
    const uint8_t* as = sm.a[s % STAGES] + tig * ASTR + warp * 32 + gid;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int kw = s * 8 + kk;
      if (kw >= n_kw) break;
      uint32_t a[MI][4], x[MI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        x[mi][0] = qs[(16 * mi) * QSTR + 4 * kk];
        x[mi][1] = qs[(16 * mi + 8) * QSTR + 4 * kk];
        a[mi][0] = plus_minus(x[mi][0] & 15u);
        a[mi][1] = plus_minus(x[mi][1] & 15u);
        a[mi][2] = plus_minus(x[mi][0] >> 4);
        a[mi][3] = plus_minus(x[mi][1] >> 4);
      }
      uint32_t m = 0xffu;           // the lane's valid dims of its byte
      if (32 * kw + 32 > n_dims) {  // the step n_dims cuts: 0 past it
        const int nv = n_dims - 32 * kw - 8 * tig;
        m = nv >= 8 ? 0xffu : nv <= 0 ? 0u : (1u << nv) - 1u;
        const uint32_t mlo = spread(m & 15u) * 0xffu;
        const uint32_t mhi = spread(m >> 4) * 0xffu;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          a[mi][0] &= mlo;
          a[mi][1] &= mlo;
          a[mi][2] &= mhi;
          a[mi][3] &= mhi;
        }
      }
      if ((kk & 3) == warp) {  // each warp counts P over 2 of 8 steps
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          pop[mi][0] += __popc(x[mi][0] & m);
          pop[mi][1] += __popc(x[mi][1] & m);
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t y = as[4 * kk * ASTR + 8 * ni];
        const uint32_t lo = spread(y & 15u), hi = spread(y >> 4);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma::mma_s8(acc[mi][ni], a[mi], lo, hi);
      }
    }
  }
  mma::cp_async_wait<0>();

  // Fold: lane -> row (four lanes) -> warp -> block -> the query's key.
  // hamming = P - acc, with P the same for every column of a row: the
  // lanes and warps fold (OFS - acc, idx), the block adds P - OFS.
  constexpr int OFS = 1 << 30;  // > any acc (|acc| <= n_dims)
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * mi + 8 * half + gid;
      unsigned long long best = ~0ull;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + warp * 32 + 8 * ni + 2 * tig + j;
          const unsigned long long key =
              (unsigned long long)(OFS - acc[mi][ni][2 * half + j]) << 32 |
              (unsigned)c;
          if (c < C && key < best) best = key;
        }
      }
      int p = pop[mi][half];
      p += __shfl_xor_sync(FULL, p, 1);
      p += __shfl_xor_sync(FULL, p, 2);
      best = min(best, __shfl_xor_sync(FULL, best, 1));
      best = min(best, __shfl_xor_sync(FULL, best, 2));
      if (tig == 0) {
        sm.red[warp][r] = best;
        sm.pop[warp][r] = p;
      }
    }
  }
  __syncthreads();
  if (tid < BM && b0 + tid < B) {
    unsigned long long key = sm.red[0][tid];
    int p = sm.pop[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      key = min(key, sm.red[w][tid]);
      p += sm.pop[w][tid];
    }
    // A block has at least one column < C, so key is a column's.
    atomicMin(&keys[b0 + tid],
              key - ((unsigned long long)(OFS - p) << 32));
  }
  finish_tile(keys, tickets, b0, BM, B, n_dims, out_idx, out_sim,
              &sm.last);
}

template <int MI>
int launch(const uint8_t* q, const uint8_t* am_t, void* scratch, void* idx,
           void* sim, int B, int Dp, int C, int n_dims, int cols,
           int grid_x, int grid_y, int smem, long long scratch_bytes,
           cudaStream_t stream) {
  const int tiles = (B + 16 * MI - 1) / (16 * MI);
  if (cols != BN || grid_x != tiles || grid_y != (C + BN - 1) / BN ||
      smem != (int)sizeof(Smem<MI>) ||
      !scratch_is(scratch, scratch_bytes, B, tiles) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(keys + B);
  const bool q_vec = Dp % 16 == 0 && (uintptr_t)q % 16 == 0;
  const bool a_vec = C % 16 == 0 && (uintptr_t)am_t % 16 == 0;
  am_search_packed_unpack_kernel<MI><<<dim3(grid_x, grid_y), THREADS, 0,
                                       stream>>>(
      q, am_t, keys, tickets, static_cast<int32_t*>(idx),
      static_cast<float*>(sim), B, Dp, C, n_dims, q_vec, a_vec);
  return (int)cudaGetLastError();
}

}  // namespace unpack


}  // namespace

// block_b (4, 8, 16 or 32) is the rows of a query tile, rounded up to
// whole m16 tiles; mode 0 is popcount's tile route, 1 unpack, 2 popcount's
// sweep route. rows, cols, grid_x, grid_y, smem and scratch_bytes are the
// wrapper's launch plan (kernels/am_search_packed.py launch_plan),
// refused (cudaErrorInvalidValue) unless it is this launcher's own for
// (B, Dp, C, block_b, mode) on the current device: tile route,
// max(16, block_b) rows, popcount::block_cols columns and the ring's
// dynamic shared memory; unpack, max(16, block_b) rows, 128 columns and
// the static Smem; sweep (Dp <= 128), 128 rows, 128 columns,
// popcount::sweep_groups column groups and popcount::sweep_smem; all, a
// (query tiles, column splits or groups) grid, 8 B + 4 per query tile of
// scratch and sms the device's SM count. Which route a shape takes is the
// wrapper's rule. Returns the cudaError_t of the launch (0 on success).
extern "C" int am_search_packed_launch(
    const void* q, const void* am_t, void* idx, void* sim, void* scratch,
    int B, int Dp, int C, int n_dims, int block_b, int mode, int rows,
    int cols, int grid_x, int grid_y, int smem, long long scratch_bytes,
    int sms, void* stream) {
  if (B <= 0) return 0;
  if (block_b != 4 && block_b != 8 && block_b != 16 && block_b != 32)
    return (int)cudaErrorInvalidValue;
  int dev = 0, dev_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&dev_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (sms != dev_sms) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* ab = static_cast<const uint8_t*>(am_t);
  if (mode == 1) {
    if (block_b == 32)
      return rows == 32 ? unpack::launch<2>(qb, ab, scratch, idx, sim, B, Dp,
                                            C, n_dims, cols, grid_x, grid_y,
                                            smem, scratch_bytes, s)
                        : (int)cudaErrorInvalidValue;
    return rows == 16 ? unpack::launch<1>(qb, ab, scratch, idx, sim, B, Dp, C,
                                          n_dims, cols, grid_x, grid_y, smem,
                                          scratch_bytes, s)
                      : (int)cudaErrorInvalidValue;
  }
  if (mode == 2)
    return popcount::launch_sweep_ks(qb, ab, scratch, idx, sim, B, Dp, C,
                                     n_dims, rows, cols, grid_x, grid_y, smem,
                                     scratch_bytes, sms, s);
  if (mode != 0) return (int)cudaErrorInvalidValue;
  if (block_b == 32)
    return rows == 32 ? popcount::launch<2>(qb, ab, scratch, idx, sim, B, Dp,
                                            C, n_dims, cols, grid_x, grid_y,
                                            smem, scratch_bytes, sms, s)
                      : (int)cudaErrorInvalidValue;
  return rows == 16 ? popcount::launch<1>(qb, ab, scratch, idx, sim, B, Dp,
                                          C, n_dims, cols, grid_x, grid_y,
                                          smem, scratch_bytes, sms, s)
                    : (int)cudaErrorInvalidValue;
}
