// am_search_sparse: fine pass of the hierarchical search. Each query
// searches only the 128-column tiles of its S shortlisted clusters in the
// cluster-contiguous slab and keeps the top k columns by
// (-sim, ORIGINAL centroid id).
//
//   q           (B, Dp)   uint8  packed queries, tail bits 0
//   slab        (Dp, Ctot) uint8 permuted packed AM; its last tile is the
//                                all-invalid null tile
//   col_ids     (Ctot,)   int32  original centroid id per slab column, -1
//                                for padding (masked)
//   shortlist   (B, S)    int32  cluster ids (am_shortlist)
//   tile_start, tile_count (G,) int32  each cluster's run of tiles
//   scratch     (B, N)    uint64 key buffer when the N = S*max_tiles*128
//                                keys do not fit in shared memory, else null
//   idx, sim    (B, k)    int32, float32  ids and sims, best first;
//                                exhausted slots (-1, -FLT_MAX)
//   clocks      (B, 3)    int64  optional (null): each block's clock64()
//                                at its start, after scoring, at its end
//
// Replaces the TPU kernel src/repro/kernels/am_search_sparse.py:
// am_search_sparse_gathered (a (B/bB, T, Dp/16) Pallas grid over the
// per-query (B, Dp, T*128) gather made in XLA by expand_shortlist_tiles +
// gather_shortlist, with 8-bit SWAR popcounts and a streaming top-k merged
// per tile by k iterated max-then-min-id selections).
//
// Bound on the H100: bytes. At the huge-label shape (B = 256, S = 8,
// max_tiles = 3, D = 1024) the 1.61 G int ops take 0.81 us at the int8
// tensor-core rate, while the slab tiles the queries touch (up to the whole
// 16-22 MB slab) take ~6.6 us at 3.35 TB/s when read from HBM once.
//
// Design. What held the first version back (0.136 ms at that shape): a
// thread built every 32-bit word of a column from four single-byte loads
// strided by Ctot (128 dependent loads a column at D = 1024), and a
// null-tile slot still cost an id load. Now one block of 256 threads per
// query:
// * Slot p is column p % 128 of slot tile t = p / 128, which is tile
//   t % max_tiles of shortlisted cluster t / max_tiles. A slot tile
//   resolves to one slab tile (the null tile past tile_count, for a
//   shortlist entry outside [0, G) or a tile outside the slab), all S *
//   max_tiles of them at once into shared memory. The reference's
//   gathered operand (100 MB at B = 256, S = 8, max_tiles = 3) never
//   exists. A slot tile that resolves to the null tile (its ids all -1,
//   checked per block) is not read: its keys are INVALID at once.
// * Every other tile streams whole through a 3-stage cp.async ring: one
//   row of a tile, 128 contiguous bytes at d * Ctot + tile * 128, is eight
//   16-byte copies, and a tile of Dp rows is read in chunks of up to 128
//   rows (16 KB); rows past Dp are zero-filled. The tile's 128 ids come
//   into the same stage with its last chunk, so no global load waits at
//   the end of a tile. The 16-byte chunks of row
//   d sit XOR-swizzled by (d / 4) % 8, so the reads below are free of bank
//   conflicts.
// * Scoring: thread (quad, part) owns columns 4 quad .. 4 quad + 3 and the
//   32-bit words part, part + 8, ... of the chunk. Per word it reads the
//   four rows' 4-byte words of its quad, transposes them with __byte_perm
//   into the four columns' words (byte d of a word = row d, as packed_word
//   builds it), and adds __popc(q_word ^ column_word). One 4-byte shared
//   load thus serves 4 columns, where a column word used to cost 4
//   strided global byte loads. Eight parts fold with a 4-shuffle
//   reduce-scatter; the key hamming << 32 | id (INVALID for a masked id)
//   goes to shared memory, or to the global scratch.
// * Then the exact rank selection of packed_topk.cuh (select_topk), as
//   before, with the original id in the key: with S = G every centroid is
//   a candidate once and the k = 1 column equals am_search_packed's
//   first-wins scan. A cluster listed twice returns its columns twice,
//   ties broken by slot.
//
// am_search_sparse_gathered_launch is the same search over pre-gathered
// operands (tiles (B, Dp, TC) uint8, tile_ids (B, TC) int32), as the TPU
// kernel takes them: its slot tile t is columns 128 t .. 128 t + 127 of the
// query's own gather, read in the same ring (no null tile).
#include "mma_sync.cuh"
#include "packed_topk.cuh"

namespace {

constexpr int TILE = 128;
constexpr int STAGES = 3;
constexpr int MAX_CHUNK_ROWS = 128;
constexpr int THREADS = packed_topk::THREADS;
constexpr int WARPS = packed_topk::WARPS;
constexpr unsigned FULL = packed_topk::FULL;
constexpr unsigned long long INVALID = packed_topk::INVALID;

// The tile-row form of a query's candidate slots, shared by both entries:
// slot tile t of query b is 128 columns; row d of them is the 128 bytes at
// rows(b, t, tile) + d * stride, their ids at ids(b, t, tile).
struct SlabTiles {
  const uint8_t* slab;
  const int32_t* col_ids;
  const int32_t* shortlist;
  const int32_t* tile_start;
  const int32_t* tile_count;
  int Ctot, S, G, max_tiles;
  __device__ int null_tile() const { return Ctot / TILE - 1; }
  // The slab tile behind slot tile t (the null tile when there is none).
  __device__ int tile(int b, int t) const {
    const int s = t / max_tiles, j = t % max_tiles;
    const int g = shortlist[(size_t)b * S + s];
    if (g < 0 || g >= G) return null_tile();
    const int count = tile_count[g], cand = tile_start[g] + j;
    return j < count && cand >= 0 && cand <= null_tile() ? cand
                                                          : null_tile();
  }
  __device__ const uint8_t* rows(int, int, int tile) const {
    return slab + (size_t)tile * TILE;
  }
  __device__ size_t stride() const { return (size_t)Ctot; }
  __device__ const int32_t* ids(int, int, int tile) const {
    return col_ids + (size_t)tile * TILE;
  }
};

struct GatheredTiles {
  const uint8_t* tiles;
  const int32_t* tile_ids;
  int Dp, TC;
  __device__ int null_tile() const { return -1; }
  __device__ int tile(int, int t) const { return t; }
  __device__ const uint8_t* rows(int b, int t, int) const {
    return tiles + (size_t)b * Dp * TC + (size_t)t * TILE;
  }
  __device__ size_t stride() const { return (size_t)TC; }
  __device__ const int32_t* ids(int b, int t, int) const {
    return tile_ids + (size_t)b * TC + (size_t)t * TILE;
  }
};

// Shared memory, in this order (the wrapper's launch_plan mirrors it):
// the ring (STAGES x (CR x 128 bytes of tile rows + the tile's 128 ids,
// which come with its last chunk)), the keys when they are kept here
// (N uint64), the query's words zero-padded to whole chunks, the resolved
// slab tile of each slot tile (-1 = skipped), the reduction words.
template <class Tiles>
__global__ void __launch_bounds__(THREADS)
tile_topk_kernel(Tiles tiles, const uint8_t* __restrict__ q, int Dp, int N,
                 int K, int n_dims, int CR, unsigned long long* scratch,
                 int32_t* __restrict__ out_idx, float* __restrict__ out_sim,
                 long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  long long t_start = 0;
  if (clocks != nullptr && tid == 0) t_start = clock64();
  const int T = N / TILE;
  const int CW = CR / 4;                   // words per chunk
  const int n_ch = (Dp + CR - 1) / CR;     // chunks per tile
  uint8_t* ring = tile_smem;
  const int SB = CR * TILE + 4 * TILE;     // a stage: rows, then ids
  unsigned char* p = tile_smem + (size_t)STAGES * SB;
  unsigned long long* keys = scratch != nullptr
      ? scratch + (size_t)b * N : reinterpret_cast<unsigned long long*>(p);
  if (scratch == nullptr) p += (size_t)8 * N;
  uint32_t* qs = reinterpret_cast<uint32_t*>(p);
  int* tl = reinterpret_cast<int*>(qs + n_ch * CW);
  int* red = tl + T;

  // Issued together: the query's words (zero past Dp), each slot tile's
  // slab tile, and whether the null tile holds an id (then it is read).
  const uint8_t* q_row = q + (size_t)b * Dp;
  for (int w = tid; w < n_ch * CW; w += THREADS)
    qs[w] = packed_topk::packed_word(q_row, 1, w, Dp);
  for (int t = tid; t < T; t += THREADS) tl[t] = tiles.tile(b, t);
  const int nt = tiles.null_tile();
  const bool null_live = __syncthreads_or(
      nt >= 0 && tid < TILE && tiles.ids(b, 0, nt)[tid] >= 0);
  if (!null_live)
    for (int t = tid; t < T; t += THREADS)
      if (tl[t] == nt) tl[t] = -1;
  __syncthreads();

  // Work items: (live slot tile, chunk), in order; every thread walks the
  // same sequence.
  auto next_live = [&](int t) {
    while (t < T && tl[t] < 0) ++t;
    return t;
  };
  auto load = [&](int t, int ch, int st) {
    const uint8_t* src = tiles.rows(b, t, tl[t]);
    const size_t stride = tiles.stride();
    uint8_t* dst = ring + (size_t)st * SB;
    if (ch == n_ch - 1 && tid < TILE / 4)  // the ids, with the last chunk
      mma::cp_async16(dst + CR * TILE + 16 * tid,
                      tiles.ids(b, t, tl[t]) + 4 * tid);
#pragma unroll
    for (int i = 0; i < MAX_CHUNK_ROWS * 8 / THREADS; ++i) {
      const int e = tid + THREADS * i;
      if (e >= CR * 8) break;
      const int r = e >> 3, c16 = e & 7, d = ch * CR + r;
      const bool ok = d < Dp;
      mma::cp_async16_zfill(dst + r * TILE + ((c16 ^ ((r >> 2) & 7)) << 4),
                            ok ? src + (size_t)d * stride + 16 * c16 : src,
                            ok);
    }
  };
  int lt = next_live(0), lch = 0;  // the next item to load
  auto advance = [&](int& t, int& ch) {
    if (++ch == n_ch) {
      ch = 0;
      t = next_live(t + 1);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lt < T) {
      load(lt, lch, s);
      advance(lt, lch);
    }
    mma::cp_async_commit();
  }
  for (int s = tid; s < N; s += THREADS)
    if (tl[s / TILE] < 0) keys[s] = INVALID;

  const int quad = tid >> 3, part = tid & 7;
  // After the reduce-scatter below, lane part holds column 2*(part>>2) +
  // ((part>>1)&1) of its quad (both lanes of a pair do).
  const int my_col = 4 * quad + 2 * ((part >> 2) & 1) + ((part >> 1) & 1);
  int ct = next_live(0), cch = 0, item = 0;
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  while (ct < T) {
    mma::cp_async_wait<STAGES - 2>();  // item's copies (this thread's)
    __syncthreads();                   // ... everyone's; a stage is free
    if (lt < T) {
      load(lt, lch, (item + STAGES - 1) % STAGES);
      advance(lt, lch);
    }
    mma::cp_async_commit();
    if (cch == 0) h[0] = h[1] = h[2] = h[3] = 0u;
    const uint8_t* st = ring + (size_t)(item % STAGES) * SB;
    const int wmax = min(CW, (Dp + 3) / 4 - cch * CW);
#pragma unroll
    for (int i = 0; i < MAX_CHUNK_ROWS / 32; ++i) {
      const int w = part + 8 * i;
      if (w >= wmax) break;
      const uint8_t* row =
          st + 4 * w * TILE + (((quad >> 2) ^ (w & 7)) << 4) + 4 * (quad & 3);
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(row);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(row + TILE);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(row + 2 * TILE);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(row + 3 * TILE);
      // 4 x 4 byte transpose: column i's word = byte i of r0..r3.
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const uint32_t qw = qs[cch * CW + w];
      h[0] += __popc(qw ^ __byte_perm(t0, t2, 0x5410));
      h[1] += __popc(qw ^ __byte_perm(t0, t2, 0x7632));
      h[2] += __popc(qw ^ __byte_perm(t1, t3, 0x5410));
      h[3] += __popc(qw ^ __byte_perm(t1, t3, 0x7632));
    }
    if (cch == n_ch - 1) {
      // Reduce-scatter over the quad's 8 parts: 4 shuffles.
      const bool hi = part & 4, mid = part & 2;
      const uint32_t s0 = __shfl_xor_sync(FULL, hi ? h[0] : h[2], 4);
      const uint32_t s1 = __shfl_xor_sync(FULL, hi ? h[1] : h[3], 4);
      const uint32_t k0 = (hi ? h[2] : h[0]) + s0;
      const uint32_t k1 = (hi ? h[3] : h[1]) + s1;
      uint32_t m = (mid ? k1 : k0) + __shfl_xor_sync(FULL, mid ? k0 : k1, 2);
      m += __shfl_xor_sync(FULL, m, 1);
      if ((lane & 1) == 0) {
        const int id = reinterpret_cast<const int*>(st + CR * TILE)[my_col];
        keys[(size_t)ct * TILE + my_col] =
            id >= 0 ? (unsigned long long)m << 32 | (uint32_t)id : INVALID;
      }
    }
    advance(ct, cch);
    ++item;
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // makes the keys, shared or global, visible to the block
  long long t_scored = 0;
  if (clocks != nullptr && tid == 0) t_scored = clock64();
  packed_topk::select_topk(keys, N, K, 8 * Dp, n_dims, red,
                           out_idx + (size_t)b * K, out_sim + (size_t)b * K);
  if (clocks != nullptr) {
    __syncthreads();
    if (tid == 0) {
      clocks[3 * (size_t)b] = t_start;
      clocks[3 * (size_t)b + 1] = t_scored;
      clocks[3 * (size_t)b + 2] = clock64();
    }
  }
}

// The wrapper's launch plan for (B, Dp, N) (kernels/am_search_sparse.py
// launch_plan): grid, ring stages, chunk rows and the dynamic shared
// memory, with the keys in shared memory exactly when no scratch is
// given. Refused (cudaErrorInvalidValue) unless it is this launcher's own.
template <class Tiles>
int launch_tiles(const Tiles& tiles, const void* q, const void* rows_base,
                 const void* ids_base, int B, int Dp, int N, int K,
                 int n_dims, void* scratch, void* idx, void* sim,
                 void* clocks, int grid, int stages, int chunk_rows,
                 int smem, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (N <= 0 || N % TILE || K <= 0 || Dp <= 0)
    return (int)cudaErrorInvalidValue;
  const int cr4 = 4 * ((Dp + 3) / 4);
  const int cr = cr4 < MAX_CHUNK_ROWS ? cr4 : MAX_CHUNK_ROWS;
  const long long n_ch = (Dp + cr - 1) / cr;
  const long long want = (long long)STAGES * (cr + 4) * TILE +
                         (scratch != nullptr ? 0 : 8LL * N) +
                         4 * n_ch * (cr / 4) + 4LL * (N / TILE) + 4 * WARPS;
  if (grid != B || stages != STAGES || chunk_rows != cr || smem != want ||
      (uintptr_t)rows_base % 16 != 0 || (uintptr_t)ids_base % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = tile_topk_kernel<Tiles>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      tiles, static_cast<const uint8_t*>(q), Dp, N, K, n_dims, cr,
      static_cast<unsigned long long*>(scratch), static_cast<int32_t*>(idx),
      static_cast<float*>(sim), static_cast<long long*>(clocks));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int am_search_sparse_launch(
    const void* q, const void* slab, const void* col_ids,
    const void* shortlist, const void* tile_start, const void* tile_count,
    void* scratch, void* idx, void* sim, void* clocks, int B, int Dp,
    int Ctot, int S, int G, int max_tiles, int n_dims, int K, int grid,
    int stages, int chunk_rows, int smem, void* stream) {
  if (Ctot < TILE || Ctot % TILE || S < 1 || max_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * max_tiles * TILE;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const SlabTiles tiles{static_cast<const uint8_t*>(slab),
                        static_cast<const int32_t*>(col_ids),
                        static_cast<const int32_t*>(shortlist),
                        static_cast<const int32_t*>(tile_start),
                        static_cast<const int32_t*>(tile_count),
                        Ctot, S, G, max_tiles};
  return launch_tiles(tiles, q, slab, col_ids, B, Dp, (int)n, K, n_dims,
                      scratch, idx, sim, clocks, grid, stages, chunk_rows, smem,
                      (cudaStream_t)stream);
}

extern "C" int am_search_sparse_gathered_launch(
    const void* q, const void* tiles, const void* tile_ids, void* scratch,
    void* idx, void* sim, int B, int Dp, int TC, int n_dims, int K, int grid,
    int stages, int chunk_rows, int smem, void* stream) {
  if (TC < TILE || TC % TILE) return (int)cudaErrorInvalidValue;
  const GatheredTiles gt{static_cast<const uint8_t*>(tiles),
                         static_cast<const int32_t*>(tile_ids), Dp, TC};
  return launch_tiles(gt, q, tiles, tile_ids, B, Dp, TC, K, n_dims, scratch,
                      idx, sim, nullptr, grid, stages, chunk_rows, smem,
                      (cudaStream_t)stream);
}
