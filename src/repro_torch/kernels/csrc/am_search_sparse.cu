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
// Design: the gather is fused. Slot p of query b is column p % 128 of tile
// j = (p / 128) % max_tiles of shortlisted cluster s = p / (128*max_tiles);
// the block reads that column straight from the slab (tile_start[g] + j,
// or the null tile past tile_count[g]), so the reference's gathered
// operand (100 MB at B = 256, S = 8, max_tiles = 3) never exists. A masked
// column (id -1) costs one id load and no popcount. Then the exact rank
// selection of packed_topk.cuh, with the original id in the key: with
// S = G every centroid is a candidate once and the k = 1 column equals
// am_search_packed's first-wins scan. A shortlist entry outside [0, G) or a
// tile outside the slab reads as the null tile instead of faulting.
//
// am_search_sparse_gathered_launch is the same search over pre-gathered
// operands (tiles (B, Dp, TC) uint8, tile_ids (B, TC) int32), as the TPU
// kernel takes them.
#include "packed_topk.cuh"

namespace {

constexpr int TILE = 128;

struct SlabSlots {
  const uint8_t* slab;
  const int32_t* col_ids;
  const int32_t* shortlist;
  const int32_t* tile_start;
  const int32_t* tile_count;
  int Ctot, S, G, max_tiles;
  __device__ int column(int b, int p, const uint8_t** col,
                        size_t* stride) const {
    const int t = p / TILE;
    const int s = t / max_tiles, j = t % max_tiles;
    const int n_tiles = Ctot / TILE;
    const int g = shortlist[(size_t)b * S + s];
    int tile = n_tiles - 1;  // the null tile
    if (g >= 0 && g < G && j < tile_count[g]) {
      const int cand = tile_start[g] + j;
      if (cand >= 0 && cand < n_tiles) tile = cand;
    }
    const int c = tile * TILE + p % TILE;
    *col = slab + c;
    *stride = (size_t)Ctot;
    return col_ids[c];
  }
};

struct GatheredSlots {
  const uint8_t* tiles;
  const int32_t* tile_ids;
  int Dp, TC;
  __device__ int column(int b, int p, const uint8_t** col,
                        size_t* stride) const {
    *col = tiles + (size_t)b * Dp * TC + p;
    *stride = (size_t)TC;
    return tile_ids[(size_t)b * TC + p];
  }
};

}  // namespace

extern "C" int am_search_sparse_launch(
    const void* q, const void* slab, const void* col_ids,
    const void* shortlist, const void* tile_start, const void* tile_count,
    void* scratch, void* idx, void* sim, int B, int Dp, int Ctot, int S,
    int G, int max_tiles, int n_dims, int K, void* stream) {
  if (Ctot < TILE || Ctot % TILE || S < 1 || max_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * max_tiles * TILE;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const SlabSlots slots{static_cast<const uint8_t*>(slab),
                        static_cast<const int32_t*>(col_ids),
                        static_cast<const int32_t*>(shortlist),
                        static_cast<const int32_t*>(tile_start),
                        static_cast<const int32_t*>(tile_count),
                        Ctot, S, G, max_tiles};
  return packed_topk::launch_topk(slots, q, B, Dp, (int)n, K, n_dims,
                                  scratch, idx, sim, (cudaStream_t)stream);
}

extern "C" int am_search_sparse_gathered_launch(
    const void* q, const void* tiles, const void* tile_ids, void* scratch,
    void* idx, void* sim, int B, int Dp, int TC, int n_dims, int K,
    void* stream) {
  const GatheredSlots slots{static_cast<const uint8_t*>(tiles),
                            static_cast<const int32_t*>(tile_ids), Dp, TC};
  return packed_topk::launch_topk(slots, q, B, Dp, TC, K, n_dims, scratch,
                                  idx, sim, (cudaStream_t)stream);
}
