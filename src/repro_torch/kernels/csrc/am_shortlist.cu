// am_shortlist: coarse pass of the hierarchical search. Each query is
// scored against the G packed super-centroids and the S best clusters are
// kept, ordered by (-sim, cluster id).
//
//   q        (B, Dp) uint8   packed queries, LSB-first along D, tail bits 0
//   super_t  (Dp, G) uint8   packed transposed super-centroids
//   idx      (B, S)  int32   cluster ids, best first, ties to the lower id
//   sim      (B, S)  float32 n_dims - 2 * popcount(q XOR super[:, idx])
//   scratch, tickets         per route, below
//
// Replaces the TPU kernel src/repro/kernels/am_shortlist.py: am_shortlist
// (a (B/bB, G/128, Dp/16) Pallas grid of 8-bit SWAR popcounts whose
// epilogue merges each 128-column block into a per-query top-S scratch by
// S iterated max-then-min-id selections, carried across grid steps).
//
// Bound on the H100: bytes. At the huge-label shape (B = 256, G = 448,
// D = 1024, S = 8) the queries, the super-AM and the outputs are 32 + 57 +
// 16 KB: 0.032 us at 3.35 TB/s, against 2*B*G*D = 0.235 G AND + popcount
// ops, 0.015 us at the 1-bit tensor-core rate. A launch alone takes longer
// than either (chip_smoke.py's launch_floor_ms).
//
// What held the first version back (0.0297 ms at that shape): one block
// of 256 threads per query (256 blocks, each re-reading the whole 57 KB
// super-AM), each thread scoring columns j = tid, tid + 256, ... with
// 32-bit words built from four strided byte loads and __popc on the SMs,
// then ~10 block-wide counting rounds (two barriers each) to select S of
// 448 keys. Now two routes, picked by the wrapper from the shapes before
// the launch (kernels/am_shortlist.py launch_plan, which the launcher
// checks against its own):
//
// Tile route (tile::search), whenever a block's keys fit:
// * A block of 16 warps owns one m16 query tile (16 rows) and a split of
//   `cols` columns (a multiple of 16, at most 512). The scores come from
//   the 1-bit tensor cores, as in popcount mode of am_search_packed.cu,
//   whose staging it shares (b1_slab.cuh): mma.sync.m16n8k256 .b1
//   .and.popc over 32-byte k slabs, hamming = P_q + P_a - 2 popc(q AND
//   a), warp w scoring n8 tiles w, w + 16, ... Up to D = 1024 the four
//   slabs are all copied at once (cp.async) and one wait covers them;
//   a longer D streams through the 4-stage ring.
// * The keys (hamming << 32 | id) of the tile's 16 rows go to shared
//   memory where the ring was (16 x (32 KPL + 1) keys, KPL = the keys a
//   lane holds: 14 at G = 448, 57 KB, past the 48 KB default).
// * Per-warp exact top-S (warp_select): warp w owns row w. Each lane holds
//   its KPL keys in registers; a binary search for the least hamming h*
//   with at least min(S, valid) keys at or below it counts with
//   __reduce_add_sync between the row's least and largest hamming
//   (__reduce_min/max_sync); the candidates (hamming <= h*) are compacted
//   with __ballot_sync into the row's shared storage, and lane l ranks
//   candidates l, l + 32, ... among them (every key ahead of a candidate
//   is a candidate), writing output position rank. No block barrier
//   inside the selection.
// * G split: the grid is (query tiles, splits). With one split the warps
//   write the output. With more (G past 512, or 64-column splits where
//   the grid leaves SMs idle; plan() decides),
//   each block writes its rows' top-min(S, cols) keys to the scratch, and
//   the tile's last block (a ticket word per tile, all ones before and
//   after: the last block restores it, so no memset launch runs) selects
//   the top S of the splits' keys: a key of the global top S is in its
//   split's top S, so the merge is exact.
// The 1-bit products are a small part of a block's time; 16 warps share
// an SM's four schedulers, so the instructions of the copies and of the
// selection set the pace.
//
// Stream route (packed_topk.cuh topk_kernel), where the merge of the
// splits would not fit a warp's 512 keys (S large against G): one block of
// 256 threads per query, __popc scores, the block-wide rank selection, the
// keys in shared memory or, past SMEM_SLOTS, in a (B, G) global scratch.
#include <cfloat>
#include <climits>

#include "b1_slab.cuh"
#include "mma_sync.cuh"
#include "packed_topk.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long INVALID = ~0ull;

struct SuperSlots {
  const uint8_t* super_t;
  int G;
  __device__ int column(int, int p, const uint8_t** col,
                        size_t* stride) const {
    *col = super_t + p;
    *stride = (size_t)G;
    return p;
  }
};

namespace tile {

constexpr int ROWS = 16;        // an m16 query tile
constexpr int WARPS = ROWS;     // a warp per row in the selection
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_KEYS = 512;   // keys of a row a warp selects from
constexpr int TILES_PER_WARP = MAX_KEYS / 8 / WARPS;  // n8 tiles
constexpr int MIN_SPLIT_COLS = 64;
constexpr int SMEM_SLOTS = 16384;  // the stream route's shared key budget

// The launch plan (kernels/am_shortlist.py launch_plan mirrors it).
struct Plan {
  int route;  // 0 tile, 1 stream
  int splits, cols, kpl, grid_x, grid_y, smem;
  long long scratch_bytes;
};

inline int up(int v, int m) { return (v + m - 1) / m * m; }
inline int tile_cols(int G, int splits) {
  return up((G + splits - 1) / splits, 16);
}
// Whether splits of `cols` columns merge within a warp's MAX_KEYS.
inline bool merge_fits(int G, int S, int cols) {
  const int splits = (G + cols - 1) / cols;
  return splits == 1 || splits * (S < cols ? S : cols) <= MAX_KEYS;
}

// The fewest splits, or splits of MIN_SPLIT_COLS columns where that grid
// has at most one block an SM and their merge's keys are fewer than the
// fewest splits' columns: a narrow split's selection (fewer keys a lane)
// pays for the merge only while no SM runs two blocks
// (kernels/am_shortlist.py launch_plan gives the measurements).
inline Plan plan(int B, int Dp, int G, int S, int sms) {
  Plan p{};
  const int tiles = (B + ROWS - 1) / ROWS;
  int cols = tile_cols(G, (G + MAX_KEYS - 1) / MAX_KEYS);
  const int narrow = (G + MIN_SPLIT_COLS - 1) / MIN_SPLIT_COLS;
  if ((long long)tiles * narrow <= sms && MIN_SPLIT_COLS < cols &&
      narrow * (S < MIN_SPLIT_COLS ? S : MIN_SPLIT_COLS) < cols)
    cols = MIN_SPLIT_COLS;
  if (merge_fits(G, S, cols)) {
    p.route = 0;
    p.cols = cols;
    p.splits = (G + cols - 1) / cols;
    const int s_eff = S < cols ? S : cols;
    const int merge = p.splits > 1 ? p.splits * s_eff : 0;
    const int keys = cols > merge ? cols : merge;
    p.kpl = up((keys + 31) / 32, 2);
    p.grid_x = tiles;
    p.grid_y = p.splits;
    const int ring = b1::STAGES * b1::stage_bytes(ROWS, cols);
    const int key_bytes = 8 * ROWS * (32 * p.kpl + 1);
    p.smem = ring > key_bytes ? ring : key_bytes;
    p.scratch_bytes = p.splits > 1 ? 8LL * tiles * ROWS * merge : 0;
    return p;
  }
  const bool fit = G <= SMEM_SLOTS;
  p.route = 1;
  p.splits = 1;
  p.grid_x = B;
  p.grid_y = 1;
  p.smem = (fit ? 8 * G : 0) + 4 * ((Dp + 3) / 4) + 4 * packed_topk::WARPS;
  p.scratch_bytes = fit ? 0 : 8LL * B * G;
  return p;
}

// Output slot r of query b: the key's (id, n_dims - 2 hamming), or
// (-1, float32-min) for an exhausted slot.
__device__ __forceinline__ void write_out(int32_t* __restrict__ out_idx,
                                          float* __restrict__ out_sim,
                                          size_t at, unsigned long long key,
                                          int n_dims) {
  if (key == INVALID) {
    out_idx[at] = -1;
    out_sim[at] = -FLT_MAX;
  } else {
    out_idx[at] = (int32_t)(key & 0xffffffffu);
    out_sim[at] = (float)(n_dims - 2 * (int)(key >> 32));
  }
}

// The warp's exact top K of the keys its lanes hold (INVALID = no key),
// in ascending key order: emit(r, key) for r < K, INVALID where fewer
// than K keys are valid. list: the warp's shared scratch of 32 KPL keys.
// Warp-uniform arguments; no block barrier.
template <int KPL, class Emit>
__device__ __forceinline__ void warp_select(
    const unsigned long long (&key)[KPL], int K, unsigned long long* list,
    Emit emit) {
  const int lane = threadIdx.x & 31;
  int nv = 0;
  unsigned lo = UINT_MAX, hi = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    if (key[i] != INVALID) {
      const unsigned h = (unsigned)(key[i] >> 32);
      ++nv;
      lo = min(lo, h);
      hi = max(hi, h);
    }
  }
  nv = __reduce_add_sync(FULL, nv);
  const int keff = nv < K ? nv : K;
  for (int r = keff + lane; r < K; r += 32) emit(r, INVALID);
  if (keff == 0) return;
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  // The least h* with >= keff keys at or below it. An INVALID key's
  // high word is all ones, past every hamming.
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) cnt += (unsigned)(key[i] >> 32) <= mid;
    if (__reduce_add_sync(FULL, cnt) >= keff) hi = mid;
    else lo = mid + 1;
  }
  // Compact the candidates (hamming <= h*) into list[0, m).
  int m = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const bool cand = (unsigned)(key[i] >> 32) <= lo;
    const unsigned bal = __ballot_sync(FULL, cand);
    if (cand) list[m + __popc(bal & ((1u << lane) - 1u))] = key[i];
    m += __popc(bal);
  }
  __syncwarp();
  // A candidate's rank is the number of candidates below it: every key
  // below a candidate has a hamming <= h*. Keys are unique (ids are).
  // Lane l ranks candidates l, l + 32, ... against the list (broadcast
  // reads): O(m) a lane for m <= 32, whatever KPL.
  for (int j = lane; j < m; j += 32) {
    const unsigned long long kj = list[j];
    int rank = 0;
    for (int i = 0; i < m; ++i) rank += list[i] < kj;
    if (rank < keff) emit(rank, kj);
  }
  __syncwarp();  // list is read by every lane before it is reused
}

template <int KPL>
__global__ void __launch_bounds__(THREADS)
search(const uint8_t* __restrict__ q, const uint8_t* __restrict__ super_t,
       unsigned long long* __restrict__ part, unsigned* __restrict__ tickets,
       int32_t* __restrict__ out_idx, float* __restrict__ out_sim, int B,
       int Dp, int G, int S, int n_dims, int cols, bool q_vec, bool a_vec) {
  constexpr int KSTR = 32 * KPL + 1;  // a row's keys (+1: fewer conflicts)
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b0 = blockIdx.x * ROWS, split = blockIdx.y;
  const int splits = gridDim.y, c0 = split * cols, nt = cols / 8;
  const int as_ld = b1::am_stride(cols);
  const int n_slabs = (Dp + b1::SLAB - 1) / b1::SLAB;
  uint8_t* qring = smem;  // [STAGES][16][QSTR], then [STAGES][SLAB][as_ld]
  uint8_t* aring = smem + b1::STAGES * ROWS * b1::QSTR;

  auto load = [&](int t, int st) {
    b1::load_slab<ROWS>(qring + st * ROWS * b1::QSTR,
                        aring + st * b1::SLAB * as_ld, q, super_t, t, b0, B,
                        Dp, c0, cols, G, q_vec, a_vec, false);
  };
  // D <= 1024 (n_slabs <= STAGES): every slab is in flight at once and one
  // wait covers them all (one L2 round trip, no barrier per slab); a
  // longer D streams through the ring, three slabs ahead.
  const bool resident = n_slabs <= b1::STAGES;
  if (resident) {
    b1::load_resident<ROWS>(qring, aring, q, super_t, n_slabs, b0, B, Dp, c0,
                            cols, G, q_vec, a_vec);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
  } else {
#pragma unroll
    for (int t = 0; t < b1::STAGES - 1; ++t) {
      load(t, t);
      mma::cp_async_commit();
    }
  }

  int acc[TILES_PER_WARP][4];  // popc(q AND a) of the lane's entries
  int pq[2] = {0, 0};          // the lane's share of rows gid, gid + 8
  int pa[TILES_PER_WARP];      // ... of column gid of each n8 tile
#pragma unroll
  for (int i = 0; i < TILES_PER_WARP; ++i) {
    pa[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  }
  for (int t = 0; t < n_slabs; ++t) {
    if (!resident) {
      mma::cp_async_wait<b1::STAGES - 2>();  // slab t landed (this thread's)
      __syncthreads();  // ... everyone's copies; slab t-1's stage is free
      if (t + b1::STAGES - 1 < n_slabs)
        load(t + b1::STAGES - 1, (t + b1::STAGES - 1) % b1::STAGES);
      mma::cp_async_commit();
    }
    const int st = t % b1::STAGES;
    const uint8_t* as = aring + st * b1::SLAB * as_ld + gid;
    uint32_t a[4];
    b1::a_frag(a, qring + st * ROWS * b1::QSTR, lane);
    pq[0] += __popc(a[0]) + __popc(a[2]);
    pq[1] += __popc(a[1]) + __popc(a[3]);
#pragma unroll
    for (int i = 0; i < TILES_PER_WARP; ++i) {
      const int n8 = warp + WARPS * i;
      if (n8 < nt) {
        uint32_t b[2];
        b1::b_frag(b, as + 8 * n8, tig, as_ld);
        pa[i] += __popc(b[0]) + __popc(b[1]);
        mma::mma_b1_and(acc[i], a, b[0], b[1]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the keys replace it

  // Row and column popcounts over their four lanes; column 2 tig + j's
  // total sits in lanes 4 (2 tig + j).
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    pq[0] += __shfl_xor_sync(FULL, pq[0], o);
    pq[1] += __shfl_xor_sync(FULL, pq[1], o);
#pragma unroll
    for (int i = 0; i < TILES_PER_WARP; ++i)
      pa[i] += __shfl_xor_sync(FULL, pa[i], o);
  }
  auto* keys = reinterpret_cast<unsigned long long*>(smem);  // [16][KSTR]
#pragma unroll
  for (int i = 0; i < TILES_PER_WARP; ++i) {
    int pc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      pc[j] = __shfl_sync(FULL, pa[i], 4 * (2 * tig + j));
    const int n8 = warp + WARPS * i;
    if (n8 < nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pos = 8 * n8 + 2 * tig + j, c = c0 + pos;
          const int ham = pq[half] + pc[j] - 2 * acc[i][2 * half + j];
          keys[(8 * half + gid) * KSTR + pos] =
              c < G ? (unsigned long long)ham << 32 | (unsigned)c : INVALID;
        }
    }
  }
  __syncthreads();

  // Warp w selects row w; its key row is then its selection scratch.
  const int b = b0 + warp;
  unsigned long long* row = keys + warp * KSTR;
  unsigned long long k[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int pos = lane + 32 * i;
    k[i] = pos < cols ? row[pos] : INVALID;
  }
  __syncwarp();
  auto out = [&](int r, unsigned long long key) {
    write_out(out_idx, out_sim, (size_t)b * S + r, key, n_dims);
  };
  if (splits == 1) {
    if (b < B) warp_select<KPL>(k, S, row, out);
    return;
  }
  const int s_eff = S < cols ? S : cols;
  const int n = splits * s_eff;  // the merge's keys of a row
  unsigned long long* mine = part + (size_t)b * n + split * s_eff;
  if (b < B)
    warp_select<KPL>(k, s_eff, row, [&](int r, unsigned long long key) {
      mine[r] = key;
    });
  // The tile's last block to finish (tickets start at ~0: the first draws
  // 0) merges the splits and puts the ticket back to ~0.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[blockIdx.x], 1u) + 1u == (unsigned)splits - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (b < B) {
    const unsigned long long* all = part + (size_t)b * n;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int pos = lane + 32 * i;
      k[i] = pos < n ? __ldcg(all + pos) : INVALID;
    }
    warp_select<KPL>(k, S, row, out);
  }
  if (tid == 0) tickets[blockIdx.x] = ~0u;
}

template <int KPL>
int launch(const uint8_t* q, const uint8_t* super_t, void* scratch,
           void* tickets, void* idx, void* sim, int B, int Dp, int G, int S,
           int n_dims, const Plan& p, cudaStream_t stream) {
  auto kernel = search<KPL>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool q_vec = Dp % 16 == 0 && (uintptr_t)q % 16 == 0;
  const bool a_vec = G % 16 == 0 && (uintptr_t)super_t % 16 == 0;
  kernel<<<dim3(p.grid_x, p.grid_y), THREADS, p.smem, stream>>>(
      q, super_t, static_cast<unsigned long long*>(scratch),
      static_cast<unsigned*>(tickets), static_cast<int32_t*>(idx),
      static_cast<float*>(sim), B, Dp, G, S, n_dims, p.cols, q_vec, a_vec);
  return (int)cudaGetLastError();
}

}  // namespace tile

}  // namespace

// route .. scratch_bytes and sms are the wrapper's launch plan
// (kernels/am_shortlist.py launch_plan) for (B, Dp, G, S) on a device of
// sms SMs (the device's own, or another count whose grid a measurement
// times: every plan gives the same result), refused
// (cudaErrorInvalidValue) unless it is this launcher's own. scratch: the
// tile route's (B rounded up to 16, splits * min(S, cols)) merge keys, or
// the stream route's (B, G) keys, per the plan (else null); tickets: a
// word per query tile, all ones, when the tile route splits G (else
// null). Returns the cudaError_t of the launch (0 on success).
extern "C" int am_shortlist_launch(
    const void* q, const void* super_t, void* scratch, void* tickets,
    void* idx, void* sim, int B, int Dp, int G, int n_dims, int S, int route,
    int splits, int cols, int kpl, int grid_x, int grid_y, int smem,
    long long scratch_bytes, int sms, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > G || Dp <= 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const tile::Plan p = tile::plan(B, Dp, G, S, sms);
  if (route != p.route || splits != p.splits || cols != p.cols ||
      kpl != p.kpl || grid_x != p.grid_x || grid_y != p.grid_y ||
      smem != p.smem || scratch_bytes != p.scratch_bytes ||
      grid_y > 65535 || (scratch_bytes > 0) != (scratch != nullptr) ||
      (route == 0 && (splits > 1) != (tickets != nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const uint8_t*>(super_t);
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const SuperSlots slots{sb, G};
    return packed_topk::launch_topk(slots, q, B, Dp, G, S, n_dims, scratch,
                                    idx, sim, s);
  }
#define TILE_SEARCH(K)                                                  \
  case K:                                                               \
    return tile::launch<K>(qb, sb, scratch, tickets, idx, sim, B, Dp, G, \
                           S, n_dims, p, s)
  switch (kpl) {
    TILE_SEARCH(2);
    TILE_SEARCH(4);
    TILE_SEARCH(6);
    TILE_SEARCH(8);
    TILE_SEARCH(10);
    TILE_SEARCH(12);
    TILE_SEARCH(14);
    TILE_SEARCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TILE_SEARCH
}
