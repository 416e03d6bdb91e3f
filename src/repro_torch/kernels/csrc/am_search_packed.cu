// am_search_packed: associative search over the packed 1-bit AM, with a
// first-wins argmax, in two modes that return the same (idx, sim) bit for
// bit: XOR + popcount, or mode="unpack", the exact integer dot of the
// operands unpacked to ±1 (0 past n_dims) on the int8 tensor cores.
//
//   q     (B, Dp) uint8   packed queries, LSB-first along D, tail bits 0
//   am_t  (Dp, C) uint8   packed transposed AM (column c = centroid c)
//   idx   (B,)    int32   winning centroid
//   sim   (B,)    float32 n_dims - 2 * popcount(q XOR am[:, idx])
//   scratch               unpack mode: (B,) uint64 keys, then one ticket
//                         word per query tile; the launcher fills it with
//                         ones on the stream before the kernel runs
//
// Replaces the TPU kernel src/repro/kernels/am_search_packed.py:
// am_search_packed, both modes (a (B/bB, C/128, Dp/16) Pallas grid doing
// 8-bit SWAR popcounts on the VPU — or, with mode="unpack", unpacking each
// slab to ±1 in VMEM for the MXU — and carrying the running winner across
// C steps in VMEM scratch).
//
// Bound on the H100: operations. At the main path's B = C = D = 1024 the
// operands are 128 KB + 128 KB, and the search is, on ±1/0 operands exact
// in int8, a 2*B*C*D = 2.1 G-op int8 product: 1.1 us at 1,979 TOP/s.
// Counted as 32-bit popcounts instead (B*C*D/32 = 33.6 M __popc at 16 per
// clock per SM) it is about 8 us.
//
// Popcount mode (am_search_packed_kernel):
// * Popcount works on 32-bit words (__popc). Dp is zero-padded to a
//   multiple of 4 bytes in BOTH operands while they are staged into shared
//   memory: zero bytes XOR to zero, so the padding never counts, and
//   D = 100 (Dp = 13) needs no host-side padding pass.
// * A block owns BQ = 4 * QPT queries and walks ALL C columns in tiles of
//   64; nothing carries between blocks, whose order is unknown. Each of
//   the 256 threads owns one column of the tile and QPT queries, so one
//   shared-memory AM word feeds QPT XOR+popc, and the query words are
//   warp-wide broadcasts.
// * Each thread visits its columns in increasing index and keeps its best
//   with a strict '<' on the Hamming distance: first-wins, like the
//   reference's strict '>' running compare. The fold across the 64
//   column-threads of a query compares (hamming, idx) lexicographically,
//   so an equal similarity goes to the lower index.
// * Columns >= C are never visited, so padded columns can never win.
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
//   sim = n_dims - 2 * hamming. (A fold over a thread block cluster
//   through distributed shared memory, with no scratch, ran slower on the
//   H100: its barrier holds every split for the slowest.)
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "packed_topk.cuh"  // packed_word

namespace {

constexpr int TX = 64;  // AM columns per tile (threads across columns)
constexpr int TY = 4;   // thread rows; a block has TX * TY = 256 threads

// Fold each query's TX per-thread winners (hamming, idx)
// lexicographically and write (idx, n_dims - 2 * hamming).
template <int QPT>
__device__ void emit_winners(const int (&best_ham)[QPT],
                             const int (&best_idx)[QPT], int* red_ham,
                             int* red_idx, int b0, int B, int n_dims,
                             int32_t* __restrict__ out_idx,
                             float* __restrict__ out_sim) {
  constexpr int BQ = TY * QPT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    red_ham[(ty + TY * j) * TX + tx] = best_ham[j];
    red_idx[(ty + TY * j) * TX + tx] = best_idx[j];
  }
  __syncthreads();
  if (tid < BQ) {
    const int b = b0 + tid;
    int bh = INT_MAX, bi = INT_MAX;
    for (int t = 0; t < TX; ++t) {
      const int h = red_ham[tid * TX + t], i = red_idx[tid * TX + t];
      if (h < bh || (h == bh && i < bi)) {  // (sim, -idx) lexicographic
        bh = h;
        bi = i;
      }
    }
    if (b < B) {
      out_idx[b] = bi;
      out_sim[b] = (float)(n_dims - 2 * bh);
    }
  }
}

template <int QPT>
__global__ void __launch_bounds__(TX * TY)
am_search_packed_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ am_t,
                        int32_t* __restrict__ out_idx,
                        float* __restrict__ out_sim, int B, int Dp, int C,
                        int n_dims) {
  constexpr int BQ = TY * QPT;
  constexpr int NT = TX * TY;
  extern __shared__ uint32_t smem[];
  const int Dw = (Dp + 3) / 4;
  uint32_t* qs = smem;                       // [BQ][Dw]
  uint32_t* as = qs + BQ * Dw;               // [Dw][TX]
  int* red_ham = (int*)(as + Dw * TX);       // [BQ][TX]
  int* red_idx = red_ham + BQ * TX;          // [BQ][TX]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b0 = blockIdx.x * BQ;

  // Stage this block's queries as zero-padded little-endian words.
  for (int e = tid; e < BQ * Dw; e += NT) {
    const int r = e / Dw, w = e % Dw, b = b0 + r;
    qs[e] = b < B ? packed_topk::packed_word(q + (size_t)b * Dp, 1, w, Dp)
                  : 0u;
  }

  int best_ham[QPT], best_idx[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    best_ham[j] = INT_MAX;
    best_idx[j] = INT_MAX;
  }

  for (int c0 = 0; c0 < C; c0 += TX) {
    __syncthreads();  // the previous tile is consumed; qs is visible
    for (int e = tid; e < Dw * TX; e += NT) {
      const int w = e / TX, cc = e % TX, c = c0 + cc;
      as[e] = c < C ? packed_topk::packed_word(am_t + c, (size_t)C, w, Dp)
                    : 0u;
    }
    __syncthreads();
    const int c = c0 + tx;
    if (c < C) {
      int ham[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) ham[j] = 0;
      for (int w = 0; w < Dw; ++w) {
        const uint32_t a = as[w * TX + tx];
#pragma unroll
        for (int j = 0; j < QPT; ++j)
          ham[j] += __popc(a ^ qs[(ty + TY * j) * Dw + w]);
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        if (ham[j] < best_ham[j]) {  // strict: the first column wins ties
          best_ham[j] = ham[j];
          best_idx[j] = c;
        }
      }
    }
  }

  emit_winners<QPT>(best_ham, best_idx, red_ham, red_idx, b0, B, n_dims,
                    out_idx, out_sim);
}


namespace unpack {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 128;           // columns per block: 4 n8 tiles a warp
constexpr int NI = BN / WARPS / 8;
constexpr int SLAB = 32;          // packed bytes (256 dims) per k slab
constexpr int STAGES = 4;
// Shared row strides, multiples of 16 bytes for cp.async; a warp's byte
// reads then fall in distinct banks (query rows 12 words apart, AM rows
// 36).
constexpr int QSTR = 48;
constexpr int ASTR = BN + 16;
constexpr unsigned FULL = 0xffffffffu;

template <int MI>
struct Smem {
  uint8_t q[STAGES][16 * MI * QSTR];  // query rows x slab bytes
  uint8_t a[STAGES][SLAB * ASTR];     // slab bytes x the block's columns
  unsigned long long red[WARPS][16 * MI];
  int pop[WARPS][16 * MI];            // the warps' shares of P a row
  int last;
};

// Bits 0-3 of x (< 16) -> bytes 0-3, each 0 or 1.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}
// ... -> bytes of -1 (bit 0) or +1 (bit 1).
__device__ __forceinline__ uint32_t plus_minus(uint32_t x) {
  return ~(spread(x) * 0xfeu);
}

// Copy 16 bytes to shared memory, zero where !ok: cp.async when the
// source is 16-byte aligned (vec), else byte by byte. n limits the byte
// copy to the bytes in range.
__device__ __forceinline__ void stage16(uint8_t* dst, const uint8_t* src,
                                        bool ok, int n, bool vec) {
  if (vec) {
    mma::cp_async16_zfill(dst, src, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = ok && i < n ? src[i] : 0;
  }
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
  __threadfence();
  __syncthreads();
  if (tid == 0)  // tickets start at ~0: the first block draws 0
    sm.last = atomicAdd(&tickets[blockIdx.x], 1u) + 1u == gridDim.y - 1u;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  if (tid < BM && b0 + tid < B) {
    const unsigned long long key =
        *reinterpret_cast<volatile unsigned long long*>(&keys[b0 + tid]);
    out_idx[b0 + tid] = (int32_t)(key & 0xffffffffu);
    out_sim[b0 + tid] = (float)(n_dims - 2 * (int)(key >> 32));
  }
}

template <int MI>
int launch(const uint8_t* q, const uint8_t* am_t, void* scratch, void* idx,
           void* sim, int B, int Dp, int C, int n_dims, int cols,
           int grid_x, int grid_y, int smem, long long scratch_bytes,
           cudaStream_t stream) {
  const int tiles = (B + 16 * MI - 1) / (16 * MI);
  const long long want_scratch = 8LL * B + 4LL * tiles;
  if (cols != BN || grid_x != tiles || grid_y != (C + BN - 1) / BN ||
      smem != (int)sizeof(Smem<MI>) || scratch_bytes != want_scratch ||
      scratch == nullptr || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(scratch, 0xff, (size_t)want_scratch, stream);
  if (e != cudaSuccess) return (int)e;
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

template <int QPT>
int launch_popcount(const void* q, const void* am_t, void* idx, void* sim,
                    int B, int Dp, int C, int n_dims, int cols, int grid_x,
                    int grid_y, int smem, long long scratch_bytes,
                    cudaStream_t stream) {
  constexpr int BQ = TY * QPT;
  const long long dw = (Dp + 3) / 4;
  const long long want = 4 * (BQ * dw + dw * TX + 2LL * BQ * TX);
  if (cols != C || grid_x != (B + BQ - 1) / BQ || grid_y != 1 ||
      smem != want || scratch_bytes != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = am_search_packed_kernel<QPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid_x, TX * TY, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(am_t),
      static_cast<int32_t*>(idx), static_cast<float*>(sim), B, Dp, C,
      n_dims);
  return (int)cudaGetLastError();
}

}  // namespace

// block_b (queries per block: 4, 8, 16 or 32) selects the instantiation;
// mode 0 is popcount, 1 unpack. rows, cols, grid_x, grid_y, smem and
// scratch_bytes are the wrapper's launch plan (kernels/am_search_packed.py
// launch_plan), refused (cudaErrorInvalidValue) unless it is this
// launcher's own for (B, Dp, C, block_b, mode): popcount, block_b rows by
// all C columns, ceil(B / block_b) blocks, no scratch; unpack, max(16,
// block_b) rows by 128 columns, a (query tiles, column splits) grid, the
// static Smem and 8 B + 4 per query tile of scratch. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int am_search_packed_launch(
    const void* q, const void* am_t, void* idx, void* sim, void* scratch,
    int B, int Dp, int C, int n_dims, int block_b, int mode, int rows,
    int cols, int grid_x, int grid_y, int smem, long long scratch_bytes,
    void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* ab = static_cast<const uint8_t*>(am_t);
  if (mode == 1) {
    if (block_b != 4 && block_b != 8 && block_b != 16 && block_b != 32)
      return (int)cudaErrorInvalidValue;
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
  if (mode != 0 || rows != block_b) return (int)cudaErrorInvalidValue;
#define POPCOUNT(QPT)                                                       \
  launch_popcount<QPT>(q, am_t, idx, sim, B, Dp, C, n_dims, cols, grid_x,  \
                       grid_y, smem, scratch_bytes, s)
  switch (block_b) {
    case 4: return POPCOUNT(1);
    case 8: return POPCOUNT(2);
    case 16: return POPCOUNT(4);
    case 32: return POPCOUNT(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef POPCOUNT
}
