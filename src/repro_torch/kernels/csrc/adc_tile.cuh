// adc_tile.cuh: the per-array ADC and the tiled analog search shared by
// am_search_imc.cu and am_search_multibit.cu (and, with one slab of D and
// no ADC, by am_search.cu through search_pass.cuh): the slab close, the
// int8 tensor-core slab walk, the SIMT slab walk of the multi-bit fp32
// route, the convert pass, the launch plan and the first-wins fold.
//
// The AM is cut into (tile_rows x tile_cols) physical arrays. For every
// (query, column) the K walk closes each tile_rows slab before it moves
// on: the slab's partial sum is finished, the array's readout offset
// offsets[g, col / tile_cols] is added, the result goes through the ADC,
// and only the quantized value is added to the running similarity, slab
// after slab in order g = 0, 1, ... — the order of ref.imc_sims.
//
// The ADC is ref.adc_quantize / jnp.round(jnp.clip(x, -clip, clip) / step)
// * step bit for bit: clip by min/max, a true IEEE division by step
// (__fdiv_rn: step = 2 * clip / 2^bits need not be a power of two; when
// it is one, as with every power-of-two clip, the product by the exact
// 1/step, which rounds the same real number the same way), rintf (round
// half to even, as jnp.round and torch.round; roundf would round half
// away from zero), and the product and the accumulation kept apart
// (__fmul_rn, __fadd_rn), so the compiler cannot fuse them into an FMA.
// Build without --use_fast_math.
//
// A search block of 256 threads owns a BM x BN tile (BM = 128 or 64
// queries, BN = 64 columns). Each thread keeps its outputs' running
// similarities in registers through the slab closes and writes them to a
// shared-memory sum tile, which the fold reads. The two searches run two
// launches on one stream:
// * the convert pass (convert_pass): 64 x 64 tiles of q (and, for
//   am_search_imc, of the AM view) become int8 copies, each with a flag
//   word (int8_convert.cuh); it also resets the rows' keys and the row
//   tiles' tickets of the fold;
// * the search pass: every block reads all flags and takes the int8 route
//   when every operand value is an integer in [-127, 127] and every slab
//   partial sum is exact (|q| * |am| * min(tile_rows, D) <= 2^24), else
//   its fp32 route. All blocks see the same flags, so a call takes one
//   route; block (0, 0) counts it in routes[] (0: int8, 1: fp32).
//
// The int8 route (Int8Walk). The int8 rows stream through a ring of
// NST8 stages of KB = 128-byte k slabs, 16-byte chunks XOR-swizzled by
// row, read by ldmatrix into mma.sync.m16n8k32 fragments (s8 x s8, or
// s8 x u8 codes for am_search_multibit); 8 warps of 32 x 32. A slab
// boundary may fall inside a 32-dim k step (tile_rows need not be a
// multiple of 32, nor D): the step then runs once per segment of it that
// lies in one slab, with the query fragment's bytes outside the segment
// masked to 0, and the slab closes between the segments. The s32 partial
// is exact; with U8 codes the partial is sum q*u - Qmax * sum q (the lane
// sums its query bytes with __dp4a over the same masked fragments).
// Converted to float it is the same exact integer the plain version's
// sequential float32 sum gives, so the offset, the ADC and the
// slab-ordered sum make the result bit-equal. Without offsets and with a
// power-of-two step (every power-of-two clip) the close stays in integers
// (adc_count: the ADC's round half to even of clamp(p) / step as an
// integer count of steps, summed; the sum times step at the end): the
// float version's every partial sum is a multiple of step below 2^24
// steps, so exact, and the two agree bit for bit. When the flags also
// show that no partial can reach the clip and step <= 1 (the ideal 16-bit
// ADC of 128-row arrays over ±1 operands, or the default multi-bit ADC),
// the ADC is the identity on every partial: the walk then closes no slab
// and the similarity is the exact integer dot product.
//
// The fold. Each row's best (sim, idx) of the tile, first wins, is folded
// into a 64-bit key per query with atomicMin: the high word an
// order-reversing map of the float sim, the low word idx, so the least
// key is the largest sim and, among equal sims, the lowest column, in any
// block order. The last column block of a row tile to finish (a ticket
// per row tile) writes (idx, sim).
#pragma once

#include <climits>

#include "int8_convert.cuh"
#include "mma_sync.cuh"
#include "sims_argmax.cuh"

namespace adc {

constexpr int BN = 64;            // columns of a search block
constexpr int THREADS = 256;      // threads of a search block
constexpr int SUM_LD = BN + 1;    // row stride (floats) of the sum tile
constexpr int KB = 128;           // int8 bytes of k per ring stage
constexpr int NST8 = 4;           // stages of the int8 ring
constexpr long long EXACT = 1LL << 24;  // float32 integers are exact below

// inv: 1 / step when step is a power of two (then x * inv == x / step
// exactly, and |x / step| <= 2^(bits - 1) <= 2^22, where adding and
// taking away 1.5 * 2^23 rounds half to even as rintf does, at the full
// float rate; only the sign of a zero can differ, which no sum that
// starts at +0 sees), else 0 (a true division and rintf).
__device__ __forceinline__ float quantize(float x, float clip, float step,
                                          float inv) {
  constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
  x = fminf(fmaxf(x, -clip), clip);
  const float r = inv != 0.f
                      ? __fadd_rn(__fadd_rn(__fmul_rn(x, inv), MAGIC), -MAGIC)
                      : rintf(__fdiv_rn(x, step));
  return __fmul_rn(r, step);
}

// The ADC of an integer partial p as a count of steps, when step = 2^e
// (|e| <= 30) and clip = clipq * step: round half to even of
// clamp(p, -clip, clip) / step, in integers (clamping before or after the
// rounding agree, clipq being an integer).
__device__ __forceinline__ int adc_count(int p, int e, int clipq) {
  long long v;
  if (e <= 0) {
    v = (long long)p << -e;
  } else {
    const int fl = p >> e, rem = p - (fl << e), half = 1 << (e - 1);
    v = fl + (rem > half || (rem == half && (fl & 1)));
  }
  return (int)max(min(v, (long long)clipq), -(long long)clipq);
}

// How the launchers hand the ADC to the kernels: inv for quantize, and
// the integer close (adc_count) when it is exact — no offsets, step = 2^e,
// clip an integer number clipq of steps, and clipq * gd <= 2^24, so every
// slab-ordered float sum of ADC outputs is an exact multiple of step.
struct Adc {
  float clip, step, inv;
  int int_close, e, clipq;
  Adc(float clip_, float step_, const void* offsets, int gd)
      : clip(clip_), step(step_), inv(0.f), int_close(0), e(0), clipq(0) {
    int ex;
    if (frexpf(step, &ex) != 0.5f || clip / step > 4194304.f) return;
    inv = ldexpf(1.f, 1 - ex);
    const float cq = clip / step;
    if (offsets != nullptr || ex - 1 < -30 || ex - 1 > 30 ||
        cq != floorf(cq) || (double)cq * gd > (double)EXACT)
      return;
    int_close = 1, e = ex - 1, clipq = (int)cq;
  }
};

// The end (a global dim) of slab g, or INT_MAX past the last slab.
__device__ __forceinline__ int slab_end(int g, int gd, int tile_rows,
                                        int D) {
  return g < gd ? min((g + 1) * tile_rows, D) : INT_MAX;
}

// The readout offset of slab g at global column c (0 past C or without
// offsets).
__device__ __forceinline__ float offset_of(const float* __restrict__ offsets,
                                           int g, int gc, int c, int C,
                                           int tile_cols) {
  return offsets != nullptr && c < C ? offsets[(size_t)g * gc + c / tile_cols]
                                     : 0.0f;
}

// What a slab close needs besides the partials.
struct Readout {
  const float* __restrict__ offsets; // (gd, gc) or null
  const int* colg;  // shared: array column of each tile column, -1 past C
  int gd, gc, tile_rows, D, qmax;
  Adc adc;

  // The offset of slab g at tile column col.
  __device__ __forceinline__ float offset(int g, int col) const {
    if (offsets == nullptr) return 0.f;
    const int a = colg[col];
    return a >= 0 ? offsets[(size_t)g * gc + a] : 0.f;
  }
  // run += ADC(part + off), float32.
  __device__ __forceinline__ float add(float run, float part,
                                       float off) const {
    return __fadd_rn(run, quantize(__fadd_rn(part, off), adc.clip, adc.step,
                                   adc.inv));
  }
};

// colg for the tile at col0 (every thread of the block; the caller
// synchronizes before use).
__device__ __forceinline__ void tile_columns(int* colg, int col0, int C,
                                             int tile_cols) {
  for (int i = threadIdx.x; i < BN; i += blockDim.x)
    colg[i] = col0 + i < C ? (col0 + i) / tile_cols : -1;
}

// -- the launch plan ------------------------------------------------------

__host__ __device__ inline long long align256(long long v) {
  return (v + 255) / 256 * 256;
}

// The grid, the slab walk and the scratch of a search; the wrappers
// (kernels/am_search_imc.py, am_search_multibit.py and am_search.py:
// launch_plan)
// compute the same numbers and the launchers refuse any other. bm: the
// block's queries; am_copy: the AM view is converted too (am_search_imc);
// step: dims per k step of the fp32 route.
struct Plan {
  int n_ct, n_rt, kp, bp, cp, gd, n_stages, n_steps, n_am_tiles, n_conv;
  long long q8, am8, flags, keys, tickets, bytes;
  Plan(int B, int D, int C, int tile_rows, int bm, bool am_copy, int step) {
    n_ct = (C + BN - 1) / BN;
    n_rt = (B + bm - 1) / bm;
    kp = (D + KB - 1) / KB * KB;  // dims of the int8 copies
    bp = n_rt * bm;
    cp = n_ct * BN;
    gd = (D + tile_rows - 1) / tile_rows;
    n_stages = kp / KB;
    n_steps = (D + step - 1) / step;
    const int kt = kp / conv::TILE;
    n_am_tiles = am_copy ? kt * (cp / conv::TILE) : 0;
    n_conv = n_am_tiles + kt * (bp / conv::TILE);
    q8 = 0;
    am8 = q8 + align256((long long)bp * kp);
    flags = am8 + align256(am_copy ? (long long)cp * kp : 0);
    keys = flags + align256(4LL * n_conv);
    tickets = keys + align256(8LL * B);
    bytes = tickets + align256(4LL * n_rt);
  }
  // The launch the wrapper asked for is this plan's.
  bool is(int grid_x, int grid_y, int slabs, int k_stages, int k_steps,
          int conv_grid, long long scratch_bytes) const {
    return grid_x == n_ct && grid_y == n_rt && slabs == gd &&
           k_stages == n_stages && k_steps == n_steps &&
           conv_grid == n_conv && scratch_bytes == bytes && n_rt <= 65535;
  }
};

// -- the convert pass ------------------------------------------------------

namespace {
// Blocks [0, n_am_tiles): tiles of the AM view (element strides sd, sc)
// into am8 (cp, kp); the rest: tiles of q into q8 (bp, kp). Also keys[b] =
// ~0 and tickets[rt] = 0 for the search pass's fold.
__global__ void __launch_bounds__(conv::THREADS)
convert_pass(const float* __restrict__ q, const float* __restrict__ am_t,
             long long sd, long long sc, int B, int D, int C, int bp,
             int cp, int kp, int n_am_tiles, int n_rt,
             int8_t* __restrict__ q8, int8_t* __restrict__ am8,
             unsigned* __restrict__ flags,
             unsigned long long* __restrict__ keys,
             unsigned* __restrict__ tickets) {
  __shared__ float t[conv::TILE][conv::TILE + 1];
  __shared__ int s_max;
  const int tid = threadIdx.x, kt = kp / conv::TILE;
  for (int i = blockIdx.x * conv::THREADS + tid; i < B + n_rt;
       i += gridDim.x * conv::THREADS) {
    if (i < B)
      keys[i] = ~0ull;
    else
      tickets[i - B] = 0u;
  }
  int blk = blockIdx.x;
  const float* src;
  long long sk, sr;
  int rows, rows_pad;
  int8_t* dst;
  if (blk < n_am_tiles) {
    src = am_t, sk = sd, sr = sc, rows = C, rows_pad = cp, dst = am8;
  } else {
    blk -= n_am_tiles;
    src = q, sk = 1, sr = D, rows = B, rows_pad = bp, dst = q8;
  }
  const int r0 = (blk / kt) * conv::TILE, k0 = (blk % kt) * conv::TILE;
  const unsigned flag = conv::tile(src, sk, sr, rows, rows_pad, D, kp, r0,
                                   k0, dst, t, &s_max);
  if (tid == 0) flags[blockIdx.x] = flag;
}
}  // namespace

// The route of the call, from every convert tile's flag (all threads of
// the block read them; ends on a barrier): the int8 route when no tile is
// INEXACT and max|q| * am_max * min(tile_rows, D) <= 2^24, where am_max
// is the largest |am| over the AM tiles (the first n_am_tiles flags) or,
// without them, the given bound on the codes; on it, the ADC is the
// identity when it closes in integers at a step <= 1 and that bound
// (every |partial|) is within the clip, and the whole-D dot stays exact.
struct Route {
  bool int8, identity;
};
__device__ __forceinline__ Route pick_route(const unsigned* __restrict__ flags,
                                            int n_conv, int n_am_tiles,
                                            long long am_bound, int tile_rows,
                                            int D, const Adc& adc,
                                            int* s_max) {
  const int tid = threadIdx.x;
  if (tid < 2) s_max[tid] = 0;
  __syncthreads();
  bool inexact = false;
  int mq = 0, ma = 0;
  // 16 bytes a load (the flags start 256-byte aligned, and the scratch
  // holds whole 16-byte words of them).
  for (int i = tid; 4 * i < n_conv; i += blockDim.x) {
    const uint4 f4 = __ldcg(reinterpret_cast<const uint4*>(flags) + i);
    const unsigned fs[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * i + j;
      if (k >= n_conv) break;
      if (fs[j] & conv::INEXACT)
        inexact = true;
      else if (k < n_am_tiles)
        ma = max(ma, (int)fs[j]);
      else
        mq = max(mq, (int)fs[j]);
    }
  }
  atomicMax(&s_max[0], mq);
  atomicMax(&s_max[1], ma);
  inexact = __syncthreads_or(inexact);
  const long long am_max = n_am_tiles > 0 ? s_max[1] : am_bound;
  const long long unit = (long long)s_max[0] * am_max;
  const long long bound = unit * min(tile_rows, D);
  const bool int8 = !inexact && bound <= EXACT;
  return {int8, int8 && adc.int_close && adc.e <= 0 &&
                    (bound << -adc.e) <= adc.clipq && unit * D <= EXACT};
}

// -- the int8 route ---------------------------------------------------------

// Warps: WM along the block's BM rows x WN along its columns; each warp
// owns MI m16 tiles x NI n8 tiles. U8: the AM operand is u8 offset codes,
// and the partial is sum q*u - qmax * sum q.
template <int WM_, int WN_, bool U8_, int BM_>
struct Int8 {
  static constexpr int WM = WM_, WN = WN_, BM = BM_;
  static constexpr int MI = BM / 16 / WM, NI = BN / 8 / WN;
  static constexpr bool U8 = U8_;
  static_assert(32 * WM * WN == THREADS, "a block's warps");
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "warp tiling");
};

// Stage rows: 128-byte rows, chunk c of row r at chunk c ^ (r & 7).
__device__ __forceinline__ int swz(int r, int c) {
  return r * KB + 16 * (c ^ (r & 7));
}

// Bytes kb .. kb + 3 of a fragment register inside the segment [lo, hi).
__device__ __forceinline__ uint32_t lead(int n) {
  return n <= 0 ? 0u : n >= 4 ? ~0u : (1u << (8 * n)) - 1u;
}
__device__ __forceinline__ uint32_t seg_mask(int kb, int lo, int hi) {
  return lead(hi - kb) & ~lead(lo - kb);
}

template <class W>
struct Int8Walk {
  int acc[W::MI][W::NI][4];
  int rs[W::MI][2];  // U8: the lane's share of rows gid, gid + 8's sum q
  // The running similarities: the exact dot (identity), counts of steps
  // (ro.adc.int_close) or the float32 bits of the sums.
  int run[W::MI][W::NI][4];
  int g, end;        // the open slab and its end (a global dim)
  bool identity;     // the ADC is the identity: no slab closes
  Readout ro;

  __device__ Int8Walk(const Readout& r, bool ident) : identity(ident), ro(r) {
    zero();
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0;  // 0 and +0.f
    g = 0;
    end = identity ? INT_MAX : slab_end(0, ro.gd, ro.tile_rows, ro.D);
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi) {
      rs[mi][0] = rs[mi][1] = 0;
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }

  __device__ __forceinline__ void product(const uint32_t (&a)[W::MI][4],
                                          const uint32_t (&b)[W::NI][2]) {
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni) {
        if constexpr (W::U8)
          mma::mma_s8u8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        else
          mma::mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
      if constexpr (W::U8) {
        rs[mi][0] = __dp4a((int)a[mi][0], 0x01010101, rs[mi][0]);
        rs[mi][0] = __dp4a((int)a[mi][2], 0x01010101, rs[mi][0]);
        rs[mi][1] = __dp4a((int)a[mi][1], 0x01010101, rs[mi][1]);
        rs[mi][1] = __dp4a((int)a[mi][3], 0x01010101, rs[mi][1]);
      }
    }
  }

  // The open slab's partials through the ADC into the running sums (with
  // identity: once, after the walk, the whole dot); the next slab opens.
  __device__ __forceinline__ void close() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tig = lane & 3;
    const int c0 = (warp % W::WN) * 8 * W::NI;
    int qs[W::MI][2];
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = rs[mi][h];
        if constexpr (W::U8) {
          v += __shfl_xor_sync(~0u, v, 1);
          v += __shfl_xor_sync(~0u, v, 2);
        }
        qs[mi][h] = v;
      }
    if (identity || ro.adc.int_close) {
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int p = acc[mi][ni][e];
            if constexpr (W::U8) p -= ro.qmax * qs[mi][e >> 1];
            run[mi][ni][e] +=
                identity ? p : adc_count(p, ro.adc.e, ro.adc.clipq);
          }
    } else {
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float off = ro.offset(g, c0 + 8 * ni + 2 * tig + j);
#pragma unroll
          for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int p = acc[mi][ni][2 * h + j];
              if constexpr (W::U8) p -= ro.qmax * qs[mi][h];
              int& r = run[mi][ni][2 * h + j];
              r = __float_as_int(ro.add(__int_as_float(r), (float)p, off));
            }
        }
      }
    }
    zero();
    ++g;
    end = slab_end(g, ro.gd, ro.tile_rows, ro.D);
  }

  // The running similarities into the sum tile.
  __device__ __forceinline__ void finish(float* sum) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int r0 = (warp / W::WN) * 16 * W::MI, c0 = (warp % W::WN) * 8 * W::NI;
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = run[mi][ni][e];
          sum[(r0 + 16 * mi + 8 * (e >> 1) + gid) * SUM_LD + c0 + 8 * ni +
              2 * tig + (e & 1)] =
              identity           ? (float)r
              : ro.adc.int_close ? __fmul_rn((float)r, ro.adc.step)
                                 : __int_as_float(r);
        }
  }

  // One 32-dim k step (global dims k .. k + 31) of the stage rows sa (the
  // block's BM queries) and sb (its BN columns); ks: the step's place in
  // the stage.
  __device__ __forceinline__ void step(const int8_t* sa, const int8_t* sb,
                                       int ks, int k) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = (warp / W::WN) * 16 * W::MI, c0 = (warp % W::WN) * 8 * W::NI;
    uint32_t a[W::MI][4], b[W::NI][2];
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi) {
      const int r = r0 + 16 * mi + ((lane >> 3) & 1) * 8 + (lane & 7);
      mma::ldmatrix_x4(a[mi], sa + swz(r, 2 * ks + (lane >> 4)));
    }
#pragma unroll
    for (int p = 0; p < W::NI / 2; ++p) {
      uint32_t t[4];
      const int r = c0 + 16 * p + (lane >> 4) * 8 + (lane & 7);
      mma::ldmatrix_x4(t, sb + swz(r, 2 * ks + ((lane >> 3) & 1)));
      b[2 * p][0] = t[0], b[2 * p][1] = t[1];
      b[2 * p + 1][0] = t[2], b[2 * p + 1][1] = t[3];
    }
    if (end >= k + 32) {  // warp-uniform: every thread walks the same k
      product(a, b);
      if (end == k + 32) close();
      return;
    }
    const int tig = lane & 3;
    for (int lo = 0; lo < 32;) {
      const int hi = min(32, end - k);
      const uint32_t m0 = seg_mask(4 * tig, lo, hi);
      const uint32_t m1 = seg_mask(16 + 4 * tig, lo, hi);
      uint32_t am[W::MI][4];
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi) {
        am[mi][0] = a[mi][0] & m0;
        am[mi][1] = a[mi][1] & m0;
        am[mi][2] = a[mi][2] & m1;
        am[mi][3] = a[mi][3] & m1;
      }
      product(am, b);
      lo = hi;
      if (k + hi == end) close();
    }
  }
};

// The int8 slab walk over n_stages ring stages. load(s) issues the copies
// of stage s into ring slot s % NST8 (the caller issued stages 0 .. NST8 -
// 2, one commit group each); ready(t, sa, sb) gives stage t's query and
// column rows once its copies landed (after a barrier).
template <class W, class Load, class Ready>
__device__ __forceinline__ void int8_walk(Int8Walk<W>& wk, int n_stages,
                                          Load&& load, Ready&& ready) {
  for (int t = 0; t < n_stages; ++t) {
    mma::cp_async_wait<NST8 - 2>();
    __syncthreads();  // stage t landed; stage t - 1's slot is free
    if (t + NST8 - 1 < n_stages) load(t + NST8 - 1);
    mma::cp_async_commit();
    const int8_t *sa, *sb;
    ready(t, sa, sb);
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) wk.step(sa, sb, ks, t * KB + 32 * ks);
  }
  mma::cp_async_wait<0>();
}

// -- the SIMT slab walk (am_search_multibit's fp32 route) -----------------

// acc = the ADC-quantized similarity of the (16*TM) x BN tile at
// (row0, col0): sum over row tiles g of ADC(q[:, slab g] . am[slab g, :]
// + offsets[g, col / tile_cols]), each slab summed with one fmaf per dim,
// ascending (sims::accumulate). offsets is a (gd, gc) row-major grid, or
// null for drift-free readout.
template <int TM, class Am>
__device__ void imc_tile(const float* __restrict__ q, int B, int D, int C,
                         int row0, int col0, int tile_rows, int tile_cols,
                         const float* __restrict__ offsets, int gc,
                         float clip, float step, const Am& am,
                         float (*qs)[16 * TM + 1],
                         float (*as)[sims::BN + 1],
                         float (&acc)[TM][sims::TN]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < sims::TN; ++j) acc[i][j] = 0.0f;
  int g = 0;
  for (int s0 = 0; s0 < D; s0 += tile_rows, ++g) {
    float part[TM][sims::TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < sims::TN; ++j) part[i][j] = 0.0f;
    const int s1 = min(s0 + tile_rows, D);
    sims::accumulate<TM>(q, B, D, C, row0, col0, s0, s1, am, qs, as, part);
#pragma unroll
    for (int j = 0; j < sims::TN; ++j) {
      const int c = col0 + tx + 16 * j;
      const float off = offset_of(offsets, g, gc, c, C, tile_cols);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        acc[i][j] = __fadd_rn(acc[i][j], quantize(__fadd_rn(part[i][j], off),
                                                  clip, step, 0.f));
    }
  }
}

// -- the fold ---------------------------------------------------------------

// The least key is the larger sim, then the lower idx (sims are never -0:
// a sum that starts at +0 cannot become -0).
__device__ __forceinline__ unsigned long long sim_key(float s, int idx) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending with s
  return (unsigned long long)(~u) << 32 | (unsigned)idx;
}
__device__ __forceinline__ float key_sim(unsigned long long key) {
  const unsigned u = ~(unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Fold the sum tile (BM rows from row0, columns col0 ..) into the rows'
// keys and, in the row tile's last column block, write (idx, sim).
// THREADS / BM neighbouring threads share a row, each over a contiguous run
// of columns in increasing order. Starts with a barrier (the sum tile is
// complete).
template <int BM>
__device__ __forceinline__ void fold_keys(
    const float* sum, int row0, int col0, int B, int C,
    unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
    int32_t* __restrict__ out_idx, float* __restrict__ out_sim) {
  constexpr int TPR = THREADS / BM, RUN = BN / TPR;
  static_assert(TPR >= 1 && TPR <= 32 && BN % TPR == 0, "fold threads");
  __shared__ int s_last;
  const int tid = threadIdx.x, r = tid / TPR, part = tid % TPR;
  __syncthreads();
  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int j = 0; j < RUN; ++j) {
    const int cl = part * RUN + j, c = col0 + cl;
    if (c < C) {
      const float v = sum[r * SUM_LD + cl];
      if (sims::better(v, c, bs, bi)) bs = v, bi = c;
    }
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    const float os = __shfl_xor_sync(~0u, bs, o);
    const int oi = __shfl_xor_sync(~0u, bi, o);
    if (sims::better(os, oi, bs, bi)) bs = os, bi = oi;
  }
  if (part == 0 && row0 + r < B && bi != INT_MAX)
    atomicMin(&keys[row0 + r], sim_key(bs, bi));
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < BM; i += THREADS) {
    const int b = row0 + i;
    if (b >= B) break;
    const unsigned long long key = __ldcg(keys + b);
    out_idx[b] = (int32_t)(key & 0xffffffffu);
    out_sim[b] = key_sim(key);
  }
}


}  // namespace adc
