// qail_update: one QAIL minibatch (§III-C steps 1-3) — sims against the
// binary AM, Eq.-(4) / Eq.-(5) target selection, the miss mask, and the
// Eq.-(6) delta W^T @ upd with W[i] = lr*mis_i*(onehot(true_i) -
// onehot(pred_i)).
//
//   q       (B, D) float32  binarized queries H^b
//   upd     (B, D) float32  Eq.-(6) payload (encoded H or H^b)
//   am_t    (D, C) float32  the AM view the sims score against, element
//                           strides (sd, sc) (the transposed view of (C, D))
//   owners  (C,)   int32    centroid ownership
//   labels  (B,)   int32    true class (-1 on padded rows)
//   mask    (B,)   float32  {0, 1} row validity
//   delta   (C, D) float32  out: the Eq.-(6) increment of the float AM
//   n_miss  ()     float32  out: sum of mis
//   pred_t, true_t (B,) int32, mis (B,) float32: out, the targets
//   routes  (2,)   int32    in/out: +1 to [0] (int8 route) or [1] (fp32)
//   scratch                 int8 copies, flags, counters and partials
//                           (layout: Plan below, mirrored by the wrapper)
//
// Replaces the TPU kernel src/repro/kernels/qail_update.py: qail_update
// (a Pallas grid over query blocks with the AM, the payload and the
// (C, D) delta accumulator resident in VMEM; the delta is the MXU product
// W^T @ upd, accumulated across the sequential grid).
//
// Bound on the H100. On the fit's path the operands of the sims are
// integers: q = binarize_query(h) is ±1 and the AM view is binarize_am's
// ±1 or, under multi-bit QAT, quantize_am's codes in [-127, 127]. There the
// sims are 2*B*C*D = 0.537 GOP of int8 tensor-core work at B = 256,
// D = C = 1024 (0.27 us at 1,979 TOP/s), and the call is bound by its
// ~10.5 MB of bytes (q, upd, am_t in, delta out): 3.1 us at 3.35 TB/s. A
// noise-perturbed AM view is float: its sims are fp32 FMAs (8.0 us at
// 67 TFLOP/s). The delta has at most 2 nonzero W entries per row, so it
// costs bytes, not operations.
//
// Design. Three launches on one stream (as programmatic dependent launches
// they ran slower on the H100: the next pass's waiting blocks held the
// SMs); no float atomics, so two runs give the same delta bit for bit:
// * Convert: 64 x 64 tiles of q and of the AM view (read along whichever
//   axis is contiguous, transposed in shared memory) become int8 copies,
//   (Bp, Dp) and (Cp, Dp) row major with zero padding (Dp a multiple of
//   128 dims, Bp of the query tile, Cp of 64 columns). Every tile writes
//   one flag word: its largest |value|, or INEXACT if a value is not an
//   integer in [-127, 127]. The copy is made per call: the AM changes
//   every batch.
// * Sims: one block of 256 threads per (block_b-query, 64-column) tile.
//   It reads the flags: if every value is an integer in [-127, 127] and
//   max|q| * max|am| * D <= 2^24 (every partial sum exact in float32) it
//   takes the int8 route: the int8 tiles stream through a 4-stage cp.async
//   ring of 128-byte k slabs (16-byte chunks XOR-swizzled by row, so
//   ldmatrix reads them without bank conflicts) into
//   mma.sync.m16n8k32.s8 (s32 accumulate), 8 warps over the tile. The
//   integer sums convert to float exactly, so the targets equal the plain
//   version's bit for bit. Otherwise it takes the fp32 route, the SIMT
//   tile of sims_argmax.cuh (one fmaf per term, dims ascending) on the
//   float operands. The int8 route's first slabs are already in flight
//   while the flags are read. Block (0, 0) counts the route in
//   routes[]. The tile then goes through shared memory; one warp per row
//   folds it twice with shuffles — over all columns (Eq. 4) and over the
//   columns the row's label owns (Eq. 5) — comparing (sim, idx)
//   lexicographically (first-wins), into (2, B, n_ct) partials. The last
//   block of a row tile to finish (a counter per row tile, zeroed by the
//   convert pass) folds the row tile's partials in column-tile order into
//   pred_t, true_t (0 when the label owns no column) and
//   mis = (owners[pred_t] != label) * mask, one warp per row, one lane per
//   column tile, the lanes' bests folded with shuffles.
// * Delta: one block of 256 threads per (8-centroid, 256-dim) tile, 512
//   blocks at the training shape. It walks the B rows in chunks of 256,
//   one row per thread, and compacts with warp ballots, in row order, the
//   rows that missed and whose two targets differ with one in its
//   centroids. Each thread then owns 4 dims of 2 centroids and sums only
//   those rows, in row order, each term rounded as the plain version's
//   (lr*mis)*(±1) * upd: one fp32 product, then one fp32 add (__fmul_rn /
//   __fadd_rn, never contracted into an FMA). When pred_t == true_t the
//   two one-hots cancel and the row adds nothing, as W's zero entry does.
//   The tile is stored as 16-byte stores where D and the pointers allow.
//   Block (0, 0) sums mis in row order into n_miss.
#include "int8_convert.cuh"
#include "mma_sync.cuh"
#include "sims_argmax.cuh"

namespace {

constexpr int TPB = sims::TPB;     // 256 threads: 8 warps
constexpr int BN = sims::BN;       // 64 AM columns per sims tile
constexpr int BKB = 128;           // int8 bytes of k per ring stage
constexpr int NST = 4;             // ring stages
constexpr int CONV = conv::TILE;   // convert tile (dims x rows)
constexpr int DT = 256;            // delta dims per block: 4 per thread
constexpr int CT = 8;              // delta centroids per block: 2 per thread
constexpr unsigned INEXACT = conv::INEXACT;

long long align256(long long v) { return (v + 255) / 256 * 256; }

// The scratch layout; the wrapper (repro_torch/kernels/qail_update.py:
// plan) computes the same numbers.
struct Plan {
  int n_ct, n_rt, dp, bp, cp, n_am_tiles, n_conv;
  long long q8, am8, flags, counters, part_s, part_i, bytes;
  Plan(int B, int D, int C, int block_b) {
    n_ct = (C + BN - 1) / BN;
    n_rt = (B + block_b - 1) / block_b;
    dp = (D + BKB - 1) / BKB * BKB;
    bp = n_rt * block_b;
    cp = n_ct * BN;
    n_am_tiles = (dp / CONV) * (cp / CONV);
    n_conv = n_am_tiles + (dp / CONV) * ((bp + CONV - 1) / CONV);
    q8 = 0;
    am8 = q8 + align256((long long)bp * dp);
    flags = am8 + align256((long long)cp * dp);
    counters = flags + align256(4LL * n_conv);
    part_s = counters + align256(4LL * n_rt);
    part_i = part_s + align256(4LL * 2 * B * n_ct);
    bytes = part_i + align256(4LL * 2 * B * n_ct);
  }
};

// -- convert ------------------------------------------------------------------

__global__ void __launch_bounds__(conv::THREADS)
qail_convert(const float* __restrict__ q, const float* __restrict__ am_t,
             long long sd, long long sc, int B, int D, int C, int bp,
             int cp, int dp, int n_am_tiles, int8_t* __restrict__ q8,
             int8_t* __restrict__ am8, unsigned* __restrict__ flags,
             int* __restrict__ counters, int n_rt) {
  __shared__ float t[CONV][CONV + 1];  // [row][dim]
  __shared__ int s_max;
  const int tid = threadIdx.x, kt = dp / CONV;
  int blk = blockIdx.x;
  const float* src;
  long long sk, sr;  // element strides along dims and along rows
  int rows, rows_pad;  // rows past `rows` are written as 0 up to rows_pad
  int8_t* dst;
  if (blk < n_am_tiles) {
    src = am_t, sk = sd, sr = sc, rows = C, rows_pad = cp, dst = am8;
  } else {
    blk -= n_am_tiles;
    src = q, sk = 1, sr = D, rows = B, rows_pad = bp, dst = q8;
  }
  const int r0 = (blk / kt) * CONV, k0 = (blk % kt) * CONV;
  if (blockIdx.x == 0)
    for (int i = tid; i < n_rt; i += conv::THREADS) counters[i] = 0;
  const unsigned flag = conv::tile(src, sk, sr, rows, rows_pad, D, dp, r0,
                                   k0, dst, t, &s_max);
  if (tid == 0) flags[blockIdx.x] = flag;
}

// -- sims + Eq. 4/5 folds -----------------------------------------------------

// (s, i) <- the lexicographic best of the warp's 32 (s, i).
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float os = __shfl_xor_sync(~0u, s, o);
    const int oi = __shfl_xor_sync(~0u, i, o);
    if (sims::better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// Slab kc (k bytes [128 kc, 128 kc + 128)) of the int8 q and AM tiles into
// ring stage s: rows of 128 bytes, 16-byte chunk c of row r at chunk
// c ^ (r & 7).
template <int TM>
__device__ __forceinline__ void load_slab(const int8_t* __restrict__ q8,
                                          const int8_t* __restrict__ am8,
                                          int dp, int row0, int col0,
                                          int8_t* ring, int s, int kc) {
  constexpr int BM = 16 * TM, CPR = BKB / 16;
  int8_t* st = ring + s * (BM + BN) * BKB;
  for (int i = threadIdx.x; i < (BM + BN) * CPR; i += TPB) {
    const int r = i / CPR, c = i % CPR;
    const int8_t* src = r < BM ? q8 + (size_t)(row0 + r) * dp
                               : am8 + (size_t)(col0 + r - BM) * dp;
    mma::cp_async16(st + r * BKB + 16 * (c ^ (r & 7)),
                    src + (size_t)kc * BKB + 16 * c);
  }
}

// The int8 mainloop: the (16*TM) x 64 tile of q8 @ am8^T, s32, into
// tile[r][c] as float. The caller has issued slabs 0 .. NST - 2 (one
// commit group each). 8 warps: warp w takes m16 tile w / (8/TM) and TM
// n8 tiles from column 8*TM*(w % (8/TM)).
template <int TM>
__device__ void sims_int8(const int8_t* __restrict__ q8,
                          const int8_t* __restrict__ am8, int dp, int row0,
                          int col0, unsigned char* smem, float* tile) {
  constexpr int BM = 16 * TM, STAGE = (BM + BN) * BKB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  const int n_k = dp / BKB;
  constexpr int WN = 8 / TM;  // warps along n
  const int mrow = (warp / WN) * 16, n0 = (warp % WN) * TM * 8;
  const int a_row = mrow + ((lane >> 3) & 1) * 8 + (lane & 7), a_ch = lane >> 4;
  int acc[TM][4];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int t = 0; t < n_k; ++t) {
    mma::cp_async_wait<NST - 2>();
    __syncthreads();  // slab t landed; slab t - 1's stage is free
    {
      const int tn = t + NST - 1;
      if (tn < n_k)
        load_slab<TM>(q8, am8, dp, row0, col0, ring, tn % NST, tn);
      mma::cp_async_commit();
    }
    const int8_t* st = ring + (t % NST) * STAGE;
#pragma unroll
    for (int ks = 0; ks < BKB / 32; ++ks) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, st + a_row * BKB + 16 * ((2 * ks + a_ch) ^ (a_row & 7)));
      if constexpr (TM == 1) {
        uint32_t b[2];
        const int br = BM + n0 + (lane & 7), bc = 2 * ks + ((lane >> 3) & 1);
        mma::ldmatrix_x2(b, st + br * BKB + 16 * (bc ^ (br & 7)));
        mma::mma_s8(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < TM / 2; ++p) {
          uint32_t b[4];
          const int br = BM + n0 + 16 * p + (lane >> 4) * 8 + (lane & 7);
          const int bc = 2 * ks + ((lane >> 3) & 1);
          mma::ldmatrix_x4(b, st + br * BKB + 16 * (bc ^ (br & 7)));
          mma::mma_s8(acc[2 * p], a, b[0], b[1]);
          mma::mma_s8(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile overwrites it
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(mrow + gid + 8 * (e >> 1)) * (BN + 1) + n0 + 8 * j + 2 * tig +
           (e & 1)] = (float)acc[j][e];
}

// TM queries per m16 tile row: (16 * TM)-query tiles.
template <int TM>
__global__ void __launch_bounds__(TPB)
qail_sims(const float* __restrict__ q, const float* __restrict__ am_t,
          long long sd, long long sc, const int8_t* __restrict__ q8,
          const int8_t* __restrict__ am8, const unsigned* __restrict__ flags,
          int n_am_tiles, int n_conv, const int32_t* __restrict__ owners,
          const int32_t* __restrict__ labels, const float* __restrict__ mask,
          float* __restrict__ part_s, int* __restrict__ part_i,
          int* __restrict__ counters, int* __restrict__ routes,
          int32_t* __restrict__ pred_t, int32_t* __restrict__ true_t,
          float* __restrict__ mis, int B, int D, int C, int dp) {
  constexpr int BM = 16 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_max[2], s_owner[BN], s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = blockIdx.x, rt = blockIdx.y, n_ct = gridDim.x;
  const int row0 = rt * BM, col0 = ct * BN;
  // The int8 route's first slabs load while the flags are read (the fp32
  // route drops them).
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < dp / BKB)
      load_slab<TM>(q8, am8, dp, row0, col0,
                    reinterpret_cast<int8_t*>(smem), s, s);
    mma::cp_async_commit();
  }
  if (tid < 2) s_max[tid] = 0;
  if (tid < BN) s_owner[tid] = col0 + tid < C ? owners[col0 + tid] : 0;
  __syncthreads();
  bool inexact = false;
  int mq = 0, ma = 0;
  for (int i = tid; i < n_conv; i += TPB) {
    const unsigned f = flags[i];
    if (f & INEXACT)
      inexact = true;
    else if (i < n_am_tiles)
      ma = max(ma, (int)f);
    else
      mq = max(mq, (int)f);
  }
  atomicMax(&s_max[0], mq);
  atomicMax(&s_max[1], ma);
  inexact = __syncthreads_or(inexact);
  const bool use_int8 =
      !inexact && (long long)s_max[0] * s_max[1] * D <= (1LL << 24);
  float* tile = reinterpret_cast<float*>(smem);  // [BM][BN + 1]
  if (use_int8) {
    sims_int8<TM>(q8, am8, dp, row0, col0, smem, tile);
  } else {
    mma::cp_async_wait<0>();
    __syncthreads();  // the slabs landed: the staging buffers reuse them
    float(*qs)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(smem);
    float(*as)[BN + 1] =
        reinterpret_cast<float(*)[BN + 1]>(smem + sizeof(float) * sims::BK * (BM + 1));
    float acc[TM][sims::TN];
    sims::tile<TM>(q, am_t, sd, sc, B, D, C, row0, col0, qs, as, acc);
    // tile() ends on a barrier: the staging buffers are free.
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < sims::TN; ++j)
        tile[(ty * TM + i) * (BN + 1) + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (ct == 0 && rt == 0 && tid == 0) atomicAdd(&routes[use_int8 ? 0 : 1], 1);
  const size_t half = (size_t)B * n_ct;
  for (int r = warp; r < BM; r += TPB / 32) {
    const int row = row0 + r;
    if (row >= B) break;  // warp-uniform
    const int lab = labels[row];
    const int c0 = col0 + lane, c1 = c0 + 32;
    const float s0 = tile[r * (BN + 1) + lane];
    const float s1 = tile[r * (BN + 1) + lane + 32];
    float bs = -INFINITY, os = -INFINITY;  // Eq. 4 and Eq. 5
    int bi = INT_MAX, oi = INT_MAX;
    if (c0 < C) {
      bs = s0, bi = c0;
      if (s_owner[lane] == lab) os = s0, oi = c0;
    }
    if (c1 < C) {
      if (sims::better(s1, c1, bs, bi)) bs = s1, bi = c1;
      if (s_owner[lane + 32] == lab && sims::better(s1, c1, os, oi))
        os = s1, oi = c1;
    }
    warp_best(bs, bi);
    warp_best(os, oi);
    if (lane == 0) {
      part_s[(size_t)row * n_ct + ct] = bs;
      part_i[(size_t)row * n_ct + ct] = bi;
      part_s[half + (size_t)row * n_ct + ct] = os;
      part_i[half + (size_t)row * n_ct + ct] = oi;
    }
  }
  // The last column tile of the row tile to finish folds its partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[rt], 1) == n_ct - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = warp; r < BM; r += TPB / 32) {
    const int b = row0 + r;
    if (b >= B) break;  // warp-uniform
    int best[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {  // lane c takes column tiles c, c + 32..
      const float* ps = part_s + f * half + (size_t)b * n_ct;
      const int* pi = part_i + f * half + (size_t)b * n_ct;
      float bs = -INFINITY;
      int bi = INT_MAX;
      for (int c = lane; c < n_ct; c += 32) {
        const float s = __ldcg(ps + c);
        const int i = __ldcg(pi + c);
        if (sims::better(s, i, bs, bi)) bs = s, bi = i;
      }
      warp_best(bs, bi);
      best[f] = bi;
    }
    if (lane == 0) {
      pred_t[b] = best[0];
      true_t[b] = best[1] == INT_MAX ? 0 : best[1];  // the label owns none
      mis[b] = (float)(owners[best[0]] != labels[b]) * mask[b];
    }
  }
}

// -- delta ----------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(TPB)
qail_delta(const float* __restrict__ upd, const int32_t* __restrict__ pred_t,
           const int32_t* __restrict__ true_t, const float* __restrict__ mis,
           float lr, int B, int D, int C, float* __restrict__ delta,
           float* __restrict__ n_miss) {
  __shared__ int s_t[TPB], s_p[TPB], s_row[TPB], s_cnt[TPB / 32];
  __shared__ float s_w[TPB], s_m[TPB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * CT, d = blockIdx.x * DT + 4 * (tid & 63);
  const int cj = c0 + (tid >> 6);  // and cj + 4
  const bool total = blockIdx.x == 0 && blockIdx.y == 0;
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float nm = 0.0f;
  for (int base = 0; base < B; base += TPB) {
    const int i = base + tid;
    int t = 0, p = 0;
    float m = 0.0f;
    if (i < B) m = mis[i], t = true_t[i], p = pred_t[i];
    const bool hit = m != 0.0f && t != p &&
                     ((t >= c0 && t < c0 + CT) || (p >= c0 && p < c0 + CT));
    const unsigned bal = __ballot_sync(~0u, hit);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    if (total) s_m[tid] = m;
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) {
      off += w < warp ? s_cnt[w] : 0;
      n += s_cnt[w];
    }
    if (hit) {  // compacted in row order
      const int k = off + __popc(bal & ((1u << lane) - 1));
      s_row[k] = i, s_t[k] = t, s_p[k] = p;
      s_w[k] = __fmul_rn(lr, m);  // lr * mis_i, as the plain version
    }
    __syncthreads();
    if (total && tid == 0)
      for (int k = 0; k < min(TPB, B - base); ++k) nm = __fadd_rn(nm, s_m[k]);
    for (int k = 0; k < n; ++k) {
      const float* ur = upd + (size_t)s_row[k] * D + d;
      float u[4];
      if (VEC) {
        const float4 v = d < D ? *reinterpret_cast<const float4*>(ur)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = d + e < D ? ur[e] : 0.0f;
      }
      const int t = s_t[k], p = s_p[k];
      const float w = s_w[k];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cj + 4 * j;
        const float coef = (float)(t == c) - (float)(p == c);
        if (coef != 0.0f) {
          const float wc = __fmul_rn(w, coef);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(wc, u[e]));
        }
      }
    }
    __syncthreads();  // the lists are rewritten by the next chunk
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = cj + 4 * j;
    if (c >= C) continue;
    float* out = delta + (size_t)c * D + d;
    if (VEC) {
      if (d < D)
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) out[e] = acc[j][e];
    }
  }
  if (total && tid == 0) *n_miss = nm;
}

template <int TM>
size_t sims_smem() {
  const size_t ring = (size_t)NST * (16 * TM + BN) * BKB;
  const size_t tile = sizeof(float) * 16 * TM * (BN + 1);
  const size_t stage = sizeof(float) * sims::BK * (16 * TM + 1 + BN + 1);
  return ring > tile ? (ring > stage ? ring : stage)
                     : (tile > stage ? tile : stage);
}

template <int TM>
cudaError_t launch_sims(dim3 grid, cudaStream_t st, const float* q,
                        const float* am_t, long long sd, long long sc,
                        const int8_t* q8, const int8_t* am8,
                        const unsigned* flags, int n_am_tiles, int n_conv,
                        const int32_t* owners, const int32_t* labels,
                        const float* mask, float* part_s, int* part_i,
                        int* counters, int* routes, int32_t* pred_t,
                        int32_t* true_t, float* mis, int B, int D, int C,
                        int dp) {
  const size_t smem = sims_smem<TM>();
  const cudaError_t e = cudaFuncSetAttribute(
      qail_sims<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  qail_sims<TM><<<grid, TPB, smem, st>>>(
      q, am_t, sd, sc, q8, am8, flags, n_am_tiles, n_conv, owners, labels,
      mask, part_s, part_i, counters, routes, pred_t, true_t, mis, B, D, C,
      dp);
  return cudaGetLastError();
}

}  // namespace

// scratch: scratch_bytes bytes from the caller (Plan above); routes: (2,)
// int32 route counts; block_b is the query tile of the sims pass (16, 32
// or 64). Returns the cudaError_t of the launches (0 on success).
extern "C" int qail_update_launch(const void* q, const void* upd,
                                  const void* am_t, long long sd,
                                  long long sc, const void* owners,
                                  const void* labels, const void* mask,
                                  float lr, void* scratch,
                                  long long scratch_bytes, void* routes,
                                  void* pred_t, void* true_t, void* mis,
                                  void* delta, void* n_miss, int B, int D,
                                  int C, int block_b, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((block_b != 16 && block_b != 32 && block_b != 64) || B < 0 || D <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan pl(B, D, C, block_b);
  const int n_dt = (D + DT - 1) / DT, n_cb = (C + CT - 1) / CT;
  if (pl.bytes != scratch_bytes || pl.n_rt > 65535 || n_cb > 65535)
    return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  int8_t* q8 = reinterpret_cast<int8_t*>(base + pl.q8);
  int8_t* am8 = reinterpret_cast<int8_t*>(base + pl.am8);
  unsigned* flags = reinterpret_cast<unsigned*>(base + pl.flags);
  int* counters = reinterpret_cast<int*>(base + pl.counters);
  float* part_s = reinterpret_cast<float*>(base + pl.part_s);
  int* part_i = reinterpret_cast<int*>(base + pl.part_i);
  const float* fq = static_cast<const float*>(q);
  const float* fam = static_cast<const float*>(am_t);
  cudaError_t e;
  if (B > 0) {
    qail_convert<<<pl.n_conv, conv::THREADS, 0, s>>>(fq, fam, sd, sc, B, D, C, pl.bp,
                                           pl.cp, pl.dp, pl.n_am_tiles, q8,
                                           am8, flags, counters, pl.n_rt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(pl.n_ct, pl.n_rt);
#define QS_ARGS                                                               \
  grid, s, fq, fam, sd, sc, (const int8_t*)q8, (const int8_t*)am8,            \
      (const unsigned*)flags, pl.n_am_tiles, pl.n_conv,                       \
      static_cast<const int32_t*>(owners),                                    \
      static_cast<const int32_t*>(labels), static_cast<const float*>(mask),   \
      part_s, part_i, counters, static_cast<int*>(routes),                    \
      static_cast<int32_t*>(pred_t), static_cast<int32_t*>(true_t),           \
      static_cast<float*>(mis), B, D, C, pl.dp
    switch (block_b) {
      case 16: e = launch_sims<1>(QS_ARGS); break;
      case 32: e = launch_sims<2>(QS_ARGS); break;
      default: e = launch_sims<4>(QS_ARGS); break;
    }
#undef QS_ARGS
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = D % 4 == 0 && ((uintptr_t)upd | (uintptr_t)delta) % 16 == 0;
  const dim3 grid(n_dt, n_cb);
  const float* fu = static_cast<const float*>(upd);
  const int32_t* pp = static_cast<const int32_t*>(pred_t);
  const int32_t* tp = static_cast<const int32_t*>(true_t);
  const float* mp = static_cast<const float*>(mis);
  float* fd = static_cast<float*>(delta);
  float* nm = static_cast<float*>(n_miss);
  if (vec)
    qail_delta<true><<<grid, TPB, 0, s>>>(fu, pp, tp, mp, lr, B, D, C, fd, nm);
  else
    qail_delta<false><<<grid, TPB, 0, s>>>(fu, pp, tp, mp, lr, B, D, C, fd,
                                           nm);
  return (int)cudaGetLastError();
}
