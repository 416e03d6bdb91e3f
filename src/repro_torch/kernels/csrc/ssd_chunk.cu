// ssd_chunk: one Mamba-2 SSD chunk for every (batch row, head).
//
//   x      (B, Q, H, P)  float32 or bfloat16 (dtype 0 / 1)
//   b, c   (B, Q, H, N)  x's dtype
//   dt, da (B, Q, H)     float32 step size and per-step log-decay
//   state  (B, H, N, P)  float32, entering the chunk
//   y      (B, Q, H, P)  x's dtype, contiguous:
//                        (C B^T o decay)(x dt) + (C o e^cum) S
//   s_new  (B, H, N, P)  float32, contiguous, leaving the chunk:
//                        e^{cum_Q} S + (B o e^{cum_Q - cum})^T (x dt)
// with cum = cumsum(da) and decay[i][j] = exp(cum_i - cum_j) for j <= i,
// else 0. The inputs' batch rows may be strided (sx, sb, sc, sdt, sda
// elements apart: chunks sliced from a sequence); within a row they are
// contiguous.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py: ssd_chunk (a
// (B, H) Pallas grid, one (batch, head) per step with the whole chunk in
// VMEM: the (Q, Q) decay and C B^T matrices and four MXU products).
//
// Bound on the H100: bytes. The function needs the causal triangle
// (Q(Q+1)/2 entries) of C B^T and of its product with x dt, plus C S and
// the state update: per (b, h) Q(Q+1)N + Q(Q+1)P + 4QNP flops. With the
// served model's bf16 x, B and C, each product counted at the type and
// number of terms it needs at float32 accuracy: C B^T one exact bf16
// product, G x three bf16 products (G float32 in three bf16 terms against
// exact x), C S and the state update two TF32 products (one float32
// operand in two terms against an exact one). At hymba-1.5b's chunk
// (Q = 256, N = 16, P = 64) and B = 8 (400 pairs): 0.42 GFLOP of C B^T and
// 3 x 1.68 GFLOP of G x at 989 TFLOP/s, and 2 x 0.42 GFLOP at 495 TFLOP/s,
// 0.0072 ms, against 36.9 MB of operands at 3.35 TB/s, 0.0110 ms (B = 2:
// 0.00275 ms), and 0.038 ms at the 67 TFLOP/s fp32 FMA rate.
//
// Design. Every product runs on mma.sync tensor cores with f32
// accumulation, at float32 accuracy:
// * a float32 operand v enters TF32 products (m16n8k8) as hi = tf32(v) and
//   lo = tf32(v - hi), a product as lo*hi' + hi*lo' + hi*hi' (~2^-21
//   relative);
// * bfloat16 inputs (the served model) make C B^T one exact bf16 product
//   (m16n8k16) per term, and dt is folded into the decay (G (x dt) =
//   (G o dt) x), so G x is three bf16 products: G as three bf16 terms,
//   each the rounding of what the others leave (~2^-24), against x, which
//   is exact in bf16 and read by ldmatrix.trans. Float32 inputs run C B^T
//   and G x as three TF32 products, x split once per key tile into
//   fragment order for all warps.
// * The grid: every (b, h) gets ceil(N/32) state blocks, one per 32 rows
//   of the new state, and ceil(Q/64) y blocks, one per 64-row tile of y;
//   500 blocks at the served B 2 x H 50. Blocks are numbered heaviest
//   first: the state blocks (every key tile), then y tile i, which walks
//   i + 1 key tiles, before i - 1. Each block scans the chunk's cum itself
//   (Q adds); nothing is reduced across blocks.
// * A block has 8 warps: 4 groups of 16 rows (or of 16 state rows and
//   half of P), each split into two key halves (32 keys of every 64-key
//   tile), whose sums meet once, at the end, in a fixed order. Its loads
//   (da and dt first, the C tile and the entering state, key tile 0) are
//   all in flight while it scans cum. Key tiles stream through cp.async
//   stages (16-byte copies zero-filled past Q; plain loads when a row is
//   not a multiple of 16 bytes or a base is misaligned): tile t + 1 loads
//   while tile t computes.
// * A y warp forms the inter-chunk term (C S) e^cum, then per key tile its
//   16 x 32 strip C B^T into accumulator fragments, multiplies it there by
//   exp(cum_i - cum_j) dt_j (as e^{cum_i - M} times a per-key
//   e^{M - cum_j} dt_j, M = cum at the tile's first row, whenever every
//   |cum - M| <= 80; else one expf per element) with the causal mask, and
//   feeds the fragments straight back as the A operand of G x. In TF32 an
//   accumulator holds keys 2t, 2t + 1 of a k-step where an A fragment
//   holds keys t, t + 4, so the B operand x is read with the same
//   permutation of its rows.
// * A state warp accumulates (B o e^{cum_Q - cum} o dt)^T x for its 16
//   rows of N, then adds e^{cum_Q} S.
// Shared-memory rows are padded so that fragment loads are free of bank
// conflicts (row strides of 4 mod 32 floats, 8 mod 32 bf16). Any Q >= 1,
// N and P up to 128. The wrapper's plan (kernels/ssd_chunk.py launch_plan)
// gives the launcher the blocks per (b, h), the n8 tiles over P and the
// shared memory; the launcher refuses a plan that differs from Geom's, and
// the kernel maps its blocks by the plan's counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr int TPB = 256;      // 8 warps: 4 row groups x 2 key halves
constexpr int TILE = 64;      // y rows per block, keys per ring tile
constexpr int STATE_ROWS = 32;  // rows of N per state block
constexpr float FACTOR_RANGE = 80.f;  // e^80 and e^-80 are normal floats
constexpr size_t MAX_SMEM = 232448;   // bytes a block may opt into

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// n8 tiles over P: P <= 8 * col_tiles(P).
__host__ __device__ inline int col_tiles(int P) {
  return P <= 16 ? 2 : P <= 32 ? 4 : P <= 64 ? 8 : 16;
}

// Shared-memory geometry; the wrapper's smem_bytes mirrors it. In order:
// cum, dts and ex (Q padded to 64, floats); the C tile (64 rows of N, T);
// the xf area: float32 x of the current key tile split into TF32 (hi, lo)
// pairs in fragment order (one float4 per lane, n8 tile and k-step), and
// before the key loop the entering state (rows of P floats), after it the
// key halves' sums; the ring: x tiles (two for bf16, read in place; one
// raw float32 tile) and two B tiles (T).
struct Geom {
  int sn, sp, ss, qp, xstages;  // row strides of B/C, x, S; padded Q
  size_t off_c, off_xf, off_r, bytes;
  __host__ __device__ Geom(int Q, int N, int P, int esize) {
    const int pad = esize == 4 ? 4 : 8;
    sn = round_up(N, 32) + pad;
    sp = round_up(P, 32) + pad;
    ss = round_up(P, 32) + 8;
    qp = round_up(Q, TILE);
    xstages = esize == 4 ? 1 : 2;
    size_t xf = (size_t)2048 * col_tiles(P);  // the halves' sums
    if (esize == 4) xf *= 2;  // the (hi, lo) float32 x tile
    const size_t s_tile = (size_t)round_up(N, 8) * ss * 4;
    off_c = (size_t)3 * qp * 4;
    off_xf = off_c + (size_t)TILE * sn * esize;
    off_r = off_xf + (xf > s_tile ? xf : s_tile);
    bytes = off_r + (size_t)TILE * (xstages * sp + 2 * sn) * esize;
  }
};

struct Args {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* da;
  const float* state;
  void* y;
  float* s_new;
  int B, Q, H, N, P;
  long long sx, sb, sc, sdt, sda;
  int y_blocks, state_blocks;  // blocks per (b, h): the wrapper's plan
};

// Rows [r0, r0 + 64) of a (Q, H, W) operand's head h into a tile with row
// stride `stride`; rows past Q are zero. Columns past W are never written.
template <typename T, bool ASYNC>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int Q, int H, int h, int W,
                                          int stride) {
  if (ASYNC) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = W / V;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < TILE * cpr; i += TPB) {
      const int r = i / cpr, ch = i - r * cpr, row = r0 + r;
      const bool ok = row < Q;
      const T* s = ok ? src + ((size_t)row * H + h) * W + ch * V : src;
      mma::cp_async16_zfill(dst + r * stride + ch * V, s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * W; i += TPB) {
      const int r = i / W, w = i - r * W, row = r0 + r;
      dst[r * stride + w] =
          row < Q ? src[((size_t)row * H + h) * W + w] : T(0.f);
    }
  }
}

// Three-term TF32 product into d: a (hi, lo) times b (hi, lo), b =
// (hi0, hi1, lo0, lo1); EXACT_B: b is its own hi (two terms).
template <bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float4 b) {
  mma::mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.y));
  if constexpr (!EXACT_B)
    mma::mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma::mma_tf32(d, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// Warps 4-7 (the second key half) hand their sums to warps 0-3 through
// red (128 floats per value), which add them; true for warps 0-3.
template <int R>
__device__ __forceinline__ bool fold_halves(float (&acc)[R][4], float* red) {
  const int warp = threadIdx.x >> 5, kh = warp >> 2;
  const int slot = (warp & 3) * 32 + (threadIdx.x & 31);
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * i + e) * 128 + slot] = acc[i][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += red[(4 * i + e) * 128 + slot];
  }
  return kh == 0;
}

// CP: n8 tiles over P per y row (P <= 8 * CP).
template <typename T, int CP, bool ASYNC>
__global__ void __launch_bounds__(TPB, (CP <= 8 ? 2 : 1) + (sizeof(T) == 2))
ssd_chunk_kernel(Args a) {
  constexpr bool EXACT_IN = sizeof(T) == 2;  // bf16 B, C: their own hi
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_tot[TPB / 32];
  __shared__ int s_dev;
  const int Q = a.Q, H = a.H, N = a.N, P = a.P;
  const Geom g(Q, N, P, sizeof(T));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int QT = a.y_blocks, SB = a.state_blocks;
  const int BH = a.B * H;
  const int unit = blockIdx.x / BH, bh = blockIdx.x - unit * BH;
  const int bb = bh / H, h = bh - bb * H;
  // State blocks first (each walks every key tile), then the y tiles,
  // heaviest first.
  const bool is_y = unit >= SB;
  const int it = QT - 1 - (unit - SB);  // y tile

  float* cum = reinterpret_cast<float*>(smem);
  float* dts = cum + g.qp;
  float* ex = dts + g.qp;
  T* Cs = reinterpret_cast<T*>(smem + g.off_c);
  float4* xf = reinterpret_cast<float4*>(smem + g.off_xf);
  T* ring = reinterpret_cast<T*>(smem + g.off_r);
  auto stage_x = [&](int s) { return ring + (s % g.xstages) * TILE * g.sp; };
  auto stage_b = [&](int s) {
    return ring + g.xstages * TILE * g.sp + (s & 1) * TILE * g.sn;
  };

  // The k dims of C B^T and C S run to N rounded up to 8 (16 for bf16
  // C B^T): there the padding of C, B and S must be zero (and no NaN may
  // meet it). Other padding only reaches outputs that are not stored.
  if (N % (EXACT_IN ? 16 : 8) != 0) {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (size_t i = tid; i < g.bytes / 16; i += TPB)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  const T* x = static_cast<const T*>(a.x) + bb * a.sx;
  const T* bm = static_cast<const T*>(a.b) + bb * a.sb;
  const T* cm = static_cast<const T*>(a.c) + bb * a.sc;
  const float* dt = a.dt + bb * a.sdt;
  const float* da = a.da + bb * a.sda;
  const float* st = a.state + ((size_t)bb * H + h) * N * P;
  if (tid == 0) s_dev = 0;
  __syncthreads();
  const int i0 = it * TILE;
  float* Ss = reinterpret_cast<float*>(xf);
  // da and dt first (the scan waits on them), then two copy groups: the C
  // tile and the entering state (the inter-chunk term waits on them), and
  // key tile 0.
  const float da0 = tid < Q ? da[(size_t)tid * H + h] : 0.f;
  const float dt0 = tid < Q ? dt[(size_t)tid * H + h] : 0.f;
  if (is_y) {
    load_rows<T, ASYNC>(Cs, cm, i0, Q, H, h, N, g.sn);
    if (ASYNC) {
      const int cpr = P / 4;
      for (int i = tid; i < N * cpr; i += TPB) {
        const int n = i / cpr, ch = i - n * cpr;
        mma::cp_async16(Ss + n * g.ss + 4 * ch, st + n * P + 4 * ch);
      }
    } else {
      for (int i = tid; i < N * P; i += TPB) {
        const int n = i / P;
        Ss[n * g.ss + (i - n * P)] = st[i];
      }
    }
  }
  mma::cp_async_commit();
  load_rows<T, ASYNC>(stage_x(0), x, 0, Q, H, h, P, g.sp);
  load_rows<T, ASYNC>(stage_b(0), bm, 0, Q, H, h, N, g.sn);
  mma::cp_async_commit();
  for (int j = tid; j < g.qp; j += TPB) {
    cum[j] = j == tid ? da0 : j < Q ? da[(size_t)j * H + h] : 0.f;
    dts[j] = j == tid ? dt0 : j < Q ? dt[(size_t)j * H + h] : 0.f;
  }
  __syncthreads();

  // cum = inclusive prefix sum of da, in place (warp scans, then warp
  // totals); past Q, cum holds cum[Q - 1] and dts 0.
  float carry = 0.f;
  for (int base = 0; base < Q; base += TPB) {
    const int j = base + tid;
    float v = j < Q ? cum[j] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(~0u, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float off = carry, tot = 0.f;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) {
      if (w < warp) off += warp_tot[w];
      tot += warp_tot[w];
    }
    if (j < Q) cum[j] = v + off;
    carry += tot;
    __syncthreads();
  }
  const float total = cum[Q - 1];
  for (int j = Q + tid; j < g.qp; j += TPB) cum[j] = total;

  // Per-key weights, dt folded in (G (x dt) = (G dt) x): e^{M - cum_j} dt_j
  // (y block, M = cum at its first row; dt_j alone when the factors are
  // out of range) or e^{cum_Q - cum_j} dt_j (state block); 0 past Q.
  const int i_end = min(Q, i0 + TILE);
  const float M = is_y ? cum[i0] : 0.f;
  if (is_y) {
    float dev = 0.f;
    for (int j = tid; j < i_end; j += TPB) dev = fmaxf(dev, fabsf(cum[j] - M));
#pragma unroll
    for (int o = 16; o; o >>= 1) dev = fmaxf(dev, __shfl_xor_sync(~0u, dev, o));
    if (lane == 0) atomicMax(&s_dev, __float_as_int(dev));  // >= 0: int order
  }
  __syncthreads();
  const bool factor = is_y && __int_as_float(s_dev) <= FACTOR_RANGE;
  for (int j = tid; j < g.qp; j += TPB)
    ex[j] = j >= Q ? 0.f
                   : (is_y ? (factor ? expf(M - cum[j]) : 1.f)
                           : expf(total - cum[j])) * dts[j];

  // The B operand x of k-step kk, n8 tile nt for this lane: keys
  // 8 kk + 2 tig, + 1 at column 8 nt + gid, as TF32 (hi0, hi1, lo0, lo1).
  // A bfloat16 x is its own hi (lo = 0: its products skip), read in place;
  // a float32 x is split once per tile into xf, for all warps.
  auto x_frag = [&](const T* xt, int kk, int nt) {
    if constexpr (EXACT_IN) {
      const T* x0 = xt + (8 * kk + 2 * tig) * g.sp + 8 * nt + gid;
      return make_float4(to_f32(x0[0]), to_f32(x0[g.sp]), 0.f, 0.f);
    } else {
      return xf[(kk * CP + nt) * 32 + lane];
    }
  };
  auto prep_x = [&](const T* xt) {
#pragma unroll
    for (int i = tid; i < 8 * CP * 32; i += TPB) {
      const int kk = i / (CP * 32), nt = (i / 32) % CP, ln = i % 32;
      const int k = 8 * kk + 2 * (ln & 3), p = 8 * nt + (ln >> 2);
      uint32_t h0, l0, h1, l1;
      mma::split_tf32(to_f32(xt[k * g.sp + p]), h0, l0);
      mma::split_tf32(to_f32(xt[(k + 1) * g.sp + p]), h1, l1);
      xf[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
    }
  };
  // Key tiles 0 .. n_tiles - 1 (tile 0 issued above): tile t's B in stage
  // t & 1, its x in stage t & 1 (bf16) or split into xf (float32); tile
  // t + 1 loads while tile t computes.
  auto key_loop = [&](int n_tiles, auto&& compute) {
    for (int t = 0; t < n_tiles; ++t) {
      mma::cp_async_wait<0>();
      __syncthreads();  // tile t landed; compute(t - 1) is done
      if constexpr (!EXACT_IN) {
        prep_x(stage_x(t));
        __syncthreads();  // xf ready, the raw x tile free
      }
      if (t + 1 < n_tiles) {
        load_rows<T, ASYNC>(stage_x(t + 1), x, (t + 1) * TILE, Q, H, h, P,
                            g.sp);
        load_rows<T, ASYNC>(stage_b(t + 1), bm, (t + 1) * TILE, Q, H, h, N,
                            g.sn);
      }
      mma::cp_async_commit();
      compute(t, stage_b(t), stage_x(t));
    }
  };

  // Warp w takes rows (or state rows) of group w & 3 and keys
  // 32 kh .. 32 kh + 31 of every key tile, kh = w >> 2; the two halves'
  // sums meet once, at the end, in a fixed order.
  const int kh = warp >> 2;

  if (is_y) {
    const int lr[2] = {16 * (warp & 3) + gid, 16 * (warp & 3) + gid + 8};
    const int nk = round_up(N, 8) / 8;
    float acc[CP][4];
    // Inter-chunk term: C S (the key halves take alternate k-steps), then
    // each row times e^{cum_i}.
    mma::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < CP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int ks = kh; ks < nk; ks += 2) {
      uint32_t ah[4], al[4];
      const int k0 = 8 * ks + tig;
      const float av[4] = {to_f32(Cs[lr[0] * g.sn + k0]),
                           to_f32(Cs[lr[1] * g.sn + k0]),
                           to_f32(Cs[lr[0] * g.sn + k0 + 4]),
                           to_f32(Cs[lr[1] * g.sn + k0 + 4])};
#pragma unroll
      for (int e = 0; e < 4; ++e) mma::split_tf32(av[e], ah[e], al[e]);
#pragma unroll
      for (int nt = 0; nt < CP; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        mma::split_tf32(Ss[k0 * g.ss + 8 * nt + gid], bh0, bl0);
        mma::split_tf32(Ss[(k0 + 4) * g.ss + 8 * nt + gid], bh1, bl1);
        if constexpr (!EXACT_IN) mma::mma_tf32(acc[nt], al, bh0, bh1);
        mma::mma_tf32(acc[nt], ah, bl0, bl1);
        mma::mma_tf32(acc[nt], ah, bh0, bh1);
      }
    }
    float erow[2];  // e^{cum_i - M} per fragment row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float cr = cum[i0 + lr[r]];
      const float e = expf(cr);
      erow[r] = expf(cr - M);
#pragma unroll
      for (int nt = 0; nt < CP; ++nt) {
        acc[nt][2 * r] *= e;
        acc[nt][2 * r + 1] *= e;
      }
    }
    // ldmatrix lanes: A rows (C), B rows (keys of B), and V-style rows of
    // the x tile (keys) read transposed.
    const int a_row = ((lane >> 3) & 1) * 8 + (lane & 7), a_ch = lane >> 4;
    const int k_key = (lane >> 4) * 8 + (lane & 7), k_ch = (lane >> 3) & 1;
    key_loop(it + 1, [&](int t, const T* Bs, const T* Xt) {
      const int j0 = t * TILE;
      // The strip C B^T for the warp's 16 rows x 32 keys (n8 tile n8 holds
      // keys 32 kh + 8 n8 ..).
      float s[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
      if constexpr (EXACT_IN) {  // bf16 C and B: exact bf16 products
        for (int ks = 0; ks < (N + 15) / 16; ++ks) {
          uint32_t af[4];
          mma::ldmatrix_x4(af, Cs + (16 * (warp & 3) + a_row) * g.sn +
                                   16 * ks + 8 * a_ch);
#pragma unroll
          for (int p2 = 0; p2 < 2; ++p2) {
            uint32_t kf[4];
            mma::ldmatrix_x4(kf, Bs + (32 * kh + 16 * p2 + k_key) * g.sn +
                                     16 * ks + 8 * k_ch);
            mma::mma_bf16(s[2 * p2], af, kf[0], kf[1]);
            mma::mma_bf16(s[2 * p2 + 1], af, kf[2], kf[3]);
          }
        }
      } else {  // float32 C and B: three TF32 products each
        for (int ks = 0; ks < nk; ++ks) {
          uint32_t ah[4], al[4];
          const int k0 = 8 * ks + tig;
          const float av[4] = {to_f32(Cs[lr[0] * g.sn + k0]),
                               to_f32(Cs[lr[1] * g.sn + k0]),
                               to_f32(Cs[lr[0] * g.sn + k0 + 4]),
                               to_f32(Cs[lr[1] * g.sn + k0 + 4])};
#pragma unroll
          for (int e = 0; e < 4; ++e) mma::split_tf32(av[e], ah[e], al[e]);
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            const T* br = Bs + (32 * kh + 8 * n8 + gid) * g.sn + k0;
            uint32_t bh0, bl0, bh1, bl1;
            mma::split_tf32(to_f32(br[0]), bh0, bl0);
            mma::split_tf32(to_f32(br[4]), bh1, bl1);
            mma::mma_tf32(s[n8], al, bh0, bh1);
            mma::mma_tf32(s[n8], ah, bl0, bl1);
            mma::mma_tf32(s[n8], ah, bh0, bh1);
          }
        }
      }
      // G = strip o decay o dt on the fragments (causal on the diagonal
      // tile).
      const bool diag = t == it;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = j0 + 32 * kh + 8 * n8 + 2 * tig + (e & 1);
          const int row = i0 + lr[r];
          float v = s[n8][e];
          if (diag && key > row)
            v = 0.f;
          else if (factor)
            v = v * erow[r] * ex[key];
          else
            v = v * expf(cum[row] - cum[key]) * ex[key];
          s[n8][e] = v;
        }
      if constexpr (EXACT_IN) {
        // G x: n8 tiles 2j, 2j + 1 of G are the A operand of k16 step j,
        // as three bf16 terms; x (bf16, exact) through ldmatrix.trans.
        const int v_key = ((lane >> 3) & 1) * 8 + (lane & 7), v_ch = lane >> 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t a3[4][3];  // [register][term]
          mma::split_bf16x3(s[2 * j][0], s[2 * j][1], a3[0]);
          mma::split_bf16x3(s[2 * j][2], s[2 * j][3], a3[1]);
          mma::split_bf16x3(s[2 * j + 1][0], s[2 * j + 1][1], a3[2]);
          mma::split_bf16x3(s[2 * j + 1][2], s[2 * j + 1][3], a3[3]);
#pragma unroll
          for (int dd = 0; dd < CP / 2; ++dd) {
            uint32_t vf[4];
            mma::ldmatrix_x4_trans(vf, Xt + (32 * kh + 16 * j + v_key) * g.sp +
                                           16 * dd + 8 * v_ch);
#pragma unroll
            for (int i = 2; i >= 0; --i) {  // the small terms first
              const uint32_t af[4] = {a3[0][i], a3[1][i], a3[2][i], a3[3][i]};
              mma::mma_bf16(acc[2 * dd], af, vf[0], vf[1]);
              mma::mma_bf16(acc[2 * dd + 1], af, vf[2], vf[3]);
            }
          }
        }
      } else {
        // G x: n8 tile kk of G is the A operand of TF32 k-step 4 kh + kk,
        // its accumulator holding keys 2 tig, 2 tig + 1 where an A fragment
        // holds keys tig, tig + 4: x_frag reads x's rows permuted alike.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ah[4], al[4];  // A rows gid, gid + 8; keys ka, ka + 1
          mma::split_tf32(s[kk][0], ah[0], al[0]);
          mma::split_tf32(s[kk][2], ah[1], al[1]);
          mma::split_tf32(s[kk][1], ah[2], al[2]);
          mma::split_tf32(s[kk][3], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < CP; ++nt)
            mma3<false>(acc[nt], ah, al, x_frag(Xt, 4 * kh + kk, nt));
        }
      }
      __syncthreads();  // xf and the stages are free
    });
    if (!fold_halves(acc, reinterpret_cast<float*>(xf))) return;
    T* y = static_cast<T*>(a.y);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + lr[r];
      if (row >= Q) continue;
      T* yr = y + (((size_t)bb * Q + row) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < CP; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * nt + 2 * tig + e;
          if (p < P) store(yr + p, acc[nt][2 * r + e]);
        }
    }
    return;
  }

  // A state block: rows n0 .. n0 + 31 of the new state. Warp w takes the
  // m16 tile w & 1, the n8 tiles ((w >> 1) & 1) * CP/2 .. + CP/2 - 1 and
  // the key half kh.
  constexpr int HC = CP / 2;
  const int n0 = unit * STATE_ROWS + 16 * (warp & 1);
  const int p8 = ((warp >> 1) & 1) * HC;
  float acc[HC][4];
#pragma unroll
  for (int j = 0; j < HC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  key_loop(QT, [&](int t, const T* Bs, const T* Xt) {
    const int j0 = t * TILE;
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int kk = 4 * kh + k4;
      const int ka = 8 * kk + 2 * tig;  // keys ka, ka + 1 (permuted k)
      const float w0 = ex[j0 + ka], w1 = ex[j0 + ka + 1];  // with dt
      const T* b0 = Bs + ka * g.sn + n0 + gid;
      const T* b1 = b0 + g.sn;
      uint32_t ah[4], al[4];  // A rows n0 + gid, + 8; keys ka, ka + 1
      mma::split_tf32(to_f32(b0[0]) * w0, ah[0], al[0]);
      mma::split_tf32(to_f32(b0[8]) * w0, ah[1], al[1]);
      mma::split_tf32(to_f32(b1[0]) * w1, ah[2], al[2]);
      mma::split_tf32(to_f32(b1[8]) * w1, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < HC; ++j)
        mma3<EXACT_IN>(acc[j], ah, al, x_frag(Xt, kk, p8 + j));
    }
    __syncthreads();  // xf and the stages are free
  });
  if (!fold_halves(acc, reinterpret_cast<float*>(xf))) return;
  const float e_total = expf(total);
  float* s_out = a.s_new + ((size_t)bb * H + h) * N * P;
#pragma unroll
  for (int j = 0; j < HC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + gid + 8 * (e >> 1);
      const int p = 8 * (p8 + j) + 2 * tig + (e & 1);
      if (n < N && p < P)
        s_out[n * P + p] = __fadd_rn(__fmul_rn(st[n * P + p], e_total),
                                     acc[j][e]);
    }
}

template <typename T, int CP, bool ASYNC>
cudaError_t launch_t(const Args& a, int blocks, size_t smem,
                     cudaStream_t st) {
  auto kern = ssd_chunk_kernel<T, CP, ASYNC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, TPB, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
cudaError_t launch_cols(const Args& a, int cols, int blocks, size_t smem,
                        cudaStream_t st) {
  switch (cols) {
    case 2: return launch_t<T, 2, ASYNC>(a, blocks, smem, st);
    case 4: return launch_t<T, 4, ASYNC>(a, blocks, smem, st);
    case 8: return launch_t<T, 8, ASYNC>(a, blocks, smem, st);
    default: return launch_t<T, 16, ASYNC>(a, blocks, smem, st);
  }
}

template <typename T>
cudaError_t launch_dtype(const Args& a, int cols, int blocks, size_t smem,
                         cudaStream_t st) {
  // 16-byte copies need rows of a multiple of 16 bytes and 16-byte
  // aligned bases and batch strides (the state: rows of P floats).
  const size_t es = sizeof(T);
  const bool vec =
      (a.N * es) % 16 == 0 && (a.P * es) % 16 == 0 && a.P % 4 == 0 &&
      ((uintptr_t)a.x | (uintptr_t)a.b | (uintptr_t)a.c |
       (uintptr_t)a.state) % 16 == 0 &&
      ((a.sx * es) | (a.sb * es) | (a.sc * es)) % 16 == 0;
  return vec ? launch_cols<T, true>(a, cols, blocks, smem, st)
             : launch_cols<T, false>(a, cols, blocks, smem, st);
}

}  // namespace

// y_blocks, state_blocks, col_tiles, smem: the wrapper's launch plan for
// (B, Q, H, N, P, dtype), refused (cudaErrorInvalidValue) unless it is the
// kernel's own. Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_chunk_launch(const void* x, const void* b, const void* c,
                                const void* dt, const void* da,
                                const void* state, void* y, void* s_new,
                                int B, int Q, int H, int N, int P,
                                long long sx, long long sb, long long sc,
                                long long sdt, long long sda, int dtype,
                                int y_blocks, int state_blocks, int cols,
                                long long smem, void* stream) {
  if (B <= 0 || H <= 0 || Q <= 0) return 0;
  if (N < 1 || N > 128 || P < 1 || P > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Geom g(Q, N, P, dtype == 0 ? 4 : 2);
  const long long blocks = ((long long)y_blocks + state_blocks) * B * H;
  if (y_blocks != g.qp / TILE ||
      state_blocks != (N + STATE_ROWS - 1) / STATE_ROWS ||
      cols != col_tiles(P) || (long long)g.bytes != smem ||
      g.bytes > MAX_SMEM || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{x, b, c, static_cast<const float*>(dt),
               static_cast<const float*>(da), static_cast<const float*>(state),
               y, static_cast<float*>(s_new), B, Q, H, N, P, sx, sb, sc, sdt,
               sda, y_blocks, state_blocks};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_dtype<float>(a, cols, (int)blocks, g.bytes, st)
                   : launch_dtype<__nv_bfloat16>(a, cols, (int)blocks,
                                                 g.bytes, st));
}
