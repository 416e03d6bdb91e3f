// flash_decode: attention of one query position over a length-masked KV
// cache (the decode step of every GQA layer).
//
//   q         (B, H, Dh)        float32 or bfloat16 (dtype 0 / 1)
//   k, v      (B, S, KV, Dh)    q's dtype; query head h reads KV head
//                               h / (H / KV)
//   lens      (B,)       int32  valid keys per row; keys at index
//                               >= lens[b] are masked
//   part_ml   (B, KV, n_splits, G, 2)   float32 scratch: (m, l) per split
//   part_acc  (B, KV, n_splits, G, Dh)  float32 scratch: acc per split
//   out       (B, H, Dh)        q's dtype: acc / max(l, 1e-20); a row
//                               with lens 0 yields 0
//   softcap   float             > 0: the scaled scores s become
//                               softcap * tanh(s / softcap) before the
//                               running max; 0: no cap. A template flag
//                               (CAP) of both pass-1 kernels, so the
//                               uncapped instances are the kernels
//                               without the cap, on the same launch plan.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py: flash_decode
// (a (B, H, S/128) Pallas grid, S innermost, carrying the online-softmax
// state (m, l, acc) in VMEM scratch across the sequential S steps; each
// query head streams its KV head's tiles on its own).
//
// Bound on the H100: bytes. Every K and V element is read once: at
// hymba-1.5b's global-layer decode shape with a 32k context (B = 8,
// S = 32,768, KV = 5, Dh = 64, bf16) that is 335.5 MB, 0.100 ms at
// 3.35 TB/s, against 2*B*H*S*Dh*2 = 1.7 GFLOP, which the bf16 tensor
// cores do in under 2 us. 335.5 MB does not fit the 50 MB L2, so every
// call at that shape streams its cache from HBM.
//
// Design. Blocks run in parallel and nothing carries between them, so the
// sequential S loop becomes (1) a split of S over blocks and (2) a merge.
// Pass 1 has one block per (split of S, KV head, batch row): it serves the
// query heads of its KV head, so a K/V tile is read from HBM once per
// group, not G times. The wrapper chooses the splits (split_plan).
// * bfloat16, the served dtype (flash_decode_mma): the block's 4 warps
//   stream K and V tiles of 64 keys, kept as bf16, through a ring of 3
//   stages in shared memory filled by 16-byte cp.async (marked evict-first
//   in L2: the cache streams once per call), so the loads of tiles t+1 and
//   t+2 are in flight while tile t computes; one barrier per tile. Rows
//   hold DHP bf16, their 16-byte chunks XOR-swizzled by row (conflict-free
//   ldmatrix without padding); Dh pads to DHP in {32, 64, 128, 256} with
//   zero columns. At Dh 64 a block holds 51.2 KB, so 4 share an SM with 2
//   tiles each in flight. Each warp takes 16 keys of the tile. QK^T is
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate: every product exact) with
//   the query heads as the 16 rows of A, padded with zero rows (G > 16
//   takes more blocks, one per 16 heads); A is read once into registers
//   (DHP <= 128) or per tile from shared memory (256). The online softmax
//   runs on the accumulator fragments with quad shuffles, with the TPU
//   kernel's m_safe / corr guards. P @ V is two mma.sync per fragment
//   against V (ldmatrix.trans): P split into a bf16 high part and the bf16
//   rounding of p - hi, so the probabilities enter at ~2^-16 relative (the
//   TPU kernel forms P @ V on f32 p). The 4 warps merge their (m, l, acc)
//   once, in shared memory, at the end of the split. Rows whose 16-byte
//   copies cannot be aligned (Dh * 2 not a multiple of 16, or a misaligned
//   K / V pointer) take the same kernel with plain 2-byte loads (ASYNC =
//   false), an explicit choice of the launcher.
// * float32 (flash_decode_simt): no f32 tensor-core path keeps f32
//   products, and TF32 would not, so the SIMT kernel stays: tiles of 32
//   keys in shared memory as float, one key per lane for the scores, one
//   warp per head for the softmax, one (head, dim) per thread for P @ V.
// Pass 2: one block per (head, batch row) merges the splits' partials,
// weighting each by exp(m_i - max m), and casts to q's dtype. It is a
// programmatic dependent launch, so its launch overlaps pass 1's end. Keys
// past lens[b] are never read; any S, any Dh <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;  // bytes a block may opt into
constexpr int MERGE_TPB = 64;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// -- float32: the SIMT kernel -------------------------------------------------

constexpr int SIMT_TPB = 128;
constexpr int SIMT_TILE = 32;  // keys per tile: one per lane

size_t simt_smem_bytes(int G, int Dh) {
  return sizeof(float) *
         ((size_t)2 * G * Dh + (size_t)SIMT_TILE * (Dh + 1) +
          (size_t)SIMT_TILE * Dh + (size_t)G * SIMT_TILE + 3 * G);
}

// Shared memory (floats): q_s [G][Dh], acc_s [G][Dh], k_s [TILE][Dh + 1]
// (padded rows: conflict-free dots), v_s [TILE][Dh], p_s [G][TILE], and
// m_s, l_s, c_s [G] (running max, running sum, this tile's correction).
template <bool VEC, bool CAP>
__global__ void __launch_bounds__(SIMT_TPB)
flash_decode_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ lens,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int S, int H, int KV, int Dh, int n_splits, int split_len,
                  float cap) {
  constexpr int TILE = SIMT_TILE, TPB = SIMT_TPB;
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // pass 2 may launch
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_s = smem;
  float* acc_s = q_s + G * Dh;
  float* k_s = acc_s + G * Dh;
  float* v_s = k_s + TILE * (Dh + 1);
  float* p_s = v_s + TILE * Dh;
  float* m_s = p_s + G * TILE;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  // The reference's 1 / sqrt(Dh), rounded once to float32.
  const float scale = (float)(1.0 / sqrt((double)Dh));

  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * Dh;
  for (int i = tid; i < G * Dh; i += TPB) {
    q_s[i] = qb[i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += TPB) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int len = min(max(lens[b], 0), S);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, len);
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int nk = min(TILE, hi - t0);
    const size_t row0 = ((size_t)b * S + t0) * KV + kvh;  // key t0's row
    if (VEC) {
      constexpr int V = 4;
      const int cpr = Dh / V;  // 16-byte chunks per row
      for (int i = tid; i < nk * cpr; i += TPB) {
        const int j = i / cpr, c = i - j * cpr;
        const size_t off = (row0 + (size_t)j * KV) * Dh + (size_t)c * V;
        const float4 kw = *reinterpret_cast<const float4*>(k + off);
        const float4 vw = *reinterpret_cast<const float4*>(v + off);
        const float* kt = reinterpret_cast<const float*>(&kw);
        const float* vt = reinterpret_cast<const float*>(&vw);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          k_s[j * (Dh + 1) + c * V + e] = kt[e];
          v_s[j * Dh + c * V + e] = vt[e];
        }
      }
    } else {
      for (int i = tid; i < nk * Dh; i += TPB) {
        const int j = i / Dh, d = i - j * Dh;
        const size_t off = (row0 + (size_t)j * KV) * Dh + d;
        k_s[j * (Dh + 1) + d] = k[off];
        v_s[j * Dh + d] = v[off];
      }
    }
    __syncthreads();
    // Scores s = (k . q) * scale; lanes past the tile's keys are masked.
    for (int i = tid; i < G * TILE; i += TPB) {
      const int g = i / TILE, j = i - g * TILE;
      float s = -INFINITY;
      if (j < nk) {
        const float* qr = q_s + g * Dh;
        const float* kr = k_s + j * (Dh + 1);
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(kr[d], qr[d], dot);
        s = dot * scale;
        if (CAP) s = cap * tanhf(s / cap);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // Online-softmax update, one warp per head, one key per lane.
    for (int g = warp; g < G; g += TPB / 32) {
      const float s = p_s[g * TILE + lane];
      float mt = s;
#pragma unroll
      for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(~0u, mt, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mt);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = isfinite(s) ? expf(s - m_safe) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) ps += __shfl_xor_sync(~0u, ps, o);
      p_s[g * TILE + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v, in float32.
    for (int i = tid; i < G * Dh; i += TPB) {
      const int g = i / Dh, d = i - g * Dh;
      const float* pr = p_s + g * TILE;
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], v_s[j * Dh + d], a);
      acc_s[i] = acc_s[i] * c_s[g] + a;
    }
    __syncthreads();
  }

  const size_t pbase = (((size_t)b * KV + kvh) * n_splits + split) * G;
  for (int i = tid; i < G * Dh; i += TPB) part_acc[pbase * Dh + i] = acc_s[i];
  for (int g = tid; g < G; g += TPB) {
    part_ml[(pbase + g) * 2] = m_s[g];
    part_ml[(pbase + g) * 2 + 1] = l_s[g];
  }
}

// -- bfloat16: tensor cores fed by a cp.async ring ----------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_TPB = 32 * MMA_WARPS;
constexpr int KT = 16 * MMA_WARPS;  // keys per tile: 16 per warp
constexpr int NST = 3;              // ring stages
constexpr int QROWS = 16;           // query heads per block: one m16 tile

int mma_dhp(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 256;
}

// The ring (NST stages of K and V tiles) plus the query tile, rows of DHP
// bf16; the warps' merge scratch reuses the ring.
size_t mma_smem_bytes(int Dh) {
  return 2 * (size_t)mma_dhp(Dh) * ((size_t)NST * 2 * KT + QROWS);
}

// Element offset of the 16-byte chunk c of row r in a tile of rows of DHP
// bf16. The chunk index is XOR-swizzled so that the 8 rows one ldmatrix
// reads at the same logical chunk fall in 8 distinct bank groups.
template <int DHP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = DHP / 8;  // chunks per row: 4, 8, 16 or 32
  return 8 * (r * CH + (CH >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3)));
}

using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;

// 16-byte copy to shared memory, marked evict-first in L2: the cache is
// streamed once per call, and its lines should not displace others.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          mma::smem_u32(dst)),
      "l"(src), "l"(policy));
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One tile of keys [t0, t0 + nk) of KV head kvh into stage buffers ks, vs.
template <int DHP, bool ASYNC>
__device__ __forceinline__ void load_kv_tile(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* ks, __nv_bfloat16* vs, size_t row0, int KV, int Dh,
    int nk) {
  if (ASYNC) {
    const uint64_t policy = evict_first_policy();
    const int cpr = Dh / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < nk * cpr; i += MMA_TPB) {
      const int j = i / cpr, c = i - j * cpr;
      const size_t off = (row0 + (size_t)j * KV) * Dh + (size_t)c * 8;
      cp_async16(ks + swz<DHP>(j, c), k + off, policy);
      cp_async16(vs + swz<DHP>(j, c), v + off, policy);
    }
  } else {
    for (int i = threadIdx.x; i < nk * Dh; i += MMA_TPB) {
      const int j = i / Dh, d = i - j * Dh;
      const size_t off = (row0 + (size_t)j * KV) * Dh + d;
      ks[swz<DHP>(j, d >> 3) + (d & 7)] = k[off];
      vs[swz<DHP>(j, d >> 3) + (d & 7)] = v[off];
    }
  }
}

template <int DHP>
constexpr int mma_min_blocks() {
  return DHP <= 64 ? 4 : DHP <= 128 ? 2 : 1;
}

template <int DHP, bool ASYNC, bool CAP>
__global__ void __launch_bounds__(MMA_TPB, mma_min_blocks<DHP>())
flash_decode_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ lens, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int S, int H, int KV, int Dh,
                 int n_splits, int split_len, float cap) {
  constexpr int TSZ = KT * DHP;     // bf16 per K or V tile
  constexpr int KSTEPS = DHP / 16;  // k-steps of QK^T over the head dim
  constexpr int DTILES = DHP / 8;   // n-tiles of P @ V over the head dim
  constexpr bool QREG = DHP <= 128;
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // pass 2 may launch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* q_s = ring + NST * 2 * TSZ;  // [QROWS][DHP], swizzled

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = H / KV;
  const int MT = (G + QROWS - 1) / QROWS;
  const int kvh = blockIdx.y / MT, g0 = (blockIdx.y - kvh * MT) * QROWS;
  const int rows = min(QROWS, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const float scale = (float)(1.0 / sqrt((double)Dh));

  const int len = min(max(lens[b], 0), S);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, len);
  const int n_tiles = lo < hi ? (hi - lo + KT - 1) / KT : 0;
  // Zero the query tile, and the ring unless every tile is whole and Dh
  // unpadded: the padded columns and the rows past a partial tile's keys
  // must be finite zeros (p = 0 must meet a finite v).
  {
    const bool whole = Dh == DHP && (hi - lo) % KT == 0;
    const int n16 = (NST * 2 * KT + QROWS) * DHP * 2 / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = whole ? NST * 2 * TSZ * 2 / 16 + tid : tid; i < n16;
         i += MMA_TPB)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const size_t kv_row = (size_t)b * S * KV + kvh;  // key 0's row

  auto stage_k = [&](int s) { return ring + s * 2 * TSZ; };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = lo + s * KT;
      load_kv_tile<DHP, ASYNC>(k, v, stage_k(s), stage_k(s) + TSZ,
                               kv_row + (size_t)t0 * KV, KV, Dh,
                               min(KT, hi - t0));
    }
    cp_async_commit();
  }
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G + g0) * Dh;
  for (int i = tid; i < rows * Dh; i += MMA_TPB) {
    const int r = i / Dh, d = i - r * Dh;
    q_s[swz<DHP>(r, d >> 3) + (d & 7)] = qb[i];
  }
  __syncthreads();  // q_s

  // ldmatrix lane addresses (row, 16-byte chunk within a 16-wide step):
  // A (Q) rows 0-15; B (K) 16 keys for two n-tiles of 8 keys; B (V^T) 16
  // keys for two n-tiles of 8 dims.
  const int a_row = ((lane >> 3) & 1) * 8 + (lane & 7), a_ch = lane >> 4;
  const int k_key = (lane >> 4) * 8 + (lane & 7), k_ch = (lane >> 3) & 1;
  const int v_key = ((lane >> 3) & 1) * 8 + (lane & 7), v_ch = lane >> 4;

  uint32_t qf[QREG ? KSTEPS : 1][4];
  if (QREG) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      ldmatrix_x4(qf[QREG ? ks : 0], q_s + swz<DHP>(a_row, 2 * ks + a_ch));
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows gid, gid + 8
  float l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    {
      const int tn = t + NST - 1;
      if (tn < n_tiles) {
        const int s = tn % NST, t0 = lo + tn * KT;
        load_kv_tile<DHP, ASYNC>(k, v, stage_k(s), stage_k(s) + TSZ,
                                 kv_row + (size_t)t0 * KV, KV, Dh,
                                 min(KT, hi - t0));
      }
      cp_async_commit();
    }
    const int nk = min(KT, hi - (lo + t * KT));
    const int kbase = warp * 16;
    if (kbase >= nk) continue;  // warp-uniform: none of its keys is valid
    const __nv_bfloat16* ks = stage_k(t % NST);
    const __nv_bfloat16* vs = ks + TSZ;

    // s = Q K^T for the warp's 16 keys: n-tile n holds keys 8n .. 8n + 7.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kstep = 0; kstep < KSTEPS; ++kstep) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + swz<DHP>(kbase + k_key, 2 * kstep + k_ch));
      if (QREG) {
        mma_bf16(s[0], qf[QREG ? kstep : 0], kf[0], kf[1]);
        mma_bf16(s[1], qf[QREG ? kstep : 0], kf[2], kf[3]);
      } else {
        uint32_t af[4];
        ldmatrix_x4(af, q_s + swz<DHP>(a_row, 2 * kstep + a_ch));
        mma_bf16(s[0], af, kf[0], kf[1]);
        mma_bf16(s[1], af, kf[2], kf[3]);
      }
    }
    // Online softmax on the fragments: element e of n-tile n is row
    // gid + 8 (e >> 1), key kbase + 8n + 2 tig + (e & 1).
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + 8 * n + 2 * tig + (e & 1);
        float x = s[n][e] * scale;
        if (CAP) x = cap * tanhf(x / cap);
        s[n][e] = key < nk ? x : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    float corr[2], m_safe[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(~0u, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(~0u, mt[r], 2));
      const float m_new = fmaxf(m_r[r], mt[r]);
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      corr[r] = isfinite(m_r[r]) ? expf(m_r[r] - m_safe[r]) : 0.f;
      m_r[r] = m_new;
    }
    uint32_t phi[4], plo[4];  // A fragments of P: high and low bf16 parts
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = s[n][2 * r], x1 = s[n][2 * r + 1];
        const float p0 = isfinite(x0) ? expf(x0 - m_safe[r]) : 0.f;
        const float p1 = isfinite(x1) ? expf(x1 - m_safe[r]) : 0.f;
        ps[r] += p0 + p1;
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
        phi[2 * n + r] = pack_bf16(__bfloat162float(h0),
                                   __bfloat162float(h1));
        plo[2 * n + r] = pack_bf16(p0 - __bfloat162float(h0),
                                   p1 - __bfloat162float(h1));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(~0u, ps[r], 1);
      ps[r] += __shfl_xor_sync(~0u, ps[r], 2);
      l_r[r] = l_r[r] * corr[r] + ps[r];
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    // acc += P @ V, two 8-dim n-tiles per ldmatrix.
#pragma unroll
    for (int dd = 0; dd < DTILES / 2; ++dd) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + swz<DHP>(kbase + v_key, 2 * dd + v_ch));
      mma_bf16(acc[2 * dd], phi, vf[0], vf[1]);
      mma_bf16(acc[2 * dd], plo, vf[0], vf[1]);
      mma_bf16(acc[2 * dd + 1], phi, vf[2], vf[3]);
      mma_bf16(acc[2 * dd + 1], plo, vf[2], vf[3]);
    }
  }

  // Merge the 4 warps' (m, l, acc) in shared memory (over the ring).
  cp_async_wait<0>();
  __syncthreads();
  float* m_w = reinterpret_cast<float*>(smem_raw);  // [warps][16]
  float* l_w = m_w + MMA_WARPS * QROWS;              // [warps][16]
  float* acc_w = l_w + MMA_WARPS * QROWS;            // [warps][16][DHP]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r;
    if (tig == 0) {
      m_w[warp * QROWS + row] = m_r[r];
      l_w[warp * QROWS + row] = l_r[r];
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      float* a = acc_w + (warp * QROWS + row) * DHP + 8 * dt + 2 * tig;
      a[0] = acc[dt][2 * r];
      a[1] = acc[dt][2 * r + 1];
    }
  }
  __syncthreads();
  const size_t pbase =
      (((size_t)b * KV + kvh) * n_splits + split) * G + g0;
  for (int i = tid; i < rows * Dh; i += MMA_TPB) {
    const int row = i / Dh, d = i - row * Dh;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w)
      m_all = fmaxf(m_all, m_w[w * QROWS + row]);
    const float ms = isfinite(m_all) ? m_all : 0.f;
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float m = m_w[w * QROWS + row];
      const float wt = isfinite(m) ? expf(m - ms) : 0.f;
      l_all = fmaf(wt, l_w[w * QROWS + row], l_all);
      a = fmaf(wt, acc_w[(w * QROWS + row) * DHP + d], a);
    }
    part_acc[(pbase + row) * Dh + d] = a;
    if (d == 0) {
      part_ml[(pbase + row) * 2] = m_all;
      part_ml[(pbase + row) * 2 + 1] = l_all;
    }
  }
}

// -- pass 2 -------------------------------------------------------------------

// One block per (query head, batch row): merge the splits' partials. It is
// launched as a programmatic dependent of pass 1, so its launch overlaps
// pass 1's end; griddepcontrol.wait holds it until pass 1's writes are
// visible.
template <typename T>
__global__ void __launch_bounds__(MERGE_TPB)
flash_decode_merge(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int H, int KV, int Dh, int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, kvh = h / G, g = h - kvh * G;
  const size_t base = ((size_t)b * KV + kvh) * n_splits;
  float m_all = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    m_all = fmaxf(m_all, part_ml[((base + s) * G + g) * 2]);
  const float m_safe = isfinite(m_all) ? m_all : 0.f;
  float l_all = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float m = part_ml[((base + s) * G + g) * 2];
    const float w = isfinite(m) ? expf(m - m_safe) : 0.f;
    l_all = fmaf(w, part_ml[((base + s) * G + g) * 2 + 1], l_all);
  }
  const float inv = 1.f / fmaxf(l_all, 1e-20f);
  for (int d = threadIdx.x; d < Dh; d += MERGE_TPB) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float m = part_ml[((base + s) * G + g) * 2];
      const float w = isfinite(m) ? expf(m - m_safe) : 0.f;
      a = fmaf(w, part_acc[((base + s) * G + g) * Dh + d], a);
    }
    store(out + ((size_t)b * H + h) * Dh + d, a * inv);
  }
}

template <int DHP, bool ASYNC, bool CAP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* lens, void* part_ml, void* part_acc,
                       int B, int S, int H, int KV, int Dh, int n_splits,
                       int split_len, float cap, cudaStream_t st) {
  auto kern = flash_decode_mma<DHP, ASYNC, CAP>;
  const size_t smem = mma_smem_bytes(Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int mt = (H / KV + QROWS - 1) / QROWS;
  using bf = __nv_bfloat16;
  kern<<<dim3(n_splits, KV * mt, B), MMA_TPB, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const int*>(lens),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, KV,
      Dh, n_splits, split_len, cap);
  return cudaGetLastError();
}

template <bool VEC, bool CAP>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* lens, void* part_ml, void* part_acc,
                        int B, int S, int H, int KV, int Dh, int n_splits,
                        int split_len, float cap, cudaStream_t st) {
  auto kern = flash_decode_simt<VEC, CAP>;
  const size_t smem = simt_smem_bytes(H / KV, Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_splits, KV, B), SIMT_TPB, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, KV,
      Dh, n_splits, split_len, cap);
  return cudaGetLastError();
}

#define FD_ARGS                                                             \
  q, k, v, lens, part_ml, part_acc, B, S, H, KV, Dh, n_splits, split_len, \
      cap, st

// Pass 1 of one dtype and load width: the instance with the cap or
// without it.
template <bool CAP>
cudaError_t launch_pass1(const void* q, const void* k, const void* v,
                         const void* lens, void* part_ml, void* part_acc,
                         int B, int S, int H, int KV, int Dh, int n_splits,
                         int split_len, float cap, int dtype, bool vec,
                         cudaStream_t st) {
  if (dtype == 0)
    return vec ? launch_simt<true, CAP>(FD_ARGS)
               : launch_simt<false, CAP>(FD_ARGS);
  switch (mma_dhp(Dh)) {
    case 32:
      return vec ? launch_mma<32, true, CAP>(FD_ARGS)
                 : launch_mma<32, false, CAP>(FD_ARGS);
    case 64:
      return vec ? launch_mma<64, true, CAP>(FD_ARGS)
                 : launch_mma<64, false, CAP>(FD_ARGS);
    case 128:
      return vec ? launch_mma<128, true, CAP>(FD_ARGS)
                 : launch_mma<128, false, CAP>(FD_ARGS);
    default:
      return vec ? launch_mma<256, true, CAP>(FD_ARGS)
                 : launch_mma<256, false, CAP>(FD_ARGS);
  }
}

#undef FD_ARGS

}  // namespace

// Splits of split_len keys (a multiple of the dtype's tile: 32 keys for
// float32, 64 for bfloat16), n_splits * split_len >= S; softcap 0 (no
// cap) or positive; out_f32 1 writes `out` in float32 whatever the
// dtype (a sequence shard's unrounded partial), 0 in the inputs' dtype.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* part_ml, void* part_acc, void* out,
                                   int B, int S, int H, int KV, int Dh,
                                   int n_splits, int split_len, int dtype,
                                   int out_f32, float softcap, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int tile = dtype == 0 ? SIMT_TILE : KT;
  if (KV <= 0 || H % KV || Dh <= 0 || Dh > 256 || S <= 0 || n_splits <= 0 ||
      split_len <= 0 || split_len % tile ||
      (long long)n_splits * split_len < S || B > 65535 ||
      (dtype != 0 && dtype != 1) || (out_f32 != 0 && out_f32 != 1) ||
      !(softcap >= 0.f && softcap < INFINITY))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const long long grid_y =
      dtype == 0 ? KV : (long long)KV * ((G + QROWS - 1) / QROWS);
  if (grid_y > 65535 ||
      (dtype == 0 ? simt_smem_bytes(G, Dh) : mma_smem_bytes(Dh)) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t esize = dtype == 0 ? 4 : 2;
  // 16-byte copies need 16-byte rows and 16-byte aligned bases.
  const bool vec = (Dh * esize) % 16 == 0 &&
                   ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaError_t e =
      softcap > 0.f
          ? launch_pass1<true>(q, k, v, lens, part_ml, part_acc, B, S, H, KV,
                               Dh, n_splits, split_len, softcap, dtype, vec,
                               st)
          : launch_pass1<false>(q, k, v, lens, part_ml, part_acc, B, S, H,
                                KV, Dh, n_splits, split_len, 0.f, dtype, vec,
                                st);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(MERGE_TPB);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pml = static_cast<const float*>(part_ml);
  const float* pacc = static_cast<const float*>(part_acc);
  if (dtype == 0 || out_f32)
    e = cudaLaunchKernelEx(&cfg, flash_decode_merge<float>, pml, pacc,
                           static_cast<float*>(out), H, KV, Dh, n_splits);
  else
    e = cudaLaunchKernelEx(&cfg, flash_decode_merge<__nv_bfloat16>, pml,
                           pacc, static_cast<__nv_bfloat16*>(out), H, KV, Dh,
                           n_splits);
  return (int)e;
}
