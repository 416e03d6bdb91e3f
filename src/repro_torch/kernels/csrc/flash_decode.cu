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
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py: flash_decode
// (a (B, H, S/128) Pallas grid, S innermost, carrying the online-softmax
// state (m, l, acc) in VMEM scratch across the sequential S steps; each
// query head streams its KV head's tiles on its own).
//
// Bound on the H100: bytes. Every K and V element is read once: at
// hymba-1.5b's global-layer decode shape with a 32k context (B = 8,
// S = 32,768, KV = 5, Dh = 64, bf16) that is 335.5 MB, 0.100 ms at
// 3.35 TB/s, against 2*B*H*S*Dh*2 = 1.7 GFLOP.
//
// Design. Blocks run in parallel and nothing carries between them, so the
// sequential S loop becomes (1) a split of S over blocks and (2) a merge:
// * Pass 1: one block per (split of S, KV head, batch row), 128 threads.
//   It serves all G = H / KV query heads of its KV head, so a K/V tile is
//   read from HBM once per group, not G times. B * KV alone is 20-40
//   blocks at hymba's shapes against 132 SMs, so the wrapper splits S
//   until about 16 blocks per SM exist (each block waits on its tile
//   loads and barriers, and more blocks overlap them; chip_smoke.py's
//   kernels line times 4 to 32). The block streams its keys in tiles of 32 (16-byte loads when Dh and the pointers
//   allow), converts them to float32 in shared memory, scores them for
//   every head (one key per lane), updates (m, l, acc) with the TPU
//   kernel's m_safe / corr guards and writes its partials. Keys past
//   lens[b] are never read.
// * Pass 2: one block per (head, batch row) merges the splits' partials,
//   weighting each by exp(m_i - max m), and casts to q's dtype.
// Any S (no padding), any Dh <= 256 and any G that fits shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TPB = 128;  // threads per block of pass 1
constexpr int TILE = 32;  // keys per tile: one per lane
constexpr int MERGE_TPB = 64;
constexpr size_t MAX_SMEM = 232448;  // bytes a block may opt into

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t split_smem_bytes(int G, int Dh) {
  return sizeof(float) * ((size_t)2 * G * Dh + (size_t)TILE * (Dh + 1) +
                          (size_t)TILE * Dh + (size_t)G * TILE + 3 * G);
}

// Shared memory (floats): q_s [G][Dh], acc_s [G][Dh], k_s [TILE][Dh + 1]
// (padded rows: conflict-free dots), v_s [TILE][Dh], p_s [G][TILE], and
// m_s, l_s, c_s [G] (running max, running sum, this tile's correction).
template <typename T, bool VEC>
__global__ void __launch_bounds__(TPB)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int S, int H, int KV, int Dh, int n_splits,
                   int split_len) {
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

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * Dh;
  for (int i = tid; i < G * Dh; i += TPB) {
    q_s[i] = to_f32(qb[i]);
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
      constexpr int V = 16 / sizeof(T);
      const int cpr = Dh / V;  // 16-byte chunks per row
      for (int i = tid; i < nk * cpr; i += TPB) {
        const int j = i / cpr, c = i - j * cpr;
        const size_t off = (row0 + (size_t)j * KV) * Dh + (size_t)c * V;
        const uint4 kw = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vw = *reinterpret_cast<const uint4*>(v + off);
        const T* kt = reinterpret_cast<const T*>(&kw);
        const T* vt = reinterpret_cast<const T*>(&vw);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          k_s[j * (Dh + 1) + c * V + e] = to_f32(kt[e]);
          v_s[j * Dh + c * V + e] = to_f32(vt[e]);
        }
      }
    } else {
      for (int i = tid; i < nk * Dh; i += TPB) {
        const int j = i / Dh, d = i - j * Dh;
        const size_t off = (row0 + (size_t)j * KV) * Dh + d;
        k_s[j * (Dh + 1) + d] = to_f32(k[off]);
        v_s[j * Dh + d] = to_f32(v[off]);
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

// One block per (query head, batch row): merge the splits' partials.
template <typename T>
__global__ void __launch_bounds__(MERGE_TPB)
flash_decode_merge(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int H, int KV, int Dh, int n_splits) {
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

template <typename T, bool VEC>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* lens, void* part_ml, void* part_acc,
                     void* out, int B, int S, int H, int KV, int Dh,
                     int n_splits, int split_len, size_t smem,
                     cudaStream_t st) {
  auto kern = flash_decode_split<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_splits, KV, B), TPB, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, KV,
      Dh, n_splits, split_len);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge<T><<<dim3(H, B), MERGE_TPB, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), H, KV, Dh, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Splits of split_len keys (a multiple of 32), n_splits * split_len >= S.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* part_ml, void* part_acc, void* out,
                                   int B, int S, int H, int KV, int Dh,
                                   int n_splits, int split_len, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || Dh <= 0 || Dh > 256 || S <= 0 || n_splits <= 0 ||
      split_len <= 0 || split_len % TILE ||
      (long long)n_splits * split_len < S || B > 65535 || KV > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(H / KV, Dh);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t esize = dtype == 0 ? 4 : 2;
  const bool vec = (Dh * esize) % 16 == 0 &&
                   ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
#define FD_LAUNCH(T, VEC)                                                   \
  launch_t<T, VEC>(q, k, v, lens, part_ml, part_acc, out, B, S, H, KV, Dh, \
                   n_splits, split_len, smem, st)
  cudaError_t e;
  if (dtype == 0)
    e = vec ? FD_LAUNCH(float, true) : FD_LAUNCH(float, false);
  else
    e = vec ? FD_LAUNCH(__nv_bfloat16, true)
            : FD_LAUNCH(__nv_bfloat16, false);
#undef FD_LAUNCH
  return (int)e;
}
