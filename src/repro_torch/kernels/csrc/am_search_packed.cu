// am_search_packed: XOR + popcount associative search over the packed
// 1-bit AM, with a first-wins running argmax.
//
//   q     (B, Dp) uint8   packed queries, LSB-first along D, tail bits 0
//   am_t  (Dp, C) uint8   packed transposed AM (column c = centroid c)
//   idx   (B,)    int32   winning centroid
//   sim   (B,)    float32 n_dims - 2 * popcount(q XOR am[:, idx])
//
// Replaces the TPU kernel src/repro/kernels/am_search_packed.py:
// am_search_packed, both modes (a (B/bB, C/128, Dp/16) Pallas grid doing
// 8-bit SWAR popcounts on the VPU — or, with mode="unpack", unpacking each
// slab to ±1 in VMEM for the MXU — and carrying the running winner across
// C steps in VMEM scratch).
//
// Bound on the H100: operations. At the main path's B = C = D = 1024 it
// reads 128 KB + 128 KB but issues B*C*D/32 = 33.6 M XOR+popc word pairs;
// popc issues at 16 per clock per SM, a quarter of the XOR/add rate, so
// the popcount count over the card's popc rate (132 SMs * 16 * clock) is
// the least time — about 8 us at 1.98 GHz.
//
// Design:
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
// * mode="unpack" (am_search_packed_unpack_kernel) walks the same tiles
//   but, per 128-dim slab, unpacks the 16 query bytes and the (16, 64)
//   AM bytes to ±1 floats in shared memory — dims >= n_dims unpack to 0,
//   not -1 — and accumulates the float dot with fmaf. The dot of ±1/0
//   values is an exact integer, so hamming = (n_dims - dot) / 2 exactly,
//   and both modes feed the same running compare and the same fold
//   (emit_winners): their (idx, sim) are bit-equal.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

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
    uint32_t word = 0;
    if (b < B) {
      const uint8_t* row = q + (size_t)b * Dp;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 4 * w + k;
        if (d < Dp) word |= (uint32_t)row[d] << (8 * k);
      }
    }
    qs[e] = word;
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
      uint32_t word = 0;
      if (c < C) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = 4 * w + k;
          if (d < Dp) word |= (uint32_t)am_t[(size_t)d * C + c] << (8 * k);
        }
      }
      as[e] = word;
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

constexpr int SB = 16;       // packed bytes per unpack slab
constexpr int SD = 8 * SB;   // dims per unpack slab

// mode="unpack": the same tiles and fold, with the similarity taken as
// the float dot of the operands unpacked to ±1 (0 past n_dims).
template <int QPT>
__global__ void __launch_bounds__(TX * TY)
am_search_packed_unpack_kernel(const uint8_t* __restrict__ q,
                               const uint8_t* __restrict__ am_t,
                               int32_t* __restrict__ out_idx,
                               float* __restrict__ out_sim, int B, int Dp,
                               int C, int n_dims) {
  constexpr int BQ = TY * QPT;
  constexpr int NT = TX * TY;
  extern __shared__ uint32_t smem[];
  float* qf = (float*)smem;                  // [BQ][SD]
  float* af = qf + BQ * SD;                  // [SD][TX]
  int* red_ham = (int*)(af + SD * TX);       // [BQ][TX]
  int* red_idx = red_ham + BQ * TX;          // [BQ][TX]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b0 = blockIdx.x * BQ;
  const int n_slabs = (Dp + SB - 1) / SB;

  int best_ham[QPT], best_idx[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    best_ham[j] = INT_MAX;
    best_idx[j] = INT_MAX;
  }

  for (int c0 = 0; c0 < C; c0 += TX) {
    const int c = c0 + tx;
    float dot[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) dot[j] = 0.0f;
    for (int sl = 0; sl < n_slabs; ++sl) {
      __syncthreads();  // the previous slab is consumed
      // Query bytes -> ±1 (0 past n_dims or past B).
      for (int e = tid; e < BQ * SB; e += NT) {
        const int r = e / SB, bl = e % SB;
        const int b = b0 + r, byte = sl * SB + bl;
        const int v = (b < B && byte < Dp) ? q[(size_t)b * Dp + byte] : 0;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const int d = 8 * byte + bit;
          qf[r * SD + 8 * bl + bit] =
              d < n_dims ? ((v >> bit) & 1 ? 1.0f : -1.0f) : 0.0f;
        }
      }
      // AM bytes of this column tile -> ±1 (0 past n_dims or past C).
      for (int e = tid; e < SB * TX; e += NT) {
        const int bl = e / TX, cc = e % TX;
        const int cg = c0 + cc, byte = sl * SB + bl;
        const bool live = cg < C && byte < Dp;
        const int v = live ? am_t[(size_t)byte * C + cg] : 0;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const int d = 8 * byte + bit;
          af[(8 * bl + bit) * TX + cc] =
              (live && d < n_dims) ? ((v >> bit) & 1 ? 1.0f : -1.0f) : 0.0f;
        }
      }
      __syncthreads();
      if (c < C) {
        for (int dd = 0; dd < SD; ++dd) {
          const float a = af[dd * TX + tx];
#pragma unroll
          for (int j = 0; j < QPT; ++j)
            dot[j] = fmaf(qf[(ty + TY * j) * SD + dd], a, dot[j]);
        }
      }
    }
    if (c < C) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        // dot = n_dims - 2 * hamming, an exact integer in float32.
        const int ham = (n_dims - (int)dot[j]) / 2;
        if (ham < best_ham[j]) {  // strict: the first column wins ties
          best_ham[j] = ham;
          best_idx[j] = c;
        }
      }
    }
  }

  emit_winners<QPT>(best_ham, best_idx, red_ham, red_idx, b0, B, n_dims,
                    out_idx, out_sim);
}

template <int QPT>
int launch(const void* q, const void* am_t, void* idx, void* sim, int B,
           int Dp, int C, int n_dims, bool unpack, cudaStream_t stream) {
  constexpr int BQ = TY * QPT;
  const size_t dw = (size_t)(Dp + 3) / 4;
  const size_t smem =
      unpack ? 4 * ((size_t)BQ * SD + (size_t)SD * TX + 2 * (size_t)BQ * TX)
             : 4 * (BQ * dw + dw * TX + 2 * (size_t)BQ * TX);
  auto kernel = unpack ? am_search_packed_unpack_kernel<QPT>
                       : am_search_packed_kernel<QPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + BQ - 1) / BQ;
  kernel<<<grid, TX * TY, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(am_t),
      static_cast<int32_t*>(idx), static_cast<float*>(sim), B, Dp, C,
      n_dims);
  return (int)cudaGetLastError();
}

}  // namespace

// block_b (queries per block) selects the instantiation: 4, 8, 16 or 32;
// mode 0 is popcount, 1 unpack. Returns the cudaError_t of the launch (0
// on success).
extern "C" int am_search_packed_launch(const void* q, const void* am_t,
                                       void* idx, void* sim, int B, int Dp,
                                       int C, int n_dims, int block_b,
                                       int mode, void* stream) {
  if (B <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool u = mode == 1;
  switch (block_b) {
    case 4: return launch<1>(q, am_t, idx, sim, B, Dp, C, n_dims, u, s);
    case 8: return launch<2>(q, am_t, idx, sim, B, Dp, C, n_dims, u, s);
    case 16: return launch<4>(q, am_t, idx, sim, B, Dp, C, n_dims, u, s);
    case 32: return launch<8>(q, am_t, idx, sim, B, Dp, C, n_dims, u, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
