// packed_topk.cuh: the packed-word loader and the exact top-k search of
// the hierarchical kernels: topk_kernel
// (am_shortlist.cu), and its key layout and selection (select_topk), which
// am_search_sparse.cu's tile kernel shares.
//
// topk_kernel: one block of 256 threads per query.
//   1. The query's packed bytes are staged into shared memory as
//      little-endian 32-bit words (bytes past Dp read as 0, so D = 100,
//      Dp = 13, needs no padding pass).
//   2. Every candidate slot p of the query (a super-centroid, or a column
//      of a shortlisted tile) becomes one 64-bit key
//          key = hamming << 32 | id      (INVALID = ~0 for a masked column)
//      so that ascending keys are the (-sim, id) order, sim = D - 2*hamming.
//      hamming and id are both < 2^31, so the key never overflows (the int32
//      (sim, id) key the TPU kernel avoids does). The keys live in shared
//      memory, or in a global scratch row when they do not fit.
//   3. Selection, exact at any N and k: the block counts the valid keys
//      (nv, so keff = min(k, nv)), then binary-searches the least hamming h*
//      with at least keff valid keys at or below it (about log2(8*Dp)
//      block-wide counts). Only keys with hamming <= h* can be among the
//      keff best; for each such candidate one warp counts the keys strictly
//      ahead of it by (key, slot) and, if that rank is < keff, writes it to
//      output row position rank. Ranks are unique, so every position is
//      written once and no sort or atomic is needed. Positions keff..k-1
//      get (-1, -FLT_MAX).
// Cost of step 3: O(N * log D + N * |{hamming <= h*}|) per query; for a
// small k the candidate set is k plus the ties at h*.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_topk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long INVALID = ~0ull;

// Packed bytes 4w .. 4w+3 of one column as a little-endian word; byte d
// is col[d * stride], and bytes at or past Dp read as 0 (they XOR to 0).
__device__ __forceinline__ uint32_t packed_word(const uint8_t* col,
                                                size_t stride, int w,
                                                int Dp) {
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = 4 * w + k;
    if (d < Dp) word |= (uint32_t)col[(size_t)d * stride] << (8 * k);
  }
  return word;
}

// Sum of v over the block; every thread gets it. red: WARPS shared ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // every thread has read red's previous sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += red[i];
  return total;
}

// Step 3 above. keys[0..N) complete and visible to the whole block.
__device__ inline void select_topk(const unsigned long long* keys, int N,
                                   int K, int max_ham, int n_dims, int* red,
                                   int32_t* __restrict__ out_idx,
                                   float* __restrict__ out_sim) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int nv = 0;
  for (int j = tid; j < N; j += THREADS) nv += keys[j] != INVALID;
  nv = block_sum(nv, red);
  const int keff = nv < K ? nv : K;
  for (int r = keff + tid; r < K; r += THREADS) {
    out_idx[r] = -1;
    out_sim[r] = -FLT_MAX;
  }
  if (keff == 0) return;
  int lo = 0, hi = max_ham;  // all nv valid keys have hamming <= max_ham
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    int cnt = 0;
    for (int j = tid; j < N; j += THREADS) {
      const unsigned long long kj = keys[j];
      cnt += kj != INVALID && (int)(kj >> 32) <= mid;
    }
    if (block_sum(cnt, red) >= keff) hi = mid;
    else lo = mid + 1;
  }
  const int hstar = lo;
  // base is uniform across a warp, so every lane takes every branch below.
  for (int base = warp * 32; base < N; base += THREADS) {
    const int j = base + lane;
    const unsigned long long kj = j < N ? keys[j] : INVALID;
    unsigned cand = __ballot_sync(
        FULL, kj != INVALID && (int)(kj >> 32) <= hstar);
    while (cand) {
      const int l = __ffs(cand) - 1;
      cand &= cand - 1;
      const int jj = base + l;
      const unsigned long long kk = __shfl_sync(FULL, kj, l);
      int ahead = 0;
      for (int i = lane; i < N; i += 32) {
        const unsigned long long ki = keys[i];
        ahead += ki < kk || (ki == kk && i < jj);
      }
      for (int o = 16; o > 0; o >>= 1)
        ahead += __shfl_xor_sync(FULL, ahead, o);
      if (lane == 0 && ahead < keff) {
        out_idx[ahead] = (int32_t)(kk & 0xffffffffu);
        out_sim[ahead] = (float)(n_dims - 2 * (int)(kk >> 32));
      }
    }
  }
}

// Slots: a functor with
//   __device__ int column(int b, int p, const uint8_t** col,
//                         size_t* stride) const
// giving candidate p of query b: its packed column (byte d at
// col[d * stride]); it returns the candidate's id, < 0 for a masked one.
template <class Slots>
__global__ void __launch_bounds__(THREADS)
topk_kernel(Slots slots, const uint8_t* __restrict__ q, int Dp, int N,
            int K, int n_dims, unsigned long long* scratch,
            int32_t* __restrict__ out_idx, float* __restrict__ out_sim) {
  extern __shared__ unsigned long long smem[];
  const int Dw = (Dp + 3) / 4;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned long long* keys =
      scratch != nullptr ? scratch + (size_t)b * N : smem;
  uint32_t* qs = (uint32_t*)(smem + (scratch != nullptr ? 0 : N));
  int* red = (int*)(qs + Dw);

  const uint8_t* q_row = q + (size_t)b * Dp;
  for (int w = tid; w < Dw; w += THREADS)
    qs[w] = packed_word(q_row, 1, w, Dp);
  __syncthreads();
  for (int p = tid; p < N; p += THREADS) {
    const uint8_t* col;
    size_t stride;
    const int id = slots.column(b, p, &col, &stride);
    unsigned long long key = INVALID;
    if (id >= 0) {
      int ham = 0;
      for (int w = 0; w < Dw; ++w)
        ham += __popc(qs[w] ^ packed_word(col, stride, w, Dp));
      key = (unsigned long long)ham << 32 | (uint32_t)id;
    }
    keys[p] = key;
  }
  __syncthreads();  // makes the keys, shared or global, visible to the block
  select_topk(keys, N, K, 8 * Dp, n_dims, red, out_idx + (size_t)b * K,
              out_sim + (size_t)b * K);
}

// One block per query; the keys go to shared memory unless a scratch
// buffer of (B, N) keys is given. Returns the cudaError_t of the launch.
template <class Slots>
int launch_topk(const Slots& slots, const void* q, int B, int Dp, int N,
                int K, int n_dims, void* scratch, void* idx, void* sim,
                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (N <= 0 || K <= 0 || Dp <= 0) return (int)cudaErrorInvalidValue;
  const size_t dw = (size_t)(Dp + 3) / 4;
  const size_t smem = (scratch != nullptr ? 0 : 8 * (size_t)N) + 4 * dw +
                      4 * (size_t)WARPS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<Slots>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_kernel<Slots><<<B, THREADS, smem, stream>>>(
      slots, static_cast<const uint8_t*>(q), Dp, N, K, n_dims,
      static_cast<unsigned long long*>(scratch), static_cast<int32_t*>(idx),
      static_cast<float*>(sim));
  return (int)cudaGetLastError();
}

}  // namespace packed_topk
