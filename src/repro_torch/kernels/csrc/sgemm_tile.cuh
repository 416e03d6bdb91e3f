// sgemm_tile.cuh: the true-fp32 product mainloop shared by binary_mvm.cu,
// encode_pack.cu, am_search_imc.cu and am_search.cu (search_pass.cuh).
//
// Computes one BM x BN tile of H = x @ w, x (B, K) and w (K, N) row major,
// for the TPU kernels src/repro/kernels/binary_mvm.py: binary_mvm and
// src/repro/kernels/encode_fused.py: encode_pack (128 x 128 MXU tiles
// accumulating across K in VMEM); and, with w read k-major and the K walk
// cut into ADC slabs (tile_k_slabs, at the end), the fp32 route of
// am_search_imc and (one slab of D) am_search.
//
// Bound on the H100: operations. 2*B*K*N fp32 FMA terms at 67 TFLOP/s
// (1.64 GFLOP, 24.5 us at B = 1024, K = 784, N = 1024), against 10.4 MB of
// bytes (3.1 us). The features are float, so the products cannot go to
// TF32 or bf16 tensor cores without changing results (and encode_pack's
// sign bits).
//
// Design. Thread (tr = tid / (BN/8), tc = tid % (BN/8)) owns rows
// m0 + TM*tr .. + TM-1 and the 8 consecutive columns n0 + 8tc .. + 7 (one
// packed byte of encode_pack's epilogue), and accumulates each output with
// one __fmaf_rn per term in increasing k: no TF32, no split-K, so the sums
// are bit for bit those of a sequential fp32 loop.
// * K runs in steps of BK (16 or 32) through a ring of NST = 3
//   shared-memory stages filled by cp.async: the copies of steps k+1 and
//   k+2 are in flight while step k's FMAs run, with one barrier per step.
// * The A tile is kept row major, so each 16-byte copy lands as it is read
//   and the FMA loop reads A as float4 along k; its 16-byte chunks are
//   XOR-swizzled by row group, so the 4 row groups of a warp hit 4
//   distinct bank groups (rows padded by 16 bytes would collide 2 or 4
//   ways). The B tile's row stores each thread's two float4 halves BN/2
//   floats apart, so 8 neighbouring threads read 128 contiguous bytes.
// * Fragments are double-buffered in registers: k+1's B (and A every 4 k)
//   is read before k's FMAs issue.
// * Rows past B, k past K and columns past N load as zero (cp.async with a
//   0-byte source). An operand whose base or row stride is not 16-byte
//   aligned (K or N not a multiple of 4, or a view that starts off a
//   16-byte boundary) takes the same ring with 4-byte copies (VEC =
//   false), chosen by the launcher.
// The shared-memory reads set the pace: at 8 x 8 outputs per thread each
// FMA needs 1 byte from shared memory (4 x 8 outputs: 1.5), and an SM
// delivers 128 bytes per clock against 128 fp32 FMAs per clock.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int NST = 3;  // ring stages

template <int BM_, int BN_, int TM_, int NT_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, NT = NT_, BK = BK_;
  static constexpr int COLS = BN / 8;  // column groups: one byte each
  static constexpr int KC = BK / 4;    // 16-byte chunks of an A row
  static_assert((BM / TM) * COLS == NT, "threads must cover the tile");
  static_assert(COLS % 8 == 0, "8 neighbouring threads share a row group");
  static_assert(KC == 4 || KC == 8, "BK is 16 or 32");
  static constexpr int A_FLOATS = BM * BK;
  static constexpr int STAGE = A_FLOATS + BK * BN;  // floats per stage
  static constexpr size_t SMEM = sizeof(float) * NST * STAGE;
  static_assert((BM * BK / 4) % NT == 0 && (BK * BN / 4) % NT == 0,
                "16-byte copies divide among the threads");
  // Float offset of chunk kc (k = 4kc .. 4kc + 3) of A row `row`: the
  // chunk index is XOR-swizzled by the row's thread group.
  static __device__ __forceinline__ int a_off(int row, int kc) {
    return row * BK + 4 * (kc ^ ((row / TM) & (KC - 1)));
  }
};

// The tile shapes the wrappers may choose (binary_mvm.SGEMM_TILES).
using T0 = Tile<128, 64, 4, 256, 32>;
using T1 = Tile<64, 64, 4, 128, 32>;
using T2 = Tile<128, 128, 8, 256, 32>;
using T3 = Tile<64, 64, 8, 64, 16>;

// Launches f(Tile{}) for the launchers' tile index (binary_mvm.SGEMM_TILES).
template <class F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(T0{});
    case 1: return f(T1{});
    case 2: return f(T2{});
    case 3: return f(T3{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;  // 0: fill the destination with zeros
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

// One K step (k0 .. k0 + BK) of x (B, K) into the stage's A tile.
template <class TL, bool VEC>
__device__ __forceinline__ void load_a(const float* __restrict__ x, int B,
                                       int K, int m0, int k0, float* As) {
  constexpr int BK = TL::BK;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < TL::BM * BK / 4 / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int row = e / (BK / 4), kc = e % (BK / 4);
      const int gr = m0 + row, gk = k0 + 4 * kc;
      const bool ok = gr < B && gk < K;  // K % 4 == 0: whole chunks
      cp_async(As + TL::a_off(row, kc), ok ? x + (size_t)gr * K + gk : x, 16,
               ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < TL::BM * BK / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int row = e / BK, kk = e % BK;
      const int gr = m0 + row, gk = k0 + kk;
      const bool ok = gr < B && gk < K;
      cp_async(As + TL::a_off(row, kk >> 2) + (kk & 3),
               ok ? x + (size_t)gr * K + gk : x, 4, ok);
    }
  }
}

// One K step (k0 .. k0 + BK) of x and w into a stage.
template <class TL, bool VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int B, int K, int N, int m0,
                                           int n0, int k0, float* stage) {
  constexpr int BK = TL::BK;
  float* Bs = stage + TL::A_FLOATS;
  const int tid = threadIdx.x;
  load_a<TL, VEC>(x, B, K, m0, k0, stage);
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BK * TL::BN / 4 / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int kk = e / (TL::BN / 4), c4 = e % (TL::BN / 4);
      const int gk = k0 + kk, gc = n0 + 4 * c4;
      const bool ok = gk < K && gc < N;  // N % 4 == 0: whole chunks
      cp_async(Bs + kk * TL::BN + (c4 & 1) * (TL::BN / 2) + 4 * (c4 >> 1),
               ok ? w + (size_t)gk * N + gc : w, 16, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BK * TL::BN / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int kk = e / TL::BN, col = e % TL::BN;
      const int gk = k0 + kk, gc = n0 + col;
      const bool ok = gk < K && gc < N;
      const int c4 = col >> 2;
      cp_async(Bs + kk * TL::BN + (c4 & 1) * (TL::BN / 2) + 4 * (c4 >> 1) +
                   (col & 3),
               ok ? w + (size_t)gk * N + gc : w, 4, ok);
    }
  }
}

// acc[r][c] = H[m0 + TM*tr + r][n0 + 8tc + c], summed in increasing k.
// smem: NST * TL::STAGE floats, 16-byte aligned.
template <class TL, bool VEC>
__device__ __forceinline__ void tile(const float* __restrict__ x,
                                     const float* __restrict__ w, int B,
                                     int K, int N, int m0, int n0,
                                     float* smem, float (&acc)[TL::TM][8]) {
  const int tid = threadIdx.x;
  const int tc = tid % TL::COLS, tr = tid / TL::COLS;
#pragma unroll
  for (int r = 0; r < TL::TM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  constexpr int BK = TL::BK;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk)
      load_stage<TL, VEC>(x, w, B, K, N, m0, n0, s * BK,
                          smem + s * TL::STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2));
    __syncthreads();  // step kt landed; step kt - 1's stage is free
    const int nx = kt + NST - 1;
    if (nx < nk)
      load_stage<TL, VEC>(x, w, B, K, N, m0, n0, nx * BK,
                          smem + (nx % NST) * TL::STAGE);
    asm volatile("cp.async.commit_group;\n" ::);

    const float* As = smem + (kt % NST) * TL::STAGE;
    const float* Bs = smem + (kt % NST) * TL::STAGE + TL::A_FLOATS + 4 * tc;
    // Fragments in two register buffers: k + 1's B (and, every 4 k, its
    // A) are read from shared memory before k's FMAs issue.
    float4 a[2][TL::TM], b[2][2];
    auto load_a = [&](float4 (&dst)[TL::TM], int k4) {
#pragma unroll
      for (int r = 0; r < TL::TM; ++r)
        dst[r] = *reinterpret_cast<const float4*>(
            As + TL::a_off(TL::TM * tr + r, k4));
    };
    auto load_b = [&](float4 (&dst)[2], int k) {
      dst[0] = *reinterpret_cast<const float4*>(Bs + k * TL::BN);
      dst[1] = *reinterpret_cast<const float4*>(Bs + k * TL::BN + TL::BN / 2);
    };
    load_a(a[0], 0);
    load_b(b[0], 0);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if (k + 1 < BK) {
        load_b(b[(k + 1) & 1], k + 1);
        if ((k + 1) % 4 == 0) load_a(a[((k + 1) / 4) & 1], (k + 1) / 4);
      }
      const int ka = (k / 4) & 1, kb = k & 1;
      const float bv[8] = {b[kb][0].x, b[kb][0].y, b[kb][0].z, b[kb][0].w,
                           b[kb][1].x, b[kb][1].y, b[kb][1].z, b[kb][1].w};
#pragma unroll
      for (int r = 0; r < TL::TM; ++r) {
        const float av = k % 4 == 0   ? a[ka][r].x
                         : k % 4 == 1 ? a[ka][r].y
                         : k % 4 == 2 ? a[ka][r].z
                                      : a[ka][r].w;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = __fmaf_rn(av, bv[c], acc[r][c]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Whether 16-byte copies can serve x (B, K) and w (K, N).
inline bool vec_ok(const void* x, const void* w, int K, int N) {
  return K % 4 == 0 && N % 4 == 0 &&
         (((uintptr_t)x | (uintptr_t)w) & 15) == 0;
}

// -- k-major B with slab closes (search_pass.cuh's fp32 route) -------------
//
// Here w is read as N rows of K: element (k, n) at w[n * sn + k * sk],
// the transposed view of a (C, D) AM (sk = 1, sn = D) with no copy. Both
// operands are then k-contiguous, and the B tile is kept like the A tile:
// a BK-float row per column, its 16-byte chunks XOR-swizzled by the
// column (col % 8 at BK = 32, (col / 2) % 4 at BK = 16). Thread (tr, tc)
// owns rows TM*tr .. + TM-1 and the strided columns tc + COLS*c (c < 8),
// so the 8 threads of a quarter-warp read 8 neighbouring columns, which
// the swizzle puts in 8 distinct bank groups (the A reads of a
// quarter-warp are one broadcast). Each 4-dim chunk feeds TM*8*4 FMAs
// from TM + 8 float4 reads.
// The K walk is cut into slabs of tile_rows: a step that a slab boundary
// cuts runs its dims one by one up to the boundary, calls close(acc, g)
// with the slab's partials (summed from 0, one __fmaf_rn per term in
// increasing k, never TF32), which must zero them, and goes on.

template <class TL>
__device__ __forceinline__ int bk_off(int col, int kc) {
  static_assert(TL::COLS == 8, "a quarter-warp reads 8 neighbouring columns");
  return col * TL::BK +
         4 * (kc ^ (TL::KC == 8 ? col & 7 : (col >> 1) & (TL::KC - 1)));
}

template <class TL, bool VA, bool VB>
__device__ __forceinline__ void load_stage_k(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             long long sn, long long sk,
                                             int B, int K, int N, int m0,
                                             int n0, int k0, float* stage) {
  constexpr int BK = TL::BK;
  float* Bs = stage + TL::A_FLOATS;
  const int tid = threadIdx.x;
  load_a<TL, VA>(x, B, K, m0, k0, stage);
  if (VB) {  // sk == 1, K % 4 == 0
#pragma unroll
    for (int i = 0; i < TL::BN * BK / 4 / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int col = e / (BK / 4), kc = e % (BK / 4);
      const int gc = n0 + col, gk = k0 + 4 * kc;
      const bool ok = gc < N && gk < K;
      cp_async(Bs + bk_off<TL>(col, kc), ok ? w + gc * sn + gk : w, 16, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < TL::BN * BK / TL::NT; ++i) {
      const int e = tid + TL::NT * i;
      const int col = e / BK, kk = e % BK;
      const int gc = n0 + col, gk = k0 + kk;
      const bool ok = gc < N && gk < K;
      cp_async(Bs + bk_off<TL>(col, kk >> 2) + (kk & 3),
               ok ? w + gc * sn + gk * sk : w, 4, ok);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The slab walk of the (BM x BN) tile at (m0, n0) of x @ w^T over slabs
// [g*tile_rows, min((g+1)*tile_rows, K)): close(acc, g) at each slab's
// end. smem: NST * TL::STAGE floats, 16-byte aligned.
template <class TL, bool VA, bool VB, class Close>
__device__ __forceinline__ void tile_k_slabs(const float* __restrict__ x,
                             const float* __restrict__ w, long long sn,
                             long long sk, int B, int K, int N, int m0,
                             int n0, int tile_rows, float* smem,
                             Close&& close) {
  constexpr int BK = TL::BK, TM = TL::TM;
  const int tid = threadIdx.x;
  const int tc = tid % TL::COLS, tr = tid / TL::COLS;
  float acc[TM][8];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int gd = (K + tile_rows - 1) / tile_rows;
  int g = 0, end = min(tile_rows, K);
  auto next = [&]() {
    close(acc, g);
    ++g;
    end = g < gd ? min((g + 1) * tile_rows, K) : INT_MAX;
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk)
      load_stage_k<TL, VA, VB>(x, w, sn, sk, B, K, N, m0, n0, s * BK,
                               smem + s * TL::STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2));
    __syncthreads();  // step kt landed; step kt - 1's stage is free
    const int nx = kt + NST - 1;
    if (nx < nk)
      load_stage_k<TL, VA, VB>(x, w, sn, sk, B, K, N, m0, n0, nx * BK,
                               smem + (nx % NST) * TL::STAGE);
    asm volatile("cp.async.commit_group;\n" ::);

    const float* As = smem + (kt % NST) * TL::STAGE;
    const float* Bs = As + TL::A_FLOATS;
    const int k0 = kt * BK;
    if (end >= k0 + BK) {  // no boundary inside the step: 4 k a chunk
#pragma unroll
      for (int kc = 0; kc < TL::KC; ++kc) {
        float4 a[TM], b[8];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          a[r] = *reinterpret_cast<const float4*>(
              As + TL::a_off(TM * tr + r, kc));
#pragma unroll
        for (int c = 0; c < 8; ++c)
          b[c] = *reinterpret_cast<const float4*>(
              Bs + bk_off<TL>(tc + TL::COLS * c, kc));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] =
                  __fmaf_rn(lane_of(a[r], i), lane_of(b[c], i), acc[r][c]);
      }
      if (end == k0 + BK) next();
      continue;
    }
    for (int lo = 0; lo < BK;) {  // a slab ends inside the step
      const int hi = min(BK, end - k0);
#pragma unroll 1
      for (int kk = lo; kk < hi; ++kk) {
        float a[TM], b[8];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          a[r] = As[TL::a_off(TM * tr + r, kk >> 2) + (kk & 3)];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          b[c] = Bs[bk_off<TL>(tc + TL::COLS * c, kk >> 2) + (kk & 3)];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
      }
      lo = hi;
      if (k0 + hi == end) next();
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace sgemm
