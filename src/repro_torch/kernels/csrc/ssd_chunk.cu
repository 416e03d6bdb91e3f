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
// Bound on the H100: operations. The function needs the causal triangle
// (Q(Q+1)/2 entries) of C B^T and of its product with x dt, plus C S and
// the state update: Q(Q+1)(N + P) + 4QNP per (b, h), 6.3 MFLOP at
// hymba-1.5b's chunk (Q = 256, N = 16, P = 64), 2.5 GFLOP at B = 8 (400
// pairs), 0.038 ms at the 67 TFLOP/s float32 rate, against ~33 MB of
// operands (0.010 ms).
// Every product is a float32 FMA: no TF32 and no tensor cores.
//
// Design. One block of 256 threads (16 x 16) per (head, batch row). At
// Q = 256 the (Q, Q) decay and C B^T matrices take 256 KB each in float32,
// more than a block's shared memory, so the kernel streams them:
// * cum (Q) and dt (Q) are computed once (a block scan) and stay in shared
//   memory, as does the entering state S (N x P <= 64 KB);
// * the query rows go in tiles of 64. For a row tile the C tile (64 x N)
//   is staged, the inter-chunk term (C S) e^cum starts each thread's
//   4 x (P/16) accumulator, and then, for each key tile of 64 up to the
//   tile's last row, the B and x dt tiles are staged, the 64 x 64 strip
//   (C B^T) o decay is formed (causal: keys after the row are 0) and
//   multiplied into the accumulator;
// * the state pass streams the B and x dt tiles once more (per 64 rows of
//   N) and accumulates S' in registers.
// At N = 128 (mamba2) the B and C tiles stream the same way; shared
// memory is 48 KB at hymba's shape and 134 KB at mamba2's. Any Q >= 1,
// N and P up to 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TPB = 256;  // 16 x 16 threads
constexpr int R = 64;     // query rows per tile: 4 per thread row
constexpr int KT = 64;    // keys per tile: 4 per thread column
constexpr int GS = KT + 1;  // padded row stride of the strip
constexpr size_t MAX_SMEM = 232448;  // bytes a block may opt into

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* da;
  const float* state;
  void* y;
  float* s_new;
  int Q, H, N, P;
  long long sx, sb, sc, sdt, sda;
};

size_t smem_bytes(int Q, int N, int P) {
  const size_t ns = N + 1;
  return sizeof(float) * (2 * (size_t)Q + (size_t)N * P + R * ns + KT * ns +
                          (size_t)KT * P + (size_t)R * GS);
}

// Shared memory (floats): cum [Q], dts [Q], S0 [N][P], Cs [R][N + 1],
// Bs [KT][N + 1] (padded rows: conflict-free strip products), Xs [KT][P]
// (x * dt), Gs [R][KT + 1].
// CP: column groups of 16 per thread, P <= 16 * CP.
template <typename T, int CP>
__global__ void __launch_bounds__(TPB) ssd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[TPB / 32];
  const int h = blockIdx.x, bb = blockIdx.y;
  const int Q = a.Q, H = a.H, N = a.N, P = a.P, NS = N + 1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* cum = smem;
  float* dts = cum + Q;
  float* S0 = dts + Q;
  float* Cs = S0 + N * P;
  float* Bs = Cs + R * NS;
  float* Xs = Bs + KT * NS;
  float* Gs = Xs + KT * P;

  const T* x = static_cast<const T*>(a.x) + bb * a.sx;
  const T* bm = static_cast<const T*>(a.b) + bb * a.sb;
  const T* cm = static_cast<const T*>(a.c) + bb * a.sc;
  const float* dt = a.dt + bb * a.sdt;
  const float* da = a.da + bb * a.sda;

  // cum = inclusive prefix sum of da (warp scans, then warp totals).
  float carry = 0.f;
  for (int base = 0; base < Q; base += TPB) {
    const int j = base + tid;
    float v = 0.f;
    if (j < Q) {
      v = da[(size_t)j * H + h];
      dts[j] = dt[(size_t)j * H + h];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(~0u, v, o);
      if ((tid & 31) >= o) v += u;
    }
    if ((tid & 31) == 31) warp_tot[tid >> 5] = v;
    __syncthreads();
    float off = carry, tot = 0.f;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) {
      if (w < (tid >> 5)) off += warp_tot[w];
      tot += warp_tot[w];
    }
    if (j < Q) cum[j] = v + off;
    carry += tot;
    __syncthreads();
  }
  const float* st = a.state + ((size_t)bb * H + h) * N * P;
  for (int i = tid; i < N * P; i += TPB) S0[i] = st[i];
  __syncthreads();
  const float total = cum[Q - 1];

  // Stage keys [j0, j0 + KT) of B (times w(j), 1 or e^{total - cum_j})
  // and of x * dt; keys past Q are zero.
  auto stage_keys = [&](int j0, bool state_weights) {
    for (int i = tid; i < KT * N; i += TPB) {
      const int k = i / N, n = i - k * N, j = j0 + k;
      float bv = 0.f;
      if (j < Q) {
        bv = to_f32(bm[((size_t)j * H + h) * N + n]);
        if (state_weights) bv *= expf(total - cum[j]);
      }
      Bs[k * NS + n] = bv;
    }
    for (int i = tid; i < KT * P; i += TPB) {
      const int k = i / P, p = i - k * P, j = j0 + k;
      Xs[k * P + p] = j < Q ? to_f32(x[((size_t)j * H + h) * P + p]) * dts[j]
                            : 0.f;
    }
  };

  // y, one tile of R query rows at a time.
  for (int i0 = 0; i0 < Q; i0 += R) {
    for (int i = tid; i < R * N; i += TPB) {
      const int r = i / N, n = i - r * N, row = i0 + r;
      Cs[r * NS + n] =
          row < Q ? to_f32(cm[((size_t)row * H + h) * N + n]) : 0.f;
    }
    __syncthreads();
    float acc[4][CP];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;
    // Inter-chunk term: (C_i . S) e^{cum_i}.
    for (int n = 0; n < N; ++n) {
      float cv[4], sv[CP];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int col = tx + 16 * c;
        sv[c] = col < P ? S0[n * P + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + ty + 16 * r;
      const float e = row < Q ? expf(cum[row]) : 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[r][c] *= e;
    }
    // Intra-chunk term over the key tiles up to the tile's last row.
    const int i_end = min(i0 + R, Q);
    for (int j0 = 0; j0 < i_end; j0 += KT) {
      stage_keys(j0, false);
      __syncthreads();
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = i0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = j0 + tx + 16 * c;
          Gs[(ty + 16 * r) * GS + tx + 16 * c] =
              (key <= row && row < Q) ? g[r][c] * expf(cum[row] - cum[key])
                                      : 0.f;
        }
      }
      __syncthreads();
      const int kmax = min(KT, i_end - j0);
      for (int k = 0; k < kmax; ++k) {
        float gv[4], xv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Gs[(ty + 16 * r) * GS + k];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int col = tx + 16 * c;
          xv[c] = col < P ? Xs[k * P + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            acc[r][c] = fmaf(gv[r], xv[c], acc[r][c]);
      }
      __syncthreads();
    }
    T* y = static_cast<T*>(a.y);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + ty + 16 * r;
      if (row >= Q) continue;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int col = tx + 16 * c;
        if (col < P)
          store(y + (((size_t)bb * Q + row) * H + h) * P + col, acc[r][c]);
      }
    }
  }

  // The state leaving the chunk, 64 rows of N at a time.
  const float e_total = expf(total);
  float* s_out = a.s_new + ((size_t)bb * H + h) * N * P;
  for (int n0 = 0; n0 < N; n0 += 64) {
    float sacc[4][CP];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int col = tx + 16 * c;
        sacc[r][c] = (n < N && col < P) ? S0[n * P + col] * e_total : 0.f;
      }
    }
    for (int j0 = 0; j0 < Q; j0 += KT) {
      stage_keys(j0, true);
      __syncthreads();
      const int kmax = min(KT, Q - j0);
      for (int k = 0; k < kmax; ++k) {
        float bv[4], xv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + ty + 16 * r;
          bv[r] = n < N ? Bs[k * NS + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int col = tx + 16 * c;
          xv[c] = col < P ? Xs[k * P + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            sacc[r][c] = fmaf(bv[r], xv[c], sacc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int col = tx + 16 * c;
        if (col < P) s_out[n * P + col] = sacc[r][c];
      }
    }
  }
}

template <typename T, int CP>
cudaError_t launch_t(const Args& a, int B, size_t smem, cudaStream_t st) {
  auto kern = ssd_chunk_kernel<T, CP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.H, B), TPB, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const Args& a, int B, size_t smem, cudaStream_t st) {
  if (a.P <= 16) return launch_t<T, 1>(a, B, smem, st);
  if (a.P <= 32) return launch_t<T, 2>(a, B, smem, st);
  if (a.P <= 64) return launch_t<T, 4>(a, B, smem, st);
  return launch_t<T, 8>(a, B, smem, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_chunk_launch(const void* x, const void* b, const void* c,
                                const void* dt, const void* da,
                                const void* state, void* y, void* s_new,
                                int B, int Q, int H, int N, int P,
                                long long sx, long long sb, long long sc,
                                long long sdt, long long sda, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || Q <= 0) return 0;
  if (N < 1 || N > 128 || P < 1 || P > 128 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, N, P);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Args a{x, b, c, static_cast<const float*>(dt),
               static_cast<const float*>(da), static_cast<const float*>(state),
               y, static_cast<float*>(s_new), Q, H, N, P, sx, sb, sc, sdt,
               sda};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_cols<float>(a, B, smem, st)
                          : launch_cols<__nv_bfloat16>(a, B, smem, st));
}
