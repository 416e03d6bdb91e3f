// qail_update: one QAIL minibatch (§III-C steps 1-3) — sims against the
// binary AM, Eq.-(4) / Eq.-(5) target selection, the miss mask, and the
// Eq.-(6) delta W^T @ upd with W[i] = lr*mis_i*(onehot(true_i) -
// onehot(pred_i)).
//
//   q       (B, D) float32  binarized queries H^b
//   upd     (B, D) float32  Eq.-(6) payload (encoded H or H^b)
//   am_t    (D, C) float32  ±1 transposed binary AM, element strides
//                           (sd, sc) (the transposed view of (C, D))
//   owners  (C,)   int32    centroid ownership
//   labels  (B,)   int32    true class (-1 on padded rows)
//   mask    (B,)   float32  {0, 1} row validity
//   delta   (C, D) float32  out: the Eq.-(6) increment of the float AM
//   n_miss  ()     float32  out: sum of mis
//   pred_t, true_t (B,) int32, mis (B,) float32: out, the targets
//
// Replaces the TPU kernel src/repro/kernels/qail_update.py: qail_update
// (a Pallas grid over query blocks with the AM, the payload and the
// (C, D) delta accumulator resident in VMEM; the delta is the MXU product
// W^T @ upd, accumulated across the sequential grid).
//
// Bound on the H100: operations. At the training shape B = 256,
// D = C = 1024 the sims are 2*B*C*D = 0.537 GFLOP of fp32 FMA (8.0 us at
// 67 TFLOP/s); the bytes are ~10.5 MB (q, upd, am_t in, delta out), 3.1 us.
// The delta has at most 2 nonzero W entries per row, so it costs bytes,
// not operations.
//
// Design. Three launches on one stream, no atomics anywhere, so two runs
// give the same delta bit for bit:
// * Phase A1 (sims_argmax.cuh): each (block_b-query, 64-column) tile of
//   sims (block_b = 16, 32 or 64; the result does not depend on it) is
//   computed exactly in fp32 and folded twice per row — over all columns
//   (Eq. 4) and over the columns the row's label owns (Eq. 5) — into two
//   (B, C/64) partial buffers.
// * Phase A2: one thread per row folds the partials in column-tile order
//   (first-wins, as torch.argmax) into pred_t, true_t (0 when the label
//   owns no column: argmax over an all-float32-min row) and
//   mis = (owners[pred_t] != label) * mask.
// * Phase B: each block owns a (32-centroid, 256-dim) tile of delta and
//   walks the B rows in order; a row adds to the tile only if it missed
//   and one of its two targets lies in the tile (a block-uniform test).
//   Every delta element is summed by one thread in row order, and each
//   term is rounded as the plain version's (lr*mis)*(±1) * upd: one fp32
//   product, then one fp32 add (__fmul_rn / __fadd_rn, never contracted
//   into an FMA). When pred_t == true_t the two one-hots cancel and the
//   row adds nothing, as W's zero entry does. The same block (0, 0) sums
//   mis in row order into n_miss.
#include "sims_argmax.cuh"

namespace {

constexpr int DT = 256;  // delta dims per block (one per thread)
constexpr int CT = 32;   // delta centroids per block (registers/thread)

// TM queries per thread: (16 * TM)-query tiles.
template <int TM>
__global__ void __launch_bounds__(sims::TPB)
qail_targets_partial(const float* __restrict__ q,
                     const float* __restrict__ am_t, long long sd,
                     long long sc, const int32_t* __restrict__ owners,
                     const int32_t* __restrict__ labels,
                     float* __restrict__ part_s, int* __restrict__ part_i,
                     int B, int D, int C) {
  __shared__ float qs[sims::BK][16 * TM + 1];
  __shared__ float as[sims::BK][sims::BN + 1];
  __shared__ float red_s[16 * TM * 16];
  __shared__ int red_i[16 * TM * 16];
  float acc[TM][sims::TN];
  const int row0 = blockIdx.y * 16 * TM, col0 = blockIdx.x * sims::BN;
  const int n_ct = gridDim.x;
  const size_t half = (size_t)B * n_ct;  // global partials, then owned
  sims::tile<TM>(q, am_t, sd, sc, B, D, C, row0, col0, qs, as, acc);
  sims::fold_tile<TM>(acc, row0, col0, B, C, sims::AnyColumn{}, red_s,
                      red_i, part_s, part_i, n_ct, blockIdx.x);
  sims::fold_tile<TM>(acc, row0, col0, B, C,
                      sims::OwnedColumn{owners, labels}, red_s, red_i,
                      part_s + half, part_i + half, n_ct, blockIdx.x);
}

__global__ void qail_targets_fold(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int n_ct,
                                  const int32_t* __restrict__ owners,
                                  const int32_t* __restrict__ labels,
                                  const float* __restrict__ mask, int B,
                                  int32_t* __restrict__ pred_t,
                                  int32_t* __restrict__ true_t,
                                  float* __restrict__ mis) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t half = (size_t)B * n_ct;
  float bs;
  int pred, tru;
  sims::fold_partials(part_s, part_i, n_ct, b, bs, pred);
  sims::fold_partials(part_s + half, part_i + half, n_ct, b, bs, tru);
  if (tru == INT_MAX) tru = 0;  // the label owns no centroid
  pred_t[b] = pred;
  true_t[b] = tru;
  mis[b] = (float)(owners[pred] != labels[b]) * mask[b];
}

__global__ void __launch_bounds__(DT)
qail_delta(const float* __restrict__ upd, const int32_t* __restrict__ pred_t,
           const int32_t* __restrict__ true_t, const float* __restrict__ mis,
           float lr, int B, int D, int C, float* __restrict__ delta,
           float* __restrict__ n_miss) {
  const int d = blockIdx.x * DT + threadIdx.x;
  const int c0 = blockIdx.y * CT;
  float acc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) acc[j] = 0.0f;
  for (int i = 0; i < B; ++i) {
    const float m = mis[i];
    if (m == 0.0f) continue;  // W's row is zero
    const int t = true_t[i], p = pred_t[i];
    if ((t < c0 || t >= c0 + CT) && (p < c0 || p >= c0 + CT)) continue;
    const float w = __fmul_rn(lr, m);  // lr * mis_i, as the plain version
    const float u = d < D ? upd[(size_t)i * D + d] : 0.0f;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float coef = (float)(t == c0 + j) - (float)(p == c0 + j);
      if (coef != 0.0f)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(w, coef), u));
    }
  }
  if (d < D) {
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (c0 + j < C) delta[(size_t)(c0 + j) * D + d] = acc[j];
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < B; ++i) s = __fadd_rn(s, mis[i]);
    *n_miss = s;
  }
}

}  // namespace

// part_s / part_i: (2, B, ceil(C/64)) scratch from the caller; block_b is
// the query tile of the sims pass (16, 32 or 64). Returns the cudaError_t
// of the launches (0 on success).
extern "C" int qail_update_launch(const void* q, const void* upd,
                                  const void* am_t, long long sd,
                                  long long sc, const void* owners,
                                  const void* labels, const void* mask,
                                  float lr, void* part_s, void* part_i,
                                  void* pred_t, void* true_t, void* mis,
                                  void* delta, void* n_miss, int B, int D,
                                  int C, int block_b, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  decltype(&qail_targets_partial<1>) partial;
  switch (block_b) {
    case 16: partial = qail_targets_partial<1>; break;
    case 32: partial = qail_targets_partial<2>; break;
    case 64: partial = qail_targets_partial<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int n_ct = (C + sims::BN - 1) / sims::BN;
  const int n_rt = (B + block_b - 1) / block_b;
  const int n_dt = (D + DT - 1) / DT, n_cb = (C + CT - 1) / CT;
  if (n_rt > 65535 || n_cb > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    partial<<<dim3(n_ct, n_rt), sims::TPB, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(am_t), sd,
        sc, static_cast<const int32_t*>(owners),
        static_cast<const int32_t*>(labels), static_cast<float*>(part_s),
        static_cast<int*>(part_i), B, D, C);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    qail_targets_fold<<<(B + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i),
        n_ct, static_cast<const int32_t*>(owners),
        static_cast<const int32_t*>(labels),
        static_cast<const float*>(mask), B, static_cast<int32_t*>(pred_t),
        static_cast<int32_t*>(true_t), static_cast<float*>(mis));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  qail_delta<<<dim3(n_dt, n_cb), DT, 0, s>>>(
      static_cast<const float*>(upd), static_cast<const int32_t*>(pred_t),
      static_cast<const int32_t*>(true_t), static_cast<const float*>(mis),
      lr, B, D, C, static_cast<float*>(delta), static_cast<float*>(n_miss));
  return (int)cudaGetLastError();
}
