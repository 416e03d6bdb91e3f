// mma_rate: the issue rates of two tensor-core instructions on one GPU,
// mma.sync.m16n8k32 .s8 (the int8 routes of the search kernels) and
// mma.sync.m16n8k256 .b1 .and.popc (am_search_packed's popcount mode).
// The data sheet gives the H100's int8 peak (1,979 TOP/s) but no 1-bit
// rate; the ratio measured here sets the 1-bit peak that chip_smoke.py
// bounds popcount mode with.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu
//   ./mma_rate        # prints one JSON object
//
// Every SM runs 8 blocks of 8 warps; each warp issues 8 independent
// accumulator chains of the instruction, ITERS times. An op is one
// element of the m x n x k product counted twice (multiply and add, or
// AND and popcount add), as the int8 peak counts it.
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int ITERS = 4096, CHAINS = 8, THREADS = 256, BLOCKS_PER_SM = 8;

template <bool B1>
__global__ void issue(int* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 13 + i);
  int acc[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (B1)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
              "+r"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
              "+r"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  int s = 0;
  for (int j = 0; j < CHAINS; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the chains live
}

// Ops per second of one timed launch (after an untimed warm-up).
template <bool B1>
double ops_per_s(int* out, int blocks) {
  issue<B1><<<blocks, THREADS>>>(out, 16, 3);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  issue<B1><<<blocks, THREADS>>>(out, ITERS, 3);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  const double mmas = (double)blocks * (THREADS / 32) * ITERS * CHAINS;
  const double k = B1 ? 256 : 32;
  return mmas * 16 * 8 * k * 2 / (ms * 1e-3);
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * BLOCKS_PER_SM;
  int* out = nullptr;
  if (cudaMalloc(&out, (size_t)blocks * THREADS * sizeof(int)) != 0) {
    fprintf(stderr, "mma_rate: cudaMalloc failed\n");
    return 1;
  }
  double s8 = 0, b1 = 0;
  for (int rep = 0; rep < 3; ++rep) {  // the best of three of each
    const double r8 = ops_per_s<false>(out, blocks);
    const double r1 = ops_per_s<true>(out, blocks);
    s8 = r8 > s8 ? r8 : s8;
    b1 = r1 > b1 ? r1 : b1;
  }
  const cudaError_t err = cudaGetLastError();
  cudaFree(out);
  if (err != cudaSuccess) {
    fprintf(stderr, "mma_rate: %s\n", cudaGetErrorString(err));
    return 1;
  }
  printf("{\"s8_m16n8k32_ops_per_s\": %.6e, "
         "\"b1_m16n8k256_and_popc_ops_per_s\": %.6e, \"b1_over_s8\": %.6f}\n",
         s8, b1, b1 / s8);
  return 0;
}
