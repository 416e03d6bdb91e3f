// pack_bits: (R, C) float32 +-1 -> (R, C/8) uint8, LSB-first, bit 1 iff x > 0.
// unpack_bits: the inverse, (R, C/8) uint8 -> (R, C) float32 {-1, +1}.
//
// Replaces the TPU kernel src/repro/kernels/pack_bits.py:pack_bits, and
// its inverse :unpack_bits (Pallas grids of (block_r, 1024)-lane VPU
// tiles).
//
// Bound on the H100: bytes. The pass reads 32 bytes and writes 1 byte per
// output byte and does a handful of compares, so its least time is
// (4*R*C + R*C/8) bytes over the 3.35 TB/s of HBM3 — 1.3 us for the
// staged serving batch at R = C = 1024.
//
// Design: with C % 8 == 0 a row-major (R, C) array packs as a flat 1-D
// map — output byte i reads inputs 8i .. 8i+7 — so the kernel ignores
// rows and tiles altogether. One thread per output byte issues two
// 16-byte loads (a warp reads 1 KB contiguous) and one byte store; a
// grid-stride loop bounds the grid. The wrapper checks the 16-byte
// alignment the vector loads need.
//
// unpack_bits is the same flat map run backwards: one thread per input
// byte writes its 8 cells as two 16-byte stores (a warp writes 1 KB
// contiguous). Bound: bytes, 33 per input byte — 1.3 us for the
// (1024, 128) -> (1024, 1024) unpack of a 1024 x 1024 AM, dominated by
// the 4 MB written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
pack_bits_kernel(const float4* __restrict__ x, uint8_t* __restrict__ out,
                 long long n_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n_out; i += stride) {
    const float4 a = x[2 * i];
    const float4 b = x[2 * i + 1];
    const unsigned v = (unsigned)(a.x > 0.f) | ((unsigned)(a.y > 0.f) << 1) |
                       ((unsigned)(a.z > 0.f) << 2) |
                       ((unsigned)(a.w > 0.f) << 3) |
                       ((unsigned)(b.x > 0.f) << 4) |
                       ((unsigned)(b.y > 0.f) << 5) |
                       ((unsigned)(b.z > 0.f) << 6) |
                       ((unsigned)(b.w > 0.f) << 7);
    out[i] = (uint8_t)v;
  }
}

__global__ void __launch_bounds__(256)
unpack_bits_kernel(const uint8_t* __restrict__ in, float4* __restrict__ out,
                   long long n_in) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n_in; i += stride) {
    const unsigned v = in[i];
    float c[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) c[b] = ((v >> b) & 1u) ? 1.f : -1.f;
    out[2 * i] = make_float4(c[0], c[1], c[2], c[3]);
    out[2 * i + 1] = make_float4(c[4], c[5], c[6], c[7]);
  }
}

long long grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return blocks > 132 * 16 ? 132 * 16 : blocks;  // grid-stride beyond this
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int pack_bits_launch(const void* x, void* out, long long n_out,
                                void* stream) {
  if (n_out <= 0) return 0;
  pack_bits_kernel<<<(unsigned)grid_for(n_out, 256), 256, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const float4*>(x), static_cast<uint8_t*>(out), n_out);
  return (int)cudaGetLastError();
}

// out: (n_in * 8) float32, 16-byte aligned. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int unpack_bits_launch(const void* packed, void* out,
                                  long long n_in, void* stream) {
  if (n_in <= 0) return 0;
  unpack_bits_kernel<<<(unsigned)grid_for(n_in, 256), 256, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<float4*>(out), n_in);
  return (int)cudaGetLastError();
}
