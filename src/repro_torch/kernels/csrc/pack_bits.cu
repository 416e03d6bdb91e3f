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
// staged serving batch at R = C = 1024. unpack_bits moves the same bytes
// the other way (33 per input byte, dominated by the 4 MB it writes at
// R = C = 1024).
//
// With C % 8 == 0 a row-major (R, C) array packs as a flat 1-D map —
// output byte i reads inputs 8i .. 8i+7 — so both kernels ignore rows and
// work on chunks of the flat arrays: 1024 floats <-> 128 bytes, one warp a
// chunk.
//
// What held the first version back (3.2 us pack, 4.9 us unpack at
// R = C = 1024 on an H100): one thread per byte did eight compares and
// shifts behind one pair of float4 loads (pack), or one byte load behind
// two 16-byte stores a warp spread over 1 KB (unpack), and the grid was
// capped at a hard-coded 132 * 16 blocks. Now:
// * pack: in a chunk, lane l reads float 32j + l for j = 0..31, all 32
//   loads in flight (a warp reads 128 contiguous bytes each), and
//   __ballot_sync(x > 0) over the warp is output word j as it is: bit l
//   is element 32j + l, LSB-first. Lane j keeps word j, and the warp
//   stores the chunk's 128 bytes as 32 4-byte words.
// * unpack: lane l loads word l of the chunk (up to UNROLL chunks in
//   flight), then the warp writes the chunk's 4 KB as 8 fully coalesced
//   float4 stores: float4 32j + l is nibble l & 1 of byte 16j + l/2,
//   fetched from the lane that holds its word with one shuffle.
// * Grid: the wrapper's launch plan (kernels/pack_bits.py launch_plan):
//   a warp a chunk, 8 warps a block, at most BLOCKS_PER_SM blocks per SM
//   of the device (its SM count passed in), chunks beyond in a
//   grid-stride loop. The launcher refuses any other plan.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;
constexpr int CHUNK_BYTES = 128;  // packed bytes of a chunk (1024 floats)
constexpr int UNROLL = 4;         // unpack: chunks a warp loads ahead
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
pack_bits_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                 long long n_out) {
  const int lane = threadIdx.x & 31;
  const long long chunks = (n_out + CHUNK_BYTES - 1) / CHUNK_BYTES;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long ch = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       ch < chunks; ch += warps) {
    const float* xc = x + ch * 8 * CHUNK_BYTES + lane;
    const long long b0 = ch * CHUNK_BYTES;  // first output byte
    uint32_t mine = 0;
    if (b0 + CHUNK_BYTES <= n_out) {
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = xc[32 * j];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t w = __ballot_sync(FULL, v[j] > 0.f);
        if (lane == j) mine = w;
      }
      reinterpret_cast<uint32_t*>(out + b0)[lane] = mine;
    } else {  // the last, partial chunk: elements past 8 n_out read as 0
      const long long n = 8 * (n_out - b0);
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        // && reads the element only when it is in range.
        const uint32_t w =
            __ballot_sync(FULL, 32 * j + lane < n && xc[32 * j] > 0.f);
        if (lane == j) mine = w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (b0 + 4 * lane + k < n_out)
          out[b0 + 4 * lane + k] = (uint8_t)(mine >> (8 * k));
    }
  }
}

// Nibble v (bits 0..3) as four floats, bit 1 -> +1, bit 0 -> -1.
__device__ __forceinline__ float4 nibble(uint32_t v) {
  return make_float4((v & 1u) ? 1.f : -1.f, (v & 2u) ? 1.f : -1.f,
                     (v & 4u) ? 1.f : -1.f, (v & 8u) ? 1.f : -1.f);
}

// Word `lane` of chunk ch (bytes past n_in read as 0). vec: `in` is
// 4-byte aligned, so a whole chunk loads as words.
__device__ __forceinline__ uint32_t chunk_word(const uint8_t* in,
                                               long long n_in, long long ch,
                                               int lane, bool vec) {
  const long long b = ch * CHUNK_BYTES + 4 * lane;
  if (vec && ch * CHUNK_BYTES + CHUNK_BYTES <= n_in)
    return reinterpret_cast<const uint32_t*>(in + ch * CHUNK_BYTES)[lane];
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (b + k < n_in) w |= (uint32_t)in[b + k] << (8 * k);
  return w;
}

__global__ void __launch_bounds__(THREADS)
unpack_bits_kernel(const uint8_t* __restrict__ in, float4* __restrict__ out,
                   long long n_in, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long chunks = (n_in + CHUNK_BYTES - 1) / CHUNK_BYTES;
  const long long warps = (long long)gridDim.x * WARPS;
  const long long n_f4 = 2 * n_in;  // float4s of the output
  for (long long ch0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       ch0 < chunks; ch0 += UNROLL * warps) {
    uint32_t word[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long ch = ch0 + u * warps;
      word[u] = ch < chunks ? chunk_word(in, n_in, ch, lane, vec) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long ch = ch0 + u * warps;
      if (ch >= chunks) break;  // uniform across the warp
      float4* oc = out + ch * 2 * CHUNK_BYTES;
      const bool whole = ch * CHUNK_BYTES + CHUNK_BYTES <= n_in;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // float4 32j + lane: nibble lane & 1 of byte 16j + lane / 2.
        const uint32_t w = __shfl_sync(FULL, word[u], 4 * j + (lane >> 3));
        const uint32_t v =
            w >> (8 * ((lane >> 1) & 3) + 4 * (lane & 1));
        const long long f = ch * 2 * CHUNK_BYTES + 32 * j + lane;
        if (whole || f < n_f4) oc[32 * j + lane] = nibble(v);
      }
    }
  }
}

// The launch plan's grid (kernels/pack_bits.py launch_plan): a warp a
// chunk, at most BLOCKS_PER_SM blocks per SM.
long long plan_blocks(long long n_bytes, int sms) {
  const long long chunks = (n_bytes + CHUNK_BYTES - 1) / CHUNK_BYTES;
  const long long blocks = (chunks + WARPS - 1) / WARPS;
  const long long cap = (long long)BLOCKS_PER_SM * sms;
  return blocks < cap ? blocks : cap;
}

// Whether (grid, threads, sms) is this launcher's plan for n_bytes packed
// bytes on the current device.
int check_plan(long long n_bytes, int grid, int threads, int sms) {
  int dev = 0, dev_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&dev_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (sms != dev_sms || threads != THREADS ||
      grid != plan_blocks(n_bytes, sms))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x: (8 * n_out) float32; grid, threads and sms are the wrapper's launch
// plan for n_out on a device of sms SMs, refused (cudaErrorInvalidValue)
// unless they are this launcher's own. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int pack_bits_launch(const void* x, void* out, long long n_out,
                                int grid, int threads, int sms,
                                void* stream) {
  if (n_out <= 0) return 0;
  const int e = check_plan(n_out, grid, threads, sms);
  if (e) return e;
  pack_bits_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), n_out);
  return (int)cudaGetLastError();
}

// out: (n_in * 8) float32, 16-byte aligned; the plan as for pack_bits.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int unpack_bits_launch(const void* packed, void* out,
                                  long long n_in, int grid, int threads,
                                  int sms, void* stream) {
  if (n_in <= 0) return 0;
  const int e = check_plan(n_in, grid, threads, sms);
  if (e) return e;
  unpack_bits_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<float4*>(out), n_in,
      (uintptr_t)packed % 4 == 0);
  return (int)cudaGetLastError();
}
