// launch_floor: an empty kernel behind a plain C launcher, the least
// device time a launch of the port's kernels can take. chip_smoke.py
// builds it as a shared library, loads it with ctypes as the port loads
// its kernels, and times it with the same time_device_ms
// ("launch_floor_ms" on every row of its kernels line).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared \
//        -Xcompiler -fPIC -o liblaunch_floor.so launch_floor.cu
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one warp that does nothing, on the given stream. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
