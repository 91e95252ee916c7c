// Kernel D of the port, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (`ops/cuda_build.py`).
//
// D, `clear_kernel`, replaces `_clear_kernel` in
//   raytracercuda_tpu/ops/clear.py: fill the packed framebuffer with one
//   u32 value.  The port keeps packed pixels in int64 (torch has little
//   uint32 support), so each element is the value zero-extended to 64 bits:
//   0xFF00FF00 stays 4278255360, not a negative number.
//
// What bounds it on the H100: the store bandwidth, 8 bytes per pixel (a
// 256x256 frame is 512 KB, so at that size the launch itself dominates).
// The design: a grid-stride loop, one 8-byte store per pixel per step.

#include <cuda_runtime.h>

namespace {

__global__ void clear_kernel(long long* __restrict__ out, long long n,
                             unsigned int value) {
  const long long v = static_cast<long long>(value);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = v;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int rt_clear(long long* out, long long n, unsigned int value, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  clear_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, value);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
