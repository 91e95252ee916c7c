// Grid sizes for the port's grid-stride kernels (G's fill and scatter in
// scatter.cu, D in frame.cu, the key fill of hit_key.cuh and H's flag
// clear in sweep.cu): enough blocks to fill every SM a few times over, and
// no more than the work needs.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kThreads = 256;
// Four blocks of 256 threads a multiprocessor: enough stores in flight
// for G's fill to stream near the memory rate.  G's scatter takes more
// registers a thread, so fewer of its blocks are resident at once and the
// rest follow as they finish.
constexpr int kBlocksPerSm = 4;

// The current device's multiprocessor count (132 on an H100 SXM), read
// once.
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    int n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        n > 0) {
      count = n;
    } else {
      count = 132;
    }
  }
  return count;
}

// Blocks of kThreads for `items` work items of one thread each: at least
// one, at most kBlocksPerSm per multiprocessor.
inline int card_grid(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long thread_count() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

}  // namespace rt
