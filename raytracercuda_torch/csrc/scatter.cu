// Kernel G, the backward of the differentiable route's per-ray row
// gathers, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (`ops/cuda_build.py`).
//
// G, `scatter_add_kernel`, replaces `_scatter_kernel` in
//   raytracercuda_tpu/diff/scatter.py: out[idx[t, j], :] += g[t, :, j] for
//   every ray j of every 256-ray tile t; ids outside [0, num_rows) are
//   dropped.
//
// The TPU kernel is shaped by its machine: its grid runs in order on one
// core, so it adds each tile's cotangents into a window of the output with
// a one-hot matrix product and a read-modify-write copy, race-free by
// construction, and sends the rays outside the window through an exact
// fallback.  Blocks on the H100 run concurrently, so here each ray adds
// its row with float atomics straight into device memory, which is exact
// for every id and needs no windows, bases or fallback.
//
// What bounds it on the H100: per ray, D reads (28 or 12 floats) and D
// atomic adds into a row of the output.  The reads coalesce (the
// cotangents are planar [T, D, B], so a warp reads 32 consecutive floats
// per column); the atomics land in the L2 cache, and rays of one pixel
// tile hit few, Morton-adjacent rows, so equal addresses within a warp
// serialise.  It moves a few hundred bytes per ray and is bound by L2
// atomic throughput, not by FP32 work.
//
// Float atomics sum in an order that changes from run to run, so the
// result is not bit-reproducible.  Later work: combine equal ids within a
// warp first (__match_any_sync; a tile's slot-ordered ids are coherent), or
// a deterministic sorted segment-reduce.

#include <cuda_runtime.h>

namespace {

// Grid: one block per tile; block: one thread per ray (blockDim.x = B).
// g [T, d, B] float32, idx [T, B] int32, out [num_rows, d] float32.
__global__ void scatter_add_kernel(const float* __restrict__ g,
                                   const int* __restrict__ idx, int d,
                                   int num_rows, float* __restrict__ out) {
  const int tile = blockIdx.x;
  const int b = blockDim.x;
  const int j = threadIdx.x;
  const int row = idx[static_cast<size_t>(tile) * b + j];
  if (row < 0 || row >= num_rows) return;
  const float* gj = g + static_cast<size_t>(tile) * d * b + j;
  float* o = out + static_cast<size_t>(row) * d;
  for (int k = 0; k < d; ++k) atomicAdd(o + k, gj[static_cast<size_t>(k) * b]);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  `out` must
// hold zeros (or the sum to add to) on entry.
int rt_scatter_add(const float* g, const int* idx, int num_tiles, int d,
                   int b, int num_rows, float* out, void* stream) {
  if (num_tiles == 0) return 0;
  scatter_add_kernel<<<num_tiles, b, 0, static_cast<cudaStream_t>(stream)>>>(
      g, idx, d, num_rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
