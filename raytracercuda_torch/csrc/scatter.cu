// Kernel G, the backward of the differentiable route's per-ray row
// gathers, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (`ops/cuda_build.py`).
//
// G replaces `_scatter_kernel` in raytracercuda_tpu/diff/scatter.py:
//   out[idx[t, j], :] += g[t, :, j] for every ray j of every tile t, over
//   an output of zeros; ids outside [0, num_rows) are dropped.
//
// The TPU kernel is shaped by its machine: its grid runs in order on one
// core, so it adds each tile's cotangents into a window of the output with
// a one-hot matrix product and a read-modify-write copy, race-free by
// construction, and sends the rays outside the window through an exact
// fallback.  Blocks on the H100 run concurrently, so here each kept ray
// adds its row with float atomics straight into device memory, which is
// exact for every id and needs no windows, bases or fallback.
//
// What bounds it on the H100: bytes.  The output must be written whole
// (config 4's grad step: 350,000 face rows x 28 floats = 39.2 MB, then a
// texture's 65,536 x 12 = 3.1 MB), and every ray's id read (4 MB at
// 1024^2); only the ~2% of rays that hit read their cotangents and add
// them.  The design:
//   * `zero_rows_kernel` writes the output with 16-byte stores in a
//     grid-stride loop over a grid sized to the card, a pure store stream;
//   * `scatter_add_kernel` walks the rays in a grid-stride loop over a
//     grid sized to the card.  A warp loads 8 groups of 32 ids at once,
//     a grid's width apart (8 coalesced loads in flight, so that the 4 MB
//     of ids stream, and a pixel tile's hits spread over many warps), and
//     skips a group with no kept lane after one `__ballot_sync`.  A kept
//     lane reads its cotangents from the planar [T, D, B] layout (each
//     column coalesced across lanes), 16 loads at once, and adds them
//     with vector atomics, `atomicAdd` on float4 (D % 4 == 0) or float2
//     (D % 2 == 0), one L2 operation for W floats;
//   * the scatter is launched with programmatic dependent launch: the fill
//     lets it start at once, and it waits (`griddepcontrol.wait`) only
//     before its first atomic, so loading and testing ids overlaps the
//     fill's tail instead of a launch gap.
//
// Float atomics sum in an order that changes from run to run, so the
// result is not bit-reproducible.  Under torch's deterministic mode the
// wrapper takes the sorted route instead: it sorts the ray positions by
// row id, stably, with torch ops (`diff/scatter.py:sorted_segments`), and
// `segment_sum_kernel` has one thread per output float add its row's terms
// in that order, ascending (tile, ray), from 0.0, as `index_add_` on the
// CPU does.  It reads its terms from the planar layout one at a time, so
// it is slower than the atomics; its point is the repeatable sum.
// Combining equal ids within a warp first is later work.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

// Lets a kernel launched after this one with programmatic stream
// serialization start now; it still waits for this grid's writes.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the grids this one depends on (programmatic launch) have
// finished and their writes are visible; returns at once otherwise.
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// out[0, n) = 0.0: float4 stores over the 16-byte aligned body, scalar
// stores over the tail of n % 4.
__global__ void zero_rows_kernel(float* __restrict__ out, long long n) {
  allow_dependents();
  const long long n4 = n / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = rt::thread_index(); i < n4; i += rt::thread_count())
    out4[i] = zero;
  const long long tail = rt::thread_index();
  if (tail < n - 4 * n4) out[4 * n4 + tail] = 0.0f;
}

// Groups of 32 ids a warp loads before it tests any: kUnroll coalesced
// 128-byte loads in flight per warp, not one load's latency per group.
constexpr int kUnroll = 8;
// Cotangents a kept lane loads before it adds them: the atomics order
// memory, so loads after one wait for it; a chunk's loads go out at once.
constexpr int kChunk = 16;

// Adds W floats to out[0, W).
template <int W>
__device__ __forceinline__ void add_vector(float* out, const float* v) {
  if constexpr (W == 4) {
    atomicAdd(reinterpret_cast<float4*>(out),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(out), make_float2(v[0], v[1]));
  } else {
    atomicAdd(out, v[0]);
  }
}

// out[0, d) += src[k * stride] for k < d, W floats per atomic (W divides
// d and kChunk).
template <int W>
__device__ __forceinline__ void add_row(float* out, const float* src, int d,
                                        int stride) {
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      v[c] = k0 + c < d ? src[static_cast<long long>(k0 + c) * stride] : 0.0f;
#pragma unroll
    for (int c = 0; c < kChunk; c += W)
      if (k0 + c < d) add_vector<W>(out + k0 + c, v + c);
  }
}

// g [T, d, b] float32, idx [T, b] int32, out [num_rows, d] float32 of
// zeros; W divides d.  Per step a warp takes kUnroll groups of 32
// consecutive rays, one grid's width of groups apart, so that the hits of
// one pixel tile spread over many warps.
template <int W>
__global__ void scatter_add_kernel(const float* __restrict__ g,
                                   const int* __restrict__ idx,
                                   long long num_rays, int d, int b,
                                   int num_rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = rt::thread_index() / 32;
  const long long span = rt::thread_count();  // 32 rays per warp
  for (long long r0 = 32 * warp + lane; r0 - lane < num_rays;
       r0 += span * kUnroll) {
    int rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + span * u;
      rows[u] = r < num_rays ? idx[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = rows[u];
      const bool keep = row >= 0 && row < num_rows;
      if (__ballot_sync(0xffffffffu, keep) == 0) continue;
      wait_for_prerequisites();
      if (!keep) continue;
      const long long r = r0 + span * u;
      const long long tile = r / b;
      add_row<W>(out + static_cast<long long>(row) * d,
                 g + tile * d * b + (r - tile * b), d, b);
    }
  }
  // A warp with no kept ray never waited: this grid still ends after the
  // fill, so the kernels after it on the stream find the output whole.
  wait_for_prerequisites();
}

template <int W>
cudaError_t launch_scatter(const float* g, const int* idx, long long n,
                           int d, int b, int num_rows, float* out,
                           int overlap, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(rt::card_grid((n + kUnroll - 1) / kUnroll));
  config.blockDim = dim3(rt::kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&config, scatter_add_kernel<W>, g, idx, n, d, b,
                            num_rows, out);
}

// out[r, k] = sum of g[p / b, k, p % b] over p in order[seg[r]:seg[r + 1]],
// in that order, from 0.0; one thread per output float, grid-stride.
__global__ void segment_sum_kernel(const float* __restrict__ g,
                                   const int* __restrict__ order,
                                   const int* __restrict__ seg, int d, int b,
                                   long long n_out, float* __restrict__ out) {
  for (long long e = rt::thread_index(); e < n_out; e += rt::thread_count()) {
    const long long r = e / d;
    const int k = static_cast<int>(e - r * d);
    float acc = 0.0f;
    const int end = seg[r + 1];
    for (int q = seg[r]; q < end; ++q) {
      const int p = order[q];
      const int tile = p / b;
      acc += g[(static_cast<long long>(tile) * d + k) * b + (p - tile * b)];
    }
    out[e] = acc;
  }
}

}  // namespace

extern "C" {

// The sorted route: out [num_rows, d] from g [T, d, b], the ray positions
// `order` sorted by row id and the rows' bounds `seg` [num_rows + 1].
// Returns the launch error (0 on success).
int rt_segment_sum(const float* g, const int* order, const int* seg, int d,
                   int b, int num_rows, float* out, void* stream) {
  const long long n_out = static_cast<long long>(num_rows) * d;
  if (n_out == 0) return 0;
  segment_sum_kernel<<<rt::card_grid(n_out), rt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, order, seg, d,
                                                            b, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// Writes out [num_rows, d] = zeros, then adds g [num_tiles, d, b] into it
// by idx [num_tiles, b]: the fill and the scatter on `stream`, the scatter
// with programmatic dependent launch when `overlap` is set.  `width` (1,
// 2 or 4, dividing d) is the floats per atomic add; `out` must be 16-byte
// aligned.  Returns the first launch error (0 on success).
int rt_scatter_add(const float* g, const int* idx, int num_tiles, int d,
                   int b, int num_rows, int width, int overlap, float* out,
                   void* stream) {
  if ((width != 1 && width != 2 && width != 4) || d < 0 || d % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_out = static_cast<long long>(num_rows) * d;
  if (n_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  zero_rows_kernel<<<rt::card_grid(n_out / 4), rt::kThreads, 0, s>>>(out,
                                                                     n_out);
  cudaError_t err = cudaGetLastError();
  const long long n = static_cast<long long>(num_tiles) * b;
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  switch (width) {
    case 4:
      err = launch_scatter<4>(g, idx, n, d, b, num_rows, out, overlap, s);
      break;
    case 2:
      err = launch_scatter<2>(g, idx, n, d, b, num_rows, out, overlap, s);
      break;
    default:
      err = launch_scatter<1>(g, idx, n, d, b, num_rows, out, overlap, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
