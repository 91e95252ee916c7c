// Kernels A, B, C, F and H of the tile sweep, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (`ops/cuda_build.py`).
//
// A, `primary_shade_kernel`, replaces `_primary_shade_kernel` in
//   raytracercuda_tpu/trace/pallas_sweep.py: per 16x16 pixel tile, the
//   closest hit of each ray from the common eye over the tile's listed
//   128-triangle clusters, and the winner's interpolated normal, albedo,
//   texture id, uv and reflectivity.
// F, `general_shade_kernel`, replaces `_general_shade_kernel` in
//   raytracercuda_tpu/trace/pallas_bounce.py: A with per-ray origins
//   (planar [T, 3, R]) and an activity mask [T, R], always with
//   reflectivity; inactive rays write the miss defaults.  A and F share one
//   body (a template over the origin source), each its own kernel and
//   launch.
// B, `occlusion_kernel`, replaces `_occlusion_cols_kernel` in
//   pallas_sweep.py: any hit along one light direction from each active
//   ray's origin (planar [T, 3, R] origins).
// C, `primary_kernel`, replaces `_primary_kernel` in the same file: A's
//   sweep without the attribute epilogue, on row-major [T, R, 3] directions
//   and geometry-only [C, G, 9] rows; writes t, u, v and the winning slot
//   for the differentiable route.
// H, `occlusion_rows_kernel`, replaces `_occlusion_kernel` in the same
//   file: B on row-major [T, R, 3] origins and geometry-only rows.  B and H
//   share one body (a template over the origin layout), each its own
//   kernel and launch.
//
// What bounds them on the H100: the Moller-Trumbore loop, about 40 FP32
// operations and one IEEE division per ray-triangle pair, with each
// triangle read once per block from shared memory.  A tile's listed
// clusters are a few kilobytes each, so the kernels are bound by the FP32
// pipes and by how evenly the blocks' list lengths fill the SMs, not by
// bytes from device memory.  F's lists are the most lopsided: reflected
// bundles off curved surfaces spread, so a few tiles list thousands of
// clusters and set the kernel's time.
//
// The design is the simple one: one block per tile, one thread per ray.
// The block copies each listed cluster's v0|e1|e2 columns into shared
// memory (structure of arrays, so a warp reads one broadcast word per
// operand) and every thread scans the cluster's triangles in slot order.
// A strict `<` over ascending (cluster, slot) picks exactly the JAX
// kernel's winner: there, the first minimum wins inside a cluster and
// clusters combine with a strict `<`.  A and F interpolate attributes
// once, after the loop, from the winner's row in device memory; C stops at
// the winner.  C and H read 36-byte geometry rows, so a cluster is one
// contiguous 4.6 KB run that the block's threads copy with consecutive
// loads.  B and H let a thread stop at its first hit and the block leave
// the list when every thread is done; F's inactive threads skip the tests
// but still reach every barrier.  The library is built with -fmad=false
// and IEEE division, so each expression rounds as in the plain PyTorch
// version.
//
// Later work: a warp per cluster, cp.async or TMA double-buffering of the
// cluster rows, persistent blocks over a tile queue, lists split over
// several blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // floats per shade-block row (A, B)
constexpr int kGeomCols = 9;  // floats per geometry row (C, H)
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr float kDetTiny = 1.1754944e-38f;

// Copy cluster `c`'s v0|e1|e2 columns into shared memory as [9][g]; the
// block's rows are `cols` floats apart, the first 9 being v0|e1|e2.
__device__ __forceinline__ void load_cluster(float* s, const float* blocks,
                                             int c, int g, int cols) {
  const float* blk = blocks + static_cast<size_t>(c) * g * cols;
  for (int e = threadIdx.x; e < 9 * g; e += blockDim.x) {
    const int j = e / 9;
    const int k = e - j * 9;
    s[k * g + j] = blk[j * cols + k];
  }
}

// Moller-Trumbore against slot j of the shared cluster, in the operation
// order of `_mt_cols` (pallas_sweep.py:707-732).  Returns t, FLT_MAX on miss.
__device__ __forceinline__ float mt(const float* s, int g, int j, float ox,
                                    float oy, float oz, float dx, float dy,
                                    float dz, bool use_eps, float t_eps,
                                    float& u, float& v) {
  const float v0x = s[0 * g + j], v0y = s[1 * g + j], v0z = s[2 * g + j];
  const float e1x = s[3 * g + j], e1y = s[4 * g + j], e1z = s[5 * g + j];
  const float e2x = s[6 * g + j], e2y = s[7 * g + j], e2z = s[8 * g + j];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / det;
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  bool miss = (u < 0.0f) | (u > 1.0f) | (v < 0.0f) | (u + v > 1.0f) |
              (fabsf(det) < kDetTiny);
  if (use_eps) miss |= t < t_eps;
  return miss ? kFltMax : t;
}

// Closest hit of one ray over its tile's listed clusters: ascending
// (cluster, slot), strict `<`.  Every thread of the block must call it (it
// holds the block's barriers); an inactive thread (`act` false) tests
// nothing.  On a miss bt stays FLT_MAX, bs 0, bu = bv = 0.
__device__ __forceinline__ void sweep_closest(
    float* s, const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ blocks, int cols, int g, int tile, float ox,
    float oy, float oz, float dx, float dy, float dz, bool act, bool use_eps,
    float t_eps, float& bt, float& bu, float& bv, int& bs) {
  bt = kFltMax;
  bu = 0.0f;
  bv = 0.0f;
  bs = 0;
  const int end = offsets[tile + 1];
  for (int r = offsets[tile]; r < end; ++r) {
    const int c = ids[r];
    __syncthreads();  // every thread is done with the previous cluster
    load_cluster(s, blocks, c, g, cols);
    __syncthreads();
    if (!act) continue;
    for (int j = 0; j < g; ++j) {
      float u, v;
      const float t = mt(s, g, j, ox, oy, oz, dx, dy, dz, use_eps, t_eps, u,
                         v);
      if (t < bt) {
        bt = t;
        bu = u;
        bv = v;
        bs = c * g + j;
      }
    }
  }
}

// The body of A and F.  kPerRay picks the origin source: planar [T, 3, R]
// origins and an activity mask [T, R] (F), or the common eye [3] (A, whose
// rays are all active).  Grid: one block per tile; block: one thread per
// ray (blockDim.x = R).  out_f planes [n_f, T, R]: t, u, v, nx, ny, nz, ar,
// ag, ab[, tex, tu, tv][, refl]; out_slot [T, R].
template <bool kPerRay>
__device__ __forceinline__ void shade_body(
    float* s, const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const int* __restrict__ active, const float* __restrict__ blocks, int g,
    int has_uv, int with_refl, int use_eps, float t_eps,
    float* __restrict__ out_f, int* __restrict__ out_slot) {
  const int tile = blockIdx.x;
  const int R = blockDim.x;
  const int i = threadIdx.x;
  const size_t o = static_cast<size_t>(tile) * R + i;
  const float* d = dirs + static_cast<size_t>(tile) * 3 * R;
  float ox, oy, oz;
  bool act = true;
  if (kPerRay) {
    const float* org = origins + static_cast<size_t>(tile) * 3 * R;
    ox = org[i];
    oy = org[R + i];
    oz = org[2 * R + i];
    act = active[o] != 0;
  } else {
    ox = origins[0];
    oy = origins[1];
    oz = origins[2];
  }
  float bt, bu, bv;
  int bs;
  sweep_closest(s, offsets, ids, blocks, kCols, g, tile, ox, oy, oz, d[i],
                d[R + i], d[2 * R + i], act, use_eps != 0, t_eps, bt, bu, bv,
                bs);

  const size_t plane = static_cast<size_t>(gridDim.x) * R;
  const int n_f = (has_uv ? 12 : 9) + (with_refl ? 1 : 0);
  out_slot[o] = bs;
  out_f[o] = bt;
  if (!(bt < kFltMax)) {
    for (int k = 1; k < n_f; ++k) out_f[k * plane + o] = 0.0f;
    return;
  }
  const float* w = blocks + static_cast<size_t>(bs) * kCols;
  const float w_ = 1.0f - bu - bv;
  float* p = out_f + o;
  p[1 * plane] = bu;
  p[2 * plane] = bv;
  for (int k = 0; k < 3; ++k)  // smooth normal
    p[(3 + k) * plane] = w[9 + k] * w_ + w[12 + k] * bu + w[15 + k] * bv;
  for (int k = 0; k < 3; ++k)  // per-face albedo
    p[(6 + k) * plane] = w[18 + k];
  int k = 9;
  if (has_uv) {
    p[9 * plane] = w[21];
    p[10 * plane] = w[22] * w_ + w[24] * bu + w[26] * bv;
    p[11 * plane] = w[23] * w_ + w[25] * bu + w[27] * bv;
    k = 12;
  }
  if (with_refl) p[k * plane] = w[28];
}

// Kernel A: the common eye [3], planar directions [T, 3, R].
__global__ void primary_shade_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ eye, const float* __restrict__ dirs,
    const float* __restrict__ blocks, int g, int has_uv, int with_refl,
    int use_eps, float t_eps, float* __restrict__ out_f,
    int* __restrict__ out_slot) {
  extern __shared__ float s[];  // [9][g]
  shade_body<false>(s, offsets, ids, eye, dirs, nullptr, blocks, g, has_uv,
                    with_refl, use_eps, t_eps, out_f, out_slot);
}

// Kernel F: planar origins and directions [T, 3, R], activity [T, R]; a
// tile whose list is empty, like an inactive ray, writes the miss defaults.
__global__ void general_shade_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const int* __restrict__ active, const float* __restrict__ blocks, int g,
    int has_uv, int use_eps, float t_eps, float* __restrict__ out_f,
    int* __restrict__ out_slot) {
  extern __shared__ float s[];  // [9][g]
  shade_body<true>(s, offsets, ids, origins, dirs, active, blocks, g, has_uv,
                   1, use_eps, t_eps, out_f, out_slot);
}

// Kernel C.  Grid: one block per tile; block: one thread per ray.
// dirs row-major [T, R, 3]; blocks [C, g, 9]; out_f planes [3, T, R]:
// t, u, v; out_slot [T, R].
__global__ void primary_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ eye, const float* __restrict__ dirs,
    const float* __restrict__ blocks, int g, int use_eps, float t_eps,
    float* __restrict__ out_f, int* __restrict__ out_slot) {
  extern __shared__ float s[];  // [9][g]
  const int tile = blockIdx.x;
  const int R = blockDim.x;
  const size_t o = static_cast<size_t>(tile) * R + threadIdx.x;
  const float* d = dirs + o * 3;
  float bt, bu, bv;
  int bs;
  sweep_closest(s, offsets, ids, blocks, kGeomCols, g, tile, eye[0], eye[1],
                eye[2], d[0], d[1], d[2], true, use_eps != 0, t_eps, bt, bu,
                bv, bs);
  const size_t plane = static_cast<size_t>(gridDim.x) * R;
  out_f[o] = bt;
  out_f[plane + o] = bu;
  out_f[2 * plane + o] = bv;
  out_slot[o] = bs;
}

// Any hit along `light` from one ray's origin over its tile's listed
// clusters (B and H).  kRowMajor picks the origin layout: [T, R, 3] (H) or
// planar [T, 3, R] (B).  Grid: one block per tile; block: one thread per
// ray.  occ [T, R] int32.
template <bool kRowMajor>
__device__ __forceinline__ void occlusion_body(
    float* s, const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ light, const float* __restrict__ origins,
    const int* __restrict__ active, const float* __restrict__ blocks,
    int cols, int g, float t_eps, int* __restrict__ occ) {
  const int tile = blockIdx.x;
  const int R = blockDim.x;
  const int i = threadIdx.x;
  const float dx = light[0], dy = light[1], dz = light[2];
  const size_t o = static_cast<size_t>(tile) * R + i;
  float ox, oy, oz;
  if (kRowMajor) {
    const float* org = origins + o * 3;
    ox = org[0];
    oy = org[1];
    oz = org[2];
  } else {
    const float* org = origins + static_cast<size_t>(tile) * 3 * R;
    ox = org[i];
    oy = org[R + i];
    oz = org[2 * R + i];
  }
  const bool act = active[o] != 0;

  bool hit = false;
  const int end = offsets[tile + 1];
  for (int r = offsets[tile]; r < end; ++r) {
    // Also the barrier before the shared cluster is overwritten.
    if (__syncthreads_and(hit || !act)) break;
    load_cluster(s, blocks, ids[r], g, cols);
    __syncthreads();
    if (act && !hit) {
      for (int j = 0; j < g; ++j) {
        float u, v;
        if (mt(s, g, j, ox, oy, oz, dx, dy, dz, true, t_eps, u, v) <
            kFltMax) {
          hit = true;
          break;
        }
      }
    }
  }
  occ[o] = hit ? 1 : 0;
}

// Kernel B: planar origins [T, 3, R], shade blocks [C, g, 32].
__global__ void occlusion_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ light, const float* __restrict__ origins,
    const int* __restrict__ active, const float* __restrict__ blocks, int g,
    float t_eps, int* __restrict__ occ) {
  extern __shared__ float s[];  // [9][g]
  occlusion_body<false>(s, offsets, ids, light, origins, active, blocks,
                        kCols, g, t_eps, occ);
}

// Kernel H: row-major origins [T, R, 3], geometry rows [C, g, 9].
__global__ void occlusion_rows_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ light, const float* __restrict__ origins,
    const int* __restrict__ active, const float* __restrict__ blocks, int g,
    float t_eps, int* __restrict__ occ) {
  extern __shared__ float s[];  // [9][g]
  occlusion_body<true>(s, offsets, ids, light, origins, active, blocks,
                       kGeomCols, g, t_eps, occ);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success).

int rt_primary_shade(const int* offsets, const int* ids, const float* eye,
                     const float* dirs, const float* blocks, int num_tiles,
                     int rays_per_tile, int g, int has_uv, int with_refl,
                     int use_eps, float t_eps, float* out_f, int* out_slot,
                     void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = sizeof(float) * 9 * g;
  primary_shade_kernel<<<num_tiles, rays_per_tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, eye, dirs, blocks, g, has_uv, with_refl, use_eps, t_eps,
      out_f, out_slot);
  return static_cast<int>(cudaGetLastError());
}

int rt_general_shade(const int* offsets, const int* ids,
                     const float* origins, const float* dirs,
                     const int* active, const float* blocks, int num_tiles,
                     int rays_per_tile, int g, int has_uv, int use_eps,
                     float t_eps, float* out_f, int* out_slot, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = sizeof(float) * 9 * g;
  general_shade_kernel<<<num_tiles, rays_per_tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, origins, dirs, active, blocks, g, has_uv, use_eps, t_eps,
      out_f, out_slot);
  return static_cast<int>(cudaGetLastError());
}

int rt_occlusion(const int* offsets, const int* ids, const float* light,
                 const float* origins, const int* active,
                 const float* blocks, int num_tiles, int rays_per_tile, int g,
                 float t_eps, int* occ, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = sizeof(float) * 9 * g;
  occlusion_kernel<<<num_tiles, rays_per_tile, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, light, origins, active, blocks, g, t_eps, occ);
  return static_cast<int>(cudaGetLastError());
}

int rt_primary(const int* offsets, const int* ids, const float* eye,
               const float* dirs, const float* blocks, int num_tiles,
               int rays_per_tile, int g, int use_eps, float t_eps,
               float* out_f, int* out_slot, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = sizeof(float) * 9 * g;
  primary_kernel<<<num_tiles, rays_per_tile, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, eye, dirs, blocks, g, use_eps, t_eps, out_f, out_slot);
  return static_cast<int>(cudaGetLastError());
}

int rt_occlusion_rows(const int* offsets, const int* ids, const float* light,
                      const float* origins, const int* active,
                      const float* blocks, int num_tiles, int rays_per_tile,
                      int g, float t_eps, int* occ, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = sizeof(float) * 9 * g;
  occlusion_rows_kernel<<<num_tiles, rays_per_tile, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, light, origins, active, blocks, g, t_eps, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
