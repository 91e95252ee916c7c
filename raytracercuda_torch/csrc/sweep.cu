// Kernels A and B of the tile sweep, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (`ops/cuda_build.py`).
//
// A, `primary_shade_kernel`, replaces `_primary_shade_kernel` in
//   raytracercuda_tpu/trace/pallas_sweep.py: per 16x16 pixel tile, the
//   closest hit of each ray from the common eye over the tile's listed
//   128-triangle clusters, and the winner's interpolated normal, albedo,
//   texture id, uv and reflectivity.
// B, `occlusion_kernel`, replaces `_occlusion_cols_kernel` in the same
//   file: any hit along one light direction from each active ray's origin.
//
// What bounds them on the H100: the Moller-Trumbore loop, about 40 FP32
// operations and one IEEE division per ray-triangle pair, with each
// triangle read once per block from shared memory.  A tile's listed
// clusters are a few kilobytes each, so the kernels are bound by the FP32
// pipes and by how evenly the blocks' list lengths fill the SMs, not by
// bytes from device memory.
//
// The design is the simple one: one block per tile, one thread per ray.
// The block copies each listed cluster's v0|e1|e2 columns into shared
// memory (structure of arrays, so a warp reads one broadcast word per
// operand) and every thread scans the cluster's triangles in slot order.
// A strict `<` over ascending (cluster, slot) picks exactly the JAX
// kernel's winner: there, the first minimum wins inside a cluster and
// clusters combine with a strict `<`.  Attributes are interpolated once,
// after the loop, from the winner's row in device memory.  Kernel B lets a
// thread stop at its first hit and the block leave the list when every
// thread is done.  The library is built with -fmad=false and IEEE division,
// so each expression rounds as in the plain PyTorch version.
//
// Later work: a warp per cluster, cp.async or TMA double-buffering of the
// cluster rows, persistent blocks over a tile queue.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // floats per shade-block row
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr float kDetTiny = 1.1754944e-38f;

// Copy cluster `c`'s v0|e1|e2 columns into shared memory as [9][g].
__device__ __forceinline__ void load_cluster(float* s, const float* blocks,
                                             int c, int g) {
  const float* blk = blocks + static_cast<size_t>(c) * g * kCols;
  for (int e = threadIdx.x; e < 9 * g; e += blockDim.x) {
    const int j = e / 9;
    const int k = e - j * 9;
    s[k * g + j] = blk[j * kCols + k];
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

// Grid: one block per tile; block: one thread per ray (blockDim.x = R).
// out_f planes [n_f, T, R]: t, u, v, nx, ny, nz, ar, ag, ab
// [, tex, tu, tv][, refl]; out_slot [T, R].
__global__ void primary_shade_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ eye, const float* __restrict__ dirs,
    const float* __restrict__ blocks, int g, int has_uv, int with_refl,
    int use_eps, float t_eps, float* __restrict__ out_f,
    int* __restrict__ out_slot) {
  extern __shared__ float s[];  // [9][g]
  const int tile = blockIdx.x;
  const int R = blockDim.x;
  const int i = threadIdx.x;
  const float ox = eye[0], oy = eye[1], oz = eye[2];
  const float* d = dirs + static_cast<size_t>(tile) * 3 * R;
  const float dx = d[i], dy = d[R + i], dz = d[2 * R + i];

  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  const int end = offsets[tile + 1];
  for (int r = offsets[tile]; r < end; ++r) {
    const int c = ids[r];
    __syncthreads();  // every thread is done with the previous cluster
    load_cluster(s, blocks, c, g);
    __syncthreads();
    for (int j = 0; j < g; ++j) {
      float u, v;
      const float t = mt(s, g, j, ox, oy, oz, dx, dy, dz, use_eps != 0,
                         t_eps, u, v);
      if (t < bt) {
        bt = t;
        bu = u;
        bv = v;
        bs = c * g + j;
      }
    }
  }

  const size_t plane = static_cast<size_t>(gridDim.x) * R;
  const size_t o = static_cast<size_t>(tile) * R + i;
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

// Grid: one block per tile; block: one thread per ray.  occ [T, R] int32.
__global__ void occlusion_kernel(
    const int* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ light, const float* __restrict__ origins,
    const int* __restrict__ active, const float* __restrict__ blocks, int g,
    float t_eps, int* __restrict__ occ) {
  extern __shared__ float s[];  // [9][g]
  const int tile = blockIdx.x;
  const int R = blockDim.x;
  const int i = threadIdx.x;
  const float dx = light[0], dy = light[1], dz = light[2];
  const float* org = origins + static_cast<size_t>(tile) * 3 * R;
  const float ox = org[i], oy = org[R + i], oz = org[2 * R + i];
  const size_t o = static_cast<size_t>(tile) * R + i;
  const bool act = active[o] != 0;

  bool hit = false;
  const int end = offsets[tile + 1];
  for (int r = offsets[tile]; r < end; ++r) {
    // Also the barrier before the shared cluster is overwritten.
    if (__syncthreads_and(hit || !act)) break;
    load_cluster(s, blocks, ids[r], g);
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

}  // extern "C"
