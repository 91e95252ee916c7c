// Kernels K and L of the port, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (`ops/cuda_build.py`).  They walk the threaded LBVH
// of `accel/bvh.py:build_bvh`: packed_nodes [N, 6] box min | max,
// packed_links [N, 2] int32 (a-link: >= 0 the hit link of an internal
// node, < 0 a leaf's -(first * 64 + count) - 2; skip link, -1 ends) and
// packed_tris [F + 64, 9], the corners of the faces in Morton order.
//
// K, `walk_kernel<kAnyHit>`, replaces the XLA loops `_closest_hit_tile` and
//   `_any_hit_tile` of raytracercuda_tpu/trace/traverse.py:62-124,163-209
//   (no Pallas kernel): one thread per ray walks the skip links from node
//   0, for at most max_iters steps.  The slab test of
//   `ops/math.box_ray_intersect` with inv_dir = 1 / d (a NaN product
//   misses); a closest-hit walk enters a box below its best t, an any-hit
//   walk one below its t_max.  A leaf's faces are tested in ascending slot
//   with the oracle's Moller-Trumbore (`mt.cuh`: no |det| threshold), a
//   hit replacing the best only on a strict `<`, so the winner is the
//   first minimum in slot order; an any-hit ray stops at its first face
//   with t_eps < t < t_max.
//
// L, `beam_kernel`, replaces the XLA rounds of `trace_beam`
//   (raytracercuda_tpu/trace/beam.py:121-290): one block per tile_px^2
//   pixel tile, one thread per pixel.  In each round thread 0 walks the
//   tile's cursor: a node survives when it is outside none of the tile's 5
//   planes (p-vertex test) and gap^2 <= tile_tmax^2, tile_tmax being the
//   block's largest best t; a surviving leaf appends (first, count) to the
//   shared-memory queue.  The walk ends when the queue is full, the cursor
//   is -1 or `steps` steps have passed.  Then every thread tests its ray
//   against the queued faces in queue order, then slot order, with the
//   strict `<`.  Rounds repeat until the cursor is -1: each tile tests the
//   same candidates in the same order as the JAX package's rounds, whose
//   first minimum within a 64-entry block and strict `<` across blocks and
//   rounds is this sequential first minimum.  The planes come from the
//   wrapper (`dense.tile_frustum_planes`), the same tensor the plain version
//   reads.
//
// What bounds them on the H100: the FP32 work of the ray-triangle tests
// (46 operations each) and of the slab or plane tests, at 67 TFLOP/s; the
// nodes and triangles they read fit in the 50 MB L2.  Neither design
// comes near it yet, and both say why:
//   * K: a warp's 32 rays diverge as their walks part, and every node and
//     triangle is a dependent load (the walk is a chain of gathers);
//   * L: the walk is serial per tile.  At 512^2 with 16-pixel tiles, 1,024
//     blocks each have 255 threads waiting while thread 0 walks, and all
//     256 then read each queued triangle from global memory (one L1
//     broadcast per warp).  A warp-wide walk or a split queue is later
//     work.
// Built with -fmad=false and IEEE division, every expression rounds as the
// plain PyTorch versions' separate operations do: t, u and v are bit-equal
// to them.

#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "launch.cuh"
#include "mt.cuh"

namespace {

constexpr int kLeafPack = 64;  // accel/bvh.py:LEAF_PACK

// A leaf's a-link a < 0 as (first, count): enc = -a - 2, first = enc //
// 64 and count = enc % 64 with floor division, as the JAX package divides.
// A Karras leaf that the collapse left internal has a = -1: first = -1,
// count = 63.
__device__ __forceinline__ void leaf_range(int a, int& first, int& count) {
  const int enc = -a - 2;
  first = enc >= 0 ? enc / kLeafPack : -((kLeafPack - 1 - enc) / kLeafPack);
  count = enc - first * kLeafPack;
}

__device__ __forceinline__ int clip_slot(int s, int num_slots) {
  return min(max(s, 0), num_slots - 1);
}

// The slab test of `ops/math.box_ray_intersect`: the entry distance,
// clamped to 0 when the origin is inside; FLT_MAX on a miss and where a
// product is NaN (0 * inf), as the plain version's NaN-propagating min and
// max make it.
__device__ __forceinline__ float slab(const float* __restrict__ box,
                                      float ox, float oy, float oz, float ix,
                                      float iy, float iz) {
  const float ax = (box[0] - ox) * ix, bx = (box[3] - ox) * ix;
  const float ay = (box[1] - oy) * iy, by = (box[4] - oy) * iy;
  const float az = (box[2] - oz) * iz, bz = (box[5] - oz) * iz;
  if (isnan(ax) || isnan(bx) || isnan(ay) || isnan(by) || isnan(az) ||
      isnan(bz))
    return kFltMax;
  const float t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                            fmaxf(az, bz));
  const float t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                             fminf(az, bz));
  if (!(t_far >= t_near) || t_far < 0.0f) return kFltMax;
  return fmaxf(t_near, 0.0f);
}

// max(x, 0) that keeps a NaN, as the plain version's clamp.
__device__ __forceinline__ float relu(float x) {
  return (x > 0.0f || isnan(x)) ? x : 0.0f;
}

// The oracle test of a ray against row `row` of packed_tris: the edges
// are formed here, as the plain version forms them from the same rows.
__device__ __forceinline__ float row_mt(const float* __restrict__ tris,
                                         int row, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, bool use_eps, float t_eps,
                                         float& u, float& v) {
  const float* r = tris + 9LL * row;
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  return oracle_mt(v0x, v0y, v0z, r[3] - v0x, r[4] - v0y, r[5] - v0z,
                   r[6] - v0x, r[7] - v0y, r[8] - v0z, ox, oy, oz, dx, dy,
                   dz, use_eps, t_eps, u, v);
}

// K.  One thread per ray; origins, dirs [R, 3].  Closest hit writes t, u,
// v and the winning slot (t = FLT_MAX, u = v = 0, slot 0 on a miss); any
// hit writes the occlusion flag.
template <bool kAnyHit>
__global__ void walk_kernel(const float* __restrict__ nodes,
                            const int* __restrict__ links,
                            const float* __restrict__ tris, int num_slots,
                            const float* __restrict__ origins,
                            const float* __restrict__ dirs,
                            const float* __restrict__ t_max, int num_rays,
                            int max_iters, int use_eps, float t_eps,
                            float* __restrict__ out_t,
                            float* __restrict__ out_u,
                            float* __restrict__ out_v,
                            int* __restrict__ out_slot,
                            bool* __restrict__ out_occluded) {
  const long long i = rt::thread_index();
  if (i >= num_rays) return;
  const float ox = origins[3 * i], oy = origins[3 * i + 1],
              oz = origins[3 * i + 2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tmax = kAnyHit ? t_max[i] : 0.0f;
  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  bool occluded = false;
  int cur = 0;
  for (int step = 0; step < max_iters && cur >= 0; ++step) {
    const float box_d = slab(nodes + 6LL * cur, ox, oy, oz, ix, iy, iz);
    const int a = links[2LL * cur];
    const int skip = links[2LL * cur + 1];
    const bool enter = box_d < (kAnyHit ? tmax : bt);
    if (enter && a < 0) {
      int first, count;
      leaf_range(a, first, count);
      for (int k = 0; k < count; ++k) {
        const int slot = clip_slot(first + k, num_slots);
        float u, v;
        if (kAnyHit) {
          const float t = row_mt(tris, slot, ox, oy, oz, dx, dy, dz, false,
                                  0.0f, u, v);
          if (t > t_eps && t < tmax) {
            occluded = true;
            break;
          }
        } else {
          const float t = row_mt(tris, slot, ox, oy, oz, dx, dy, dz,
                                  use_eps != 0, t_eps, u, v);
          if (t < bt) {
            bt = t;
            bu = u;
            bv = v;
            bs = slot;
          }
        }
      }
    }
    cur = occluded ? -1 : (enter && a >= 0) ? a : skip;
  }
  if (kAnyHit) {
    out_occluded[i] = occluded;
  } else {
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_slot[i] = bs;
  }
}

// L.  Grid: one block per tile (tiles row-major); block: tile_px^2 threads,
// thread r the pixel (r / tile_px, r % tile_px) of its tile.  dirs [H*W, 3]
// row-major; planes [T, 5, 3]; eye [3].  Dynamic shared memory: the queue's
// firsts and counts, 2 * queue ints, then one float per thread.
__global__ void beam_kernel(const float* __restrict__ nodes,
                            const int* __restrict__ links,
                            const float* __restrict__ tris, int num_slots,
                            const float* __restrict__ eye,
                            const float* __restrict__ dirs,
                            const float* __restrict__ planes, int width,
                            int tile_px, int queue, int k_leaf, int steps,
                            int use_eps, float t_eps,
                            float* __restrict__ out_t,
                            float* __restrict__ out_u,
                            float* __restrict__ out_v,
                            int* __restrict__ out_slot) {
  extern __shared__ int s_dyn[];
  int* q_first = s_dyn;
  int* q_count = s_dyn + queue;
  float* s_bt = reinterpret_cast<float*>(s_dyn + 2 * queue);
  __shared__ float s_planes[15];
  __shared__ int s_n, s_cur;

  const int tiles_x = width / tile_px;
  const int r = threadIdx.x;
  const long long py = (blockIdx.x / tiles_x) * tile_px + r / tile_px;
  const long long px = (blockIdx.x % tiles_x) * tile_px + r % tile_px;
  const long long i = py * width + px;
  const float ex = eye[0], ey = eye[1], ez = eye[2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  // Strided: a tile of 3x3 pixels or less has fewer than 15 threads.
  for (int j = r; j < 15; j += blockDim.x)
    s_planes[j] = planes[15LL * blockIdx.x + j];
  if (r == 0) s_cur = 0;
  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  bool more = true;
  while (more) {
    s_bt[r] = bt;
    __syncthreads();  // the best ts, planes and cursor are in place
    if (r == 0) {
      float tile_tmax = s_bt[0];
      for (int j = 1; j < static_cast<int>(blockDim.x); ++j)
        tile_tmax = fmaxf(tile_tmax, s_bt[j]);
      const float reach = tile_tmax * tile_tmax;
      int cur = s_cur, n = 0;
      for (int step = 0; step < steps && cur >= 0 && n < queue; ++step) {
        const float* b = nodes + 6LL * cur;
        const float b0 = b[0], b1 = b[1], b2 = b[2];
        const float b3 = b[3], b4 = b[4], b5 = b[5];
        const int a = links[2LL * cur];
        const int skip = links[2LL * cur + 1];
        bool outside = false;
#pragma unroll
        for (int p = 0; p < 5; ++p) {
          const float nx = s_planes[3 * p], ny = s_planes[3 * p + 1],
                      nz = s_planes[3 * p + 2];
          const float qx = (nx > 0.0f ? b3 : b0) - ex;
          const float qy = (ny > 0.0f ? b4 : b1) - ey;
          const float qz = (nz > 0.0f ? b5 : b2) - ez;
          outside |= nx * qx + ny * qy + nz * qz < 0.0f;
        }
        const float gx = relu(b0 - ex) + relu(ex - b3);
        const float gy = relu(b1 - ey) + relu(ey - b4);
        const float gz = relu(b2 - ez) + relu(ez - b5);
        const bool enter = !outside && !(gx * gx + gy * gy + gz * gz > reach);
        if (enter && a < 0) {
          leaf_range(a, q_first[n], q_count[n]);
          ++n;
        }
        cur = (enter && a >= 0) ? a : skip;
      }
      s_n = n;
      s_cur = cur;
    }
    __syncthreads();  // the round's queue is in place
    const int n = s_n;
    for (int e = 0; e < n; ++e) {
      const int first = q_first[e];
      const int count = min(q_count[e], k_leaf);
      for (int k = 0; k < count; ++k) {
        // Row max(first, 0) + k, slot clip(first + k): they differ only
        // for first = -1, as in the JAX package's test.
        const int slot = clip_slot(first + k, num_slots);
        float u, v;
        const float t = row_mt(tris, max(first, 0) + k, ex, ey, ez, dx, dy,
                                dz, use_eps != 0, t_eps, u, v);
        if (t < bt) {
          bt = t;
          bu = u;
          bv = v;
          bs = slot;
        }
      }
    }
    more = s_cur >= 0;
    __syncthreads();  // every thread has read the queue and the cursor
  }
  out_t[i] = bt;
  out_u[i] = bu;
  out_v[i] = bv;
  out_slot[i] = bs;
}

template <bool kAnyHit>
cudaError_t launch_walk(cudaStream_t stream, const float* nodes,
                        const int* links, const float* tris, int num_slots,
                        const float* origins, const float* dirs,
                        const float* t_max, int num_rays, int max_iters,
                        int use_eps, float t_eps, float* out_t, float* out_u,
                        float* out_v, int* out_slot, bool* out_occluded) {
  if (num_rays == 0) return cudaSuccess;
  walk_kernel<kAnyHit><<<(num_rays + rt::kThreads - 1) / rt::kThreads,
                         rt::kThreads, 0, stream>>>(
      nodes, links, tris, num_slots, origins, dirs, t_max, num_rays,
      max_iters, use_eps, t_eps, out_t, out_u, out_v, out_slot,
      out_occluded);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K, closest hit.  nodes [N, 6], links [N, 2] int32, tris [num_slots, 9];
// origins, dirs [R, 3]; out_t, out_u, out_v [R] float32, out_slot [R]
// int32.  Returns the launch error (0 on success).
int rt_walk_closest(const float* nodes, const int* links, const float* tris,
                    int num_slots, const float* origins, const float* dirs,
                    int num_rays, int max_iters, int use_eps, float t_eps,
                    float* out_t, float* out_u, float* out_v, int* out_slot,
                    void* stream) {
  return static_cast<int>(launch_walk<false>(
      static_cast<cudaStream_t>(stream), nodes, links, tris, num_slots,
      origins, dirs, nullptr, num_rays, max_iters, use_eps, t_eps, out_t,
      out_u, out_v, out_slot, nullptr));
}

// K, any hit: as rt_walk_closest, with t_max [R] float32 and the
// occlusion flags out_occluded [R] bool.
int rt_walk_any(const float* nodes, const int* links, const float* tris,
                int num_slots, const float* origins, const float* dirs,
                const float* t_max, int num_rays, int max_iters, float t_eps,
                bool* out_occluded, void* stream) {
  return static_cast<int>(launch_walk<true>(
      static_cast<cudaStream_t>(stream), nodes, links, tris, num_slots,
      origins, dirs, t_max, num_rays, max_iters, 0, t_eps, nullptr, nullptr,
      nullptr, nullptr, out_occluded));
}

// L.  eye [3]; dirs [height * width, 3] row-major; planes [T, 5, 3] for the
// T = (height / tile_px) * (width / tile_px) tiles; tile_px^2 <= 1024.
// Outputs as rt_walk_closest's, row-major.  Returns the launch error.
int rt_beam(const float* nodes, const int* links, const float* tris,
            int num_slots, const float* eye, const float* dirs,
            const float* planes, int height, int width, int tile_px,
            int queue, int k_leaf, int steps, int use_eps, float t_eps,
            float* out_t, float* out_u, float* out_v, int* out_slot,
            void* stream) {
  if (tile_px < 1 || tile_px * tile_px > 1024 || queue < 1 ||
      height % tile_px || width % tile_px)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (height / tile_px) * (width / tile_px);
  if (tiles == 0) return 0;
  const int threads = tile_px * tile_px;
  const size_t smem = sizeof(int) * 2 * queue + sizeof(float) * threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_kernel<<<tiles, threads, smem, s>>>(
      nodes, links, tris, num_slots, eye, dirs, planes, width, tile_px, queue,
      k_leaf, steps, use_eps, t_eps, out_t, out_u, out_v, out_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
