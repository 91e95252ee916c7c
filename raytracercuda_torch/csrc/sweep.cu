// Kernels A, B, C, F and H of the tile sweep, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (`ops/cuda_build.py`).
//
// A, `sweep_items_kernel<false, true>` + `shade_epilogue_kernel<false>`,
//   replaces `_primary_shade_kernel` in raytracercuda_tpu/trace/
//   pallas_sweep.py: per 16x16 pixel tile, the closest hit of each ray from
//   the common eye (planar [T, 3, R] directions) over the tile's listed
//   128-triangle clusters, and the winner's interpolated normal, albedo,
//   texture id, uv and, when asked, reflectivity.
// F, `sweep_items_kernel<true, true>` + `shade_epilogue_kernel<true>`,
//   replaces `_general_shade_kernel` in raytracercuda_tpu/trace/
//   pallas_bounce.py: A with per-ray origins (planar [T, 3, R]) and an
//   activity mask [T, R], always with reflectivity; inactive rays write
//   the miss defaults.
// C, `sweep_items_kernel<false, false>` + `closest_epilogue_kernel<false,
//   false>`, replaces `_primary_kernel` in pallas_sweep.py: A's sweep
//   without the attributes, on row-major [T, R, 3] directions; writes t,
//   u, v and the winning slot for the differentiable route.  Its epilogue
//   over F's sweep (`rt_closest_rays`) traces ray bundles that are not a
//   pinhole frame.
// B, `occlusion_items_kernel<false>`, replaces `_occlusion_cols_kernel` in
//   pallas_sweep.py: any hit along one light direction from each active
//   ray's origin (planar [T, 3, R] origins).
// H, `occlusion_items_kernel<true>`, replaces `_occlusion_kernel` in the
//   same file: B on row-major [T, R, 3] origins.
//
// What bounds them on the H100: the Moller-Trumbore loop, with each
// triangle read once per block from shared memory.  A tile's listed
// clusters are a few kilobytes each, so the kernels are bound by the FP32
// pipes and by how evenly the work fills the 132 SMs, not by bytes from
// device memory.  Much of a test does not depend on the ray, so each C
// entry first stages those terms once a triangle, in the kernel that fills
// the keys or clears the flags, as a table of 64-byte rows [C, g, 16]:
//   * A and C trace from the common eye: the eye rows hold e1 | e2 |
//     tvec = eye - v0 | qvec = tvec x e1 | tq = e2 . qvec | three zeros,
//     and the pair loop computes pvec, det, the reciprocal, u, v and t =
//     tq / det: 28 FP32 operations and one reciprocal;
//   * B and H trace along the one light l: the light rows hold v0 | e1 |
//     e2 | pvec = l x e2 | 1/det | a degenerate flag (|det| < kDetTiny) |
//     two zeros, and the pair loop skips a flagged triangle (every lane
//     tests the same one) and computes tvec, u, qvec, v and t: 31 FP32
//     operations and no division.
// Each staged term rounds as `mt_tri` rounds it, so every test gives
// `mt_tri`'s t, u and v bit for bit.  F has per-ray origins and
// directions: it sweeps the geometry rows with `mt_tri`.
//
// Each splits every tile's list over many blocks, because one long list
// set the kernel's time (a reflected tile of config 5 lists all 4,027
// clusters) and the hundred or so tiles that list clusters cannot fill the
// card (the bench frame, config 4).  `sweep.split_lists` cuts the lists
// into work items of at most K consecutive clusters; pass 1 runs one block
// per item.  The block stages one cluster at a time, double-buffered with
// cp.async: A, B, C and H the cluster's staged rows, four 16-byte copies a
// triangle; F its 36-byte geometry rows [C, g, 9] as [g][12] rows (v0|e1|e2
// and three pad floats), nine 4-byte copies a triangle.  It tests its
// tile's rays against the cluster.  B, F and H first pack the tile's active
// rays into the leading lanes (a ballot and a prefix), so that a warp with
// no active ray tests nothing, and an item whose tile has no active ray
// leaves before it stages anything.
//
// A, C and F (`sweep_items_kernel`) keep each ray's closest hit over the
// item with a strict `<` and merge it with one 64-bit atomicMin on
// (ordered t, slot) (`hit_key.cuh`): the smallest t wins and, among equal
// t, the smallest slot, which is the first in ascending (cluster, slot)
// order since lists ascend and slot = cluster * g + j.  That is the JAX
// kernels' winner: there, the first minimum wins inside a cluster and
// clusters combine with a strict `<`.  Pass 2, one thread per ray, decodes
// the key and re-runs the same `mt_tri` on the winning triangle, so t, u
// and v are bit-equal to the sweep's; A and F then interpolate the
// winner's attributes from its shade row [C, g, 32].
//
// B and H (`occlusion_items_kernel`) need no second pass: the result is an
// OR over the items.  The C entry clears the flags (in the kernel that
// stages the light rows), then a lane stops at
// its ray's first hit and stores the flag (a plain store: every writer
// writes the same 1).  A ray that another item has already flagged is not
// packed, and a lane re-reads its flag at each cluster, so a ray stops
// testing once any item finds its hit; the block leaves its item when
// every lane is done.  The two differ only in the origins' layout.
//
// The library is built with -fmad=false and IEEE division, so each
// expression rounds as in the plain PyTorch version.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "launch.cuh"

namespace {

constexpr int kCols = 32;     // floats per shade-block row (A, F)
constexpr int kGeomCols = 9;  // floats per geometry row (every sweep)
constexpr int kRowFloats = 12;  // floats per triangle F stages
constexpr int kStagedVecs = 4;  // float4s per eye or light row
constexpr int kMaxRays = 1024;  // rays per tile a sweep block can take
constexpr float kDetTiny = 1.1754944e-38f;

// Moller-Trumbore of one ray against the triangle v0|e1|e2, in the
// operation order of `_mt_cols` (pallas_sweep.py:707-732).  Returns t,
// FLT_MAX on miss.
__device__ __forceinline__ float mt_tri(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        bool use_eps, float t_eps, float& u,
                                        float& v) {
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

// `mt_tri` against a v0|e1|e2 row in device memory.
__device__ __forceinline__ float mt_row(const float* w, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, bool use_eps, float t_eps,
                                        float& u, float& v) {
  return mt_tri(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], ox,
                oy, oz, dx, dy, dz, use_eps, t_eps, u, v);
}

// `mt_tri`'s t for a ray from the common eye along d, against a triangle
// whose eye terms are staged (`fill_keys_kernel` below): e1, e2, tvec,
// qvec and tq from its eye row.  Only the ray's terms are computed here,
// in `mt_tri`'s order and with its miss rule.
__device__ __forceinline__ float eye_tri(float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z,
                                         float tvx, float tvy, float tvz,
                                         float qvx, float qvy, float qvz,
                                         float tq, float dx, float dy,
                                         float dz, bool use_eps,
                                         float t_eps) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / det;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  const float t = tq * inv;
  bool miss = (u < 0.0f) | (u > 1.0f) | (v < 0.0f) | (u + v > 1.0f) |
              (fabsf(det) < kDetTiny);
  if (use_eps) miss |= t < t_eps;
  return miss ? kFltMax : t;
}

// Whether `mt_tri` with t_eps finds a hit for a ray from o along the
// common light d, against a triangle whose light terms are staged
// (`clear_flags_kernel` below): v0, e1, e2, pvec and 1/det from its light
// row.  The caller skips a flagged row, whose |det| < kDetTiny is
// `mt_tri`'s miss; here that term of the rule is false.
__device__ __forceinline__ bool light_hit(float v0x, float v0y, float v0z,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          float pvx, float pvy, float pvz,
                                          float inv, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float t_eps) {
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  const bool miss = (u < 0.0f) | (u > 1.0f) | (v < 0.0f) |
                    (u + v > 1.0f) | (t < t_eps);
  return !miss && t < kFltMax;
}

// The winner's attribute planes 1.. of [n_f, T, R] at ray `o` (planes
// `plane` floats apart): u, v, nx, ny, nz, ar, ag, ab[, tex, tu, tv][,
// refl] from its shade row; zeros on a miss.  Plane 0 (t) and the slot
// are the caller's.
__device__ __forceinline__ void write_attributes(
    float* __restrict__ out_f, size_t plane, size_t o, float bt, float bu,
    float bv, int bs, const float* __restrict__ blocks, int has_uv,
    int with_refl) {
  const int n_f = (has_uv ? 12 : 9) + (with_refl ? 1 : 0);
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

// Starts the copy of cluster `c`'s geometry rows [g, 9] into `s` as [g][12]
// rows, 4-byte cp.async copies, and commits them as one group.
__device__ __forceinline__ void stage_cluster(float* s,
                                              const float* __restrict__ geom,
                                              int c, int g) {
  const float* src = geom + static_cast<size_t>(c) * g * kGeomCols;
  for (int e = threadIdx.x; e < kGeomCols * g; e += blockDim.x) {
    const int j = e / kGeomCols;
    __pipeline_memcpy_async(s + j * kRowFloats + (e - j * kGeomCols),
                            src + e, sizeof(float));
  }
  __pipeline_commit();
}

// Starts the copy of cluster `c`'s staged rows [g, 16] (eye or light rows)
// into `s`, four 16-byte cp.async copies a triangle, and commits them as
// one group.
__device__ __forceinline__ void stage_rows(float4* s,
                                           const float4* __restrict__ rows,
                                           int c, int g) {
  const float4* src = rows + static_cast<size_t>(c) * g * kStagedVecs;
  for (int e = threadIdx.x; e < kStagedVecs * g; e += blockDim.x)
    __pipeline_memcpy_async(s + e, src + e, sizeof(float4));
  __pipeline_commit();
}

// The block's rays whose `act` is set, in ray order, packed into lanes
// 0 .. n_act - 1: a ballot per warp and a prefix over the warps.
// blockDim.x is a multiple of 32 and every thread calls it.  Returns this
// lane's ray, -1 from lane n_act on; n_act is the same in every thread.
__device__ __forceinline__ int pack_rays(bool act, int* s_ray, int* s_warp,
                                         int& n_act) {
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const unsigned int ballot = __ballot_sync(0xffffffffu, act);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  n_act = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    n_act += c;
  }
  if (n_act == 0) return -1;
  if (act) s_ray[before + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return i < n_act ? s_ray[i] : -1;
}

// Pass 1 of A, C and F.  Grid: one block per work item, items [3,
// num_items] int32 rows (tile, first, end: list positions [first, end) of
// the tile's CSR list, empty past the real item count); block: R threads,
// the tile's rays.  kPerRay: planar per-ray origins [T, 3, R] and activity
// [T, R] (F; active rays packed into the leading lanes) over the geometry
// rows [C, g, 9], or the common eye (A, C) over its eye rows [C, g, 16]
// (`rows`).  kPlanar: directions planar [T, 3, R] (A, F) or row-major
// [T, R, 3] (C).  Merges each ray's closest hit over the item into keys
// [T * R].
template <bool kPerRay, bool kPlanar>
__global__ void sweep_items_kernel(
    const int* __restrict__ items, int num_items, const int* __restrict__ ids,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const int* __restrict__ active, const float* __restrict__ rows, int g,
    int use_eps, float t_eps, unsigned long long* __restrict__ keys) {
  // Two buffers of [g][12] floats (F) or [g][16] (A, C).
  extern __shared__ float4 s_rows[];
  const int first = items[num_items + blockIdx.x];
  const int end = items[2 * num_items + blockIdx.x];
  if (first >= end) return;
  const int tile = items[blockIdx.x];
  const int R = blockDim.x;
  const int i = threadIdx.x;

  int ray = i;
  if constexpr (kPerRay) {
    __shared__ int s_ray[kMaxRays];
    __shared__ int s_warp[kMaxRays / 32];
    int n_act;
    ray = pack_rays(active[static_cast<size_t>(tile) * R + i] != 0, s_ray,
                    s_warp, n_act);
    if (n_act == 0) return;  // the whole block: it stages nothing
  }
  const bool has_ray = ray >= 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (has_ray) {
    if constexpr (kPerRay) {
      const float* org = origins + static_cast<size_t>(tile) * 3 * R;
      ox = org[ray];
      oy = org[R + ray];
      oz = org[2 * R + ray];
    }
    if constexpr (kPlanar) {
      const float* d = dirs + static_cast<size_t>(tile) * 3 * R;
      dx = d[ray];
      dy = d[R + ray];
      dz = d[2 * R + ray];
    } else {
      const float* d = dirs + (static_cast<size_t>(tile) * R + ray) * 3;
      dx = d[0];
      dy = d[1];
      dz = d[2];
    }
  }

  constexpr int kVecs = kPerRay ? kRowFloats / 4 : kStagedVecs;
  const int buf = g * kVecs;  // float4s a buffer
  const float4* staged = reinterpret_cast<const float4*>(rows);
  const auto stage = [&](int r) {
    float4* s = s_rows + (r & 1) * buf;
    if constexpr (kPerRay)
      stage_cluster(reinterpret_cast<float*>(s), rows, ids[first + r], g);
    else
      stage_rows(s, staged, ids[first + r], g);
  };
  const int n = end - first;
  float bt = kFltMax;
  int bs = 0;
  stage(0);
  for (int r = 0; r < n; ++r) {
    // The other buffer was freed by the barrier that ended step r - 1.
    if (r + 1 < n)
      stage(r + 1);
    else
      __pipeline_commit();  // an empty group keeps the count of groups
    __pipeline_wait_prior(1);  // this thread's copies of cluster r landed
    __syncthreads();           // and every other thread's
    if (has_ray) {
      const int c = ids[first + r];
      const float4* w = s_rows + (r & 1) * buf;
#pragma unroll 4
      for (int j = 0; j < g; ++j) {
        const float4 a = w[kVecs * j];
        const float4 b = w[kVecs * j + 1];
        const float4 e = w[kVecs * j + 2];
        float t;
        if constexpr (kPerRay) {
          float u, v;
          t = mt_tri(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, ox, oy, oz,
                     dx, dy, dz, use_eps != 0, t_eps, u, v);
        } else {
          // e1 | e2 | tvec | qvec | tq
          t = eye_tri(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y, e.z,
                      e.w, w[kVecs * j + 3].x, dx, dy, dz, use_eps != 0,
                      t_eps);
        }
        if (t < bt) {
          bt = t;
          bs = c * g + j;
        }
      }
    }
    __syncthreads();  // every thread is done with buffer r & 1
  }
  if (has_ray && bt < kFltMax)
    atomicMin(keys + static_cast<size_t>(tile) * R + ray, hit_key(bt, bs));
}

// Pass 2's view of one ray: its key decoded, and on a hit t, u, v
// recomputed on the winning geometry row with pass 1's `mt_tri`.  Returns
// whether the ray hit; on a miss t = FLT_MAX, u = v = 0, slot 0.
template <bool kPerRay, bool kPlanar>
__device__ __forceinline__ bool decode_hit(
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ geom, size_t o, int R, int use_eps,
    float t_eps, float& t, float& u, float& v, int& slot) {
  const unsigned long long key = keys[o];
  t = kFltMax;
  u = 0.0f;
  v = 0.0f;
  slot = 0;
  if (key >= kMissKey) return false;
  slot = static_cast<int>(static_cast<unsigned int>(key));
  const size_t tile = o / R;
  const size_t i = o - tile * R;
  float ox, oy, oz, dx, dy, dz;
  if constexpr (kPerRay) {
    const float* org = origins + tile * 3 * R;
    ox = org[i];
    oy = org[R + i];
    oz = org[2 * R + i];
  } else {
    ox = origins[0];
    oy = origins[1];
    oz = origins[2];
  }
  if constexpr (kPlanar) {
    const float* d = dirs + tile * 3 * R;
    dx = d[i];
    dy = d[R + i];
    dz = d[2 * R + i];
  } else {
    dx = dirs[o * 3];
    dy = dirs[o * 3 + 1];
    dz = dirs[o * 3 + 2];
  }
  t = mt_row(geom + static_cast<size_t>(slot) * kGeomCols, ox, oy, oz, dx,
             dy, dz, use_eps != 0, t_eps, u, v);
  return true;
}

// Pass 2 of C (and of the ray-bundle route): one thread per ray of
// [T, R]; out_f planes [3, T, R]: t, u, v; out_slot [T, R].
template <bool kPerRay, bool kPlanar>
__global__ void closest_epilogue_kernel(
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ geom, long long num_rays, int R, int use_eps,
    float t_eps, float* __restrict__ out_f, int* __restrict__ out_slot) {
  const long long o = rt::thread_index();
  if (o >= num_rays) return;
  float t, u, v;
  int slot;
  decode_hit<kPerRay, kPlanar>(keys, origins, dirs, geom, o, R, use_eps,
                               t_eps, t, u, v, slot);
  out_f[o] = t;
  out_f[num_rays + o] = u;
  out_f[2 * num_rays + o] = v;
  out_slot[o] = slot;
}

// Pass 2 of A and F: one thread per ray of [T, R]; planar directions, and
// the common eye [3] (A) or planar per-ray origins (F, kPerRay); out_f
// planes [n_f, T, R]: t, u, v, nx, ny, nz, ar, ag, ab[, tex, tu, tv][,
// refl], the attributes from shade rows [C, g, 32]; out_slot [T, R].
template <bool kPerRay>
__global__ void shade_epilogue_kernel(
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ blocks,
    long long num_rays, int R, int has_uv, int with_refl, int use_eps,
    float t_eps, float* __restrict__ out_f, int* __restrict__ out_slot) {
  const long long o = rt::thread_index();
  if (o >= num_rays) return;
  float t, u, v;
  int slot;
  decode_hit<kPerRay, true>(keys, origins, dirs, geom, o, R, use_eps, t_eps,
                            t, u, v, slot);
  out_slot[o] = slot;
  out_f[o] = t;
  write_attributes(out_f, num_rays, o, t, u, v, slot, blocks, has_uv,
                   with_refl);
}

// keys[0, n) = the miss key, and A's and C's eye rows [faces][16] of the
// geometry rows [faces][9] from the common eye [3]: e1 | e2 | tvec = eye -
// v0 | qvec = tvec x e1 | tq = e2 . qvec | three zeros, each rounded as
// `mt_tri` rounds it.  An overload of F's and E's key fill
// (`hit_key.cuh`), under the one kernel name the benchmark's readers
// match (`portbench/roofline.py`, `metrics/sweep_ms.*`).
__global__ void fill_keys_kernel(unsigned long long* __restrict__ keys,
                                 long long n, const float* __restrict__ eye,
                                 const float* __restrict__ geom,
                                 long long faces,
                                 float4* __restrict__ eye_rows) {
  const float ox = eye[0], oy = eye[1], oz = eye[2];
  const long long m = n > faces ? n : faces;
  for (long long i = rt::thread_index(); i < m; i += rt::thread_count()) {
    if (i < n) keys[i] = kMissKey;
    if (i >= faces) continue;
    const float* w = geom + i * kGeomCols;
    const float e1x = w[3], e1y = w[4], e1z = w[5];
    const float e2x = w[6], e2y = w[7], e2z = w[8];
    const float tvx = ox - w[0], tvy = oy - w[1], tvz = oz - w[2];
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float tq = e2x * qvx + e2y * qvy + e2z * qvz;
    float4* out = eye_rows + i * kStagedVecs;
    out[0] = make_float4(e1x, e1y, e1z, e2x);
    out[1] = make_float4(e2y, e2z, tvx, tvy);
    out[2] = make_float4(tvz, qvx, qvy, qvz);
    out[3] = make_float4(tq, 0.0f, 0.0f, 0.0f);
  }
}

// Fills the keys (A and C: and stages the eye rows `eye_rows` [C, g, 16]
// from the geometry rows; F: nullptr), then runs pass 1 over the items.
template <bool kPerRay, bool kPlanar>
cudaError_t launch_sweep(const int* items, int num_items, const int* ids,
                         const float* origins, const float* dirs,
                         const int* active, const float* geom,
                         float* eye_rows, int num_clusters, long long n,
                         int R, int g, int use_eps, float t_eps,
                         unsigned long long* keys, cudaStream_t stream) {
  const float* rows = geom;
  if constexpr (kPerRay) {
    fill_keys_kernel<<<rt::card_grid(n), rt::kThreads, 0, stream>>>(keys, n);
  } else {
    const long long faces = static_cast<long long>(num_clusters) * g;
    fill_keys_kernel<<<rt::card_grid(n > faces ? n : faces), rt::kThreads,
                       0, stream>>>(keys, n, origins, geom, faces,
                                    reinterpret_cast<float4*>(eye_rows));
    rows = eye_rows;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_items == 0) return err;
  const size_t smem =
      sizeof(float) * 2 * g * (kPerRay ? kRowFloats : 4 * kStagedVecs);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sweep_items_kernel<kPerRay, kPlanar>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sweep_items_kernel<kPerRay, kPlanar><<<num_items, R, smem, stream>>>(
      items, num_items, ids, origins, dirs, active, rows, g, use_eps, t_eps,
      keys);
  return cudaGetLastError();
}

// Pass 2's grid: one thread per ray.
inline int ray_blocks(long long n) {
  return static_cast<int>((n + rt::kThreads - 1) / rt::kThreads);
}

// ---------------------------------------------------------------------------
// B and H: the split any-hit.
// ---------------------------------------------------------------------------

// flags[0, n) = 0, and B's and H's light rows [faces][16] of the geometry
// rows [faces][9] along the unit light [3]: v0 | e1 | e2 | pvec = l x e2 |
// inv = 1/det | flag | two zeros, with det = e1 . pvec rounded as `mt_tri`
// rounds it and flag 1.0 where |det| < kDetTiny (`mt_tri`'s miss for
// every ray), else 0.0.
__global__ void clear_flags_kernel(bool* __restrict__ flags, long long n,
                                   const float* __restrict__ light,
                                   const float* __restrict__ geom,
                                   long long faces,
                                   float4* __restrict__ light_rows) {
  const float dx = light[0], dy = light[1], dz = light[2];
  const long long m = n > faces ? n : faces;
  for (long long i = rt::thread_index(); i < m; i += rt::thread_count()) {
    if (i < n) flags[i] = false;
    if (i >= faces) continue;
    const float* w = geom + i * kGeomCols;
    const float e1x = w[3], e1y = w[4], e1z = w[5];
    const float e2x = w[6], e2y = w[7], e2z = w[8];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv = 1.0f / det;
    float4* out = light_rows + i * kStagedVecs;
    out[0] = make_float4(w[0], w[1], w[2], e1x);
    out[1] = make_float4(e1y, e1z, e2x, e2y);
    out[2] = make_float4(e2z, pvx, pvy, pvz);
    out[3] = make_float4(inv, fabsf(det) < kDetTiny ? 1.0f : 0.0f, 0.0f,
                         0.0f);
  }
}

// Any hit along `light` over one work item (kernels B and H).  Grid: one
// block per item, items [3, num_items] as in `sweep_items_kernel`; block:
// the tile's R rays rounded up to a multiple of 32 (lanes from R on hold
// no ray).  kRowMajor: origins [T, R, 3] (H)
// or planar [T, 3, R] (B).  active [T, R] bool; occ [T, R] bool, cleared
// before the launch, set where an item finds a hit.  A ray takes part when
// it is active and not yet flagged; its lane stops at its first hit, or
// when another item has flagged it, and the block leaves the item once
// every lane has stopped.  Each test is `light_hit` on the light rows
// [C, g, 16] (`clear_flags_kernel`): `mt_tri` with t_eps, as in the JAX
// kernels.
template <bool kRowMajor>
__global__ void occlusion_items_kernel(
    const int* __restrict__ items, int num_items, const int* __restrict__ ids,
    const float* __restrict__ light, const float* __restrict__ origins,
    const bool* __restrict__ active, const float4* __restrict__ light_rows,
    int R, int g, float t_eps, bool* occ) {
  extern __shared__ float4 s_rows[];  // two buffers of [g][16] floats
  __shared__ int s_ray[kMaxRays];
  __shared__ int s_warp[kMaxRays / 32];
  const int first = items[num_items + blockIdx.x];
  const int end = items[2 * num_items + blockIdx.x];
  if (first >= end) return;
  const int tile = items[blockIdx.x];
  const int i = threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * R;
  // Flags that other blocks store are read past the L1 (ld.global.cg).
  const bool act = i < R && active[row + i] &&
                   !__ldcg(reinterpret_cast<const unsigned char*>(occ) +
                           row + i);
  int n_act;
  const int ray = pack_rays(act, s_ray, s_warp, n_act);
  if (n_act == 0) return;  // the whole block: it stages nothing

  const unsigned char* flag =
      reinterpret_cast<const unsigned char*>(occ) + row + (ray < 0 ? 0 : ray);
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (ray >= 0) {
    if constexpr (kRowMajor) {
      const float* org = origins + (row + ray) * 3;
      ox = org[0];
      oy = org[1];
      oz = org[2];
    } else {
      const float* org = origins + row * 3;
      ox = org[ray];
      oy = org[R + ray];
      oz = org[2 * R + ray];
    }
  }
  const float dx = light[0], dy = light[1], dz = light[2];

  const int buf = g * kStagedVecs;  // float4s a buffer
  const int n = end - first;
  bool done = ray < 0;
  stage_rows(s_rows, light_rows, ids[first], g);
  for (int r = 0; r < n; ++r) {
    // The other buffer was freed by the barrier that ended step r - 1.
    if (r + 1 < n)
      stage_rows(s_rows + ((r + 1) & 1) * buf, light_rows,
                 ids[first + r + 1], g);
    else
      __pipeline_commit();  // an empty group keeps the count of groups
    if (!done && r > 0) done = __ldcg(flag) != 0;  // another item's hit
    __pipeline_wait_prior(1);  // this thread's copies of cluster r landed
    __syncthreads();           // and every other thread's
    if (!done) {
      const float4* w = s_rows + (r & 1) * buf;
#pragma unroll 4
      for (int j = 0; j < g; ++j) {
        const float4 d = w[kStagedVecs * j + 3];  // inv | flag | 0 | 0
        if (d.y != 0.0f) continue;  // degenerate: the same row in every lane
        const float4 a = w[kStagedVecs * j];      // v0 | e1x
        const float4 b = w[kStagedVecs * j + 1];  // e1yz | e2xy
        const float4 e = w[kStagedVecs * j + 2];  // e2z | pvec
        if (light_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y, e.z,
                      e.w, d.x, ox, oy, oz, dx, dy, dz, t_eps)) {
          occ[row + ray] = true;
          done = true;
          break;
        }
      }
    }
    // Also the barrier after which buffer r & 1 may be overwritten.
    if (__syncthreads_and(done)) break;
  }
  __pipeline_wait_prior(0);  // no copy outlives the block
}

// Clears the flags and stages the light rows `light_rows` [C, g, 16] from
// the geometry rows, then runs the any-hit over the items.
template <bool kRowMajor>
cudaError_t launch_occlusion(const int* items, int num_items, const int* ids,
                             const float* light, const float* origins,
                             const bool* active, const float* geom,
                             float* light_rows, int num_clusters,
                             long long n, int R, int g, float t_eps,
                             bool* occ, cudaStream_t stream) {
  if (R > kMaxRays) return cudaErrorInvalidValue;
  const long long faces = static_cast<long long>(num_clusters) * g;
  float4* rows = reinterpret_cast<float4*>(light_rows);
  clear_flags_kernel<<<rt::card_grid(n > faces ? n : faces), rt::kThreads,
                       0, stream>>>(occ, n, light, geom, faces, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_items == 0) return err;
  const size_t smem = sizeof(float4) * 2 * g * kStagedVecs;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(occlusion_items_kernel<kRowMajor>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (R + 31) / 32 * 32;
  occlusion_items_kernel<kRowMajor><<<num_items, threads, smem, stream>>>(
      items, num_items, ids, light, origins, active, rows, R, g, t_eps, occ);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the first launch error (0 on success).  Every sweep takes
// work items [3, num_items] int32 from `sweep.split_lists`, the lists' ids
// and geometry rows [C, g, 9]; A, C, F and the ray bundles also keys
// [T * R] of scratch; A and C eye rows, B and H light rows [C, g, 16] of
// scratch, written before the sweep.  R is at most 1024 and, for F and the
// bundles, a multiple of 32.

// Kernel A: the common eye [3], planar directions [T, 3, R]; out_f
// [n_f, T, R] with shade rows `blocks` [C, g, 32].
int rt_primary_shade(const int* items, int num_items, const int* ids,
                     const float* eye, const float* dirs, const float* geom,
                     const float* blocks, int num_clusters, int num_tiles,
                     int rays_per_tile, int g, int has_uv, int with_refl,
                     int use_eps, float t_eps, unsigned long long* keys,
                     float* eye_rows, float* out_f, int* out_slot,
                     void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sweep<false, true>(
      items, num_items, ids, eye, dirs, nullptr, geom, eye_rows,
      num_clusters, n, rays_per_tile, g, use_eps, t_eps, keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_epilogue_kernel<false><<<ray_blocks(n), rt::kThreads, 0, s>>>(
      keys, eye, dirs, geom, blocks, n, rays_per_tile, has_uv, with_refl,
      use_eps, t_eps, out_f, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Kernel F: planar origins and directions [T, 3, R], activity [T, R];
// out_f [n_f, T, R] with shade rows `blocks` [C, g, 32].
int rt_general_shade(const int* items, int num_items, const int* ids,
                     const float* origins, const float* dirs,
                     const int* active, const float* geom,
                     const float* blocks, int num_tiles, int rays_per_tile,
                     int g, int has_uv, int use_eps, float t_eps,
                     unsigned long long* keys, float* out_f, int* out_slot,
                     void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sweep<true, true>(
      items, num_items, ids, origins, dirs, active, geom, nullptr, 0, n,
      rays_per_tile, g, use_eps, t_eps, keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_epilogue_kernel<true><<<ray_blocks(n), rt::kThreads, 0, s>>>(
      keys, origins, dirs, geom, blocks, n, rays_per_tile, has_uv, 1,
      use_eps, t_eps, out_f, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B: the unit light [3], planar origins [T, 3, R], activity
// [T, R] bool; occ [T, R] bool.  R may be any count from 1 to 1024.
int rt_occlusion(const int* items, int num_items, const int* ids,
                 const float* light, const float* origins, const bool* active,
                 const float* geom, int num_clusters, int num_tiles,
                 int rays_per_tile, int g, float t_eps, float* light_rows,
                 bool* occ, void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  return static_cast<int>(launch_occlusion<false>(
      items, num_items, ids, light, origins, active, geom, light_rows,
      num_clusters, n, rays_per_tile, g, t_eps, occ,
      static_cast<cudaStream_t>(stream)));
}

// Kernel C: the common eye [3], row-major directions [T, R, 3]; out_f
// [3, T, R].
int rt_primary(const int* items, int num_items, const int* ids,
               const float* eye, const float* dirs, const float* geom,
               int num_clusters, int num_tiles, int rays_per_tile, int g,
               int use_eps, float t_eps, unsigned long long* keys,
               float* eye_rows, float* out_f, int* out_slot, void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sweep<false, false>(
      items, num_items, ids, eye, dirs, nullptr, geom, eye_rows,
      num_clusters, n, rays_per_tile, g, use_eps, t_eps, keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_epilogue_kernel<false, false><<<ray_blocks(n), rt::kThreads, 0, s>>>(
      keys, eye, dirs, geom, n, rays_per_tile, use_eps, t_eps, out_f,
      out_slot);
  return static_cast<int>(cudaGetLastError());
}

// C's epilogue over F's sweep: planar origins and directions [T, 3, R],
// activity [T, R]; out_f [3, T, R].
int rt_closest_rays(const int* items, int num_items, const int* ids,
                    const float* origins, const float* dirs,
                    const int* active, const float* geom, int num_tiles,
                    int rays_per_tile, int g, int use_eps, float t_eps,
                    unsigned long long* keys, float* out_f, int* out_slot,
                    void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sweep<true, true>(
      items, num_items, ids, origins, dirs, active, geom, nullptr, 0, n,
      rays_per_tile, g, use_eps, t_eps, keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_epilogue_kernel<true, true><<<ray_blocks(n), rt::kThreads, 0, s>>>(
      keys, origins, dirs, geom, n, rays_per_tile, use_eps, t_eps, out_f,
      out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Kernel H: B on row-major origins [T, R, 3].
int rt_occlusion_rows(const int* items, int num_items, const int* ids,
                      const float* light, const float* origins,
                      const bool* active, const float* geom,
                      int num_clusters, int num_tiles, int rays_per_tile,
                      int g, float t_eps, float* light_rows, bool* occ,
                      void* stream) {
  const long long n = static_cast<long long>(num_tiles) * rays_per_tile;
  if (n == 0) return 0;
  return static_cast<int>(launch_occlusion<true>(
      items, num_items, ids, light, origins, active, geom, light_rows,
      num_clusters, n, rays_per_tile, g, t_eps, occ,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
