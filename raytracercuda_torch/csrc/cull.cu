// The three tile culls, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (`ops/cuda_build.py`).  They replace no TPU kernel:
// the JAX package culls with XLA ops (raytracercuda_tpu/trace/dense.py's
// `_cull_frustum`, occlusion_cull.py's `beam_survive_matrix`,
// pallas_bounce.py's `general_tile_cull`), and the port's plain chains of
// the same ops took ~80, ~97 and ~100 PyTorch launches a cull.  Each
// kernel writes the [T, C] bool survive mask that its chain writes, in one
// launch; `sweep._tile_lists` compacts it as before.
//
// frustum_cull_kernel<kRowMajor> (`sweep.frustum_cull`, before A and C):
//   a tile's pinhole beam from the common eye, as `dense.frustum_planes`
//   builds it: four inward corner planes (cross products, each turned to
//   the mean direction's side, a zero sign counting as +1) and the mean
//   direction itself.  A cluster box survives when its p-vertex lies on
//   the inner side of all five: n.(mid - eye) + |n|.half >= 0.
// beam_cull_kernel<kRowMajor> (`sweep.beam_cull`, before B and H): the box
//   of a tile's active shadow-ray origins swept along the light, as
//   `occlusion_cull.swept_tile_beams` and `beam_survive_matrix` do: a
//   cluster box survives when its projection overlaps the beam's on the
//   two axes across the light (`light_basis`'s u and v), it is not wholly
//   behind every origin along l, and the tile has an active ray.
// kRowMajor picks the input layout: row-major [T, R, 3] (C, H) or planar
// [T, 3, R] (A, B).
// general_cull_kernel (`bounce_sweep.general_tile_cull`, before F and the
//   ray bundles' sweep): tiles of arbitrary rays, planar [T, 3, R] origins
//   and unit directions with [T, R] activity, as `_general_cull_plain`
//   culls them over the active rays: per axis, a box wholly below the
//   origins' minimum while every direction climbs (or above their maximum
//   while every direction falls) is unreachable; and, while the
//   directions fit in a half-space (cos_min > 0 around their unit mean
//   m), a box survives when sup over its offsets from the origins' box
//   along m reaches cos_min times its gap to that box.  A tile with no
//   active ray culls everything.
//
// One block of kThreads a tile.  The block reads its tile's 3R floats (and
// R active bytes) once, coalesced, and reduces them in a fixed tree order;
// then its threads stride over the clusters and write one mask byte a
// (tile, cluster), consecutive threads on consecutive bytes.  What bounds
// them on the H100: bytes, T x 3 x R x 4 read and T x C written (the
// cluster boxes, 24 bytes each, come from L2 for every block).  The work
// is T x C box tests of ~40 FP32 operations, about 22 M tests at
// T = 1,024, C = 543.  The chains' [T * 5, 6] @ [6, C] product and its
// [T, 5, C] float32 intermediate (224 MB at 1024x1024) are gone.  The
// general cull reads origins and directions, 2 x T x 3 x R x 4 bytes, and
// runs ~45 operations a pair, 32.9 M pairs at T = 8,160, C = 4,027 (a
// 1920x1088 bounce).
//
// The library is built with -fmad=false, and every expression follows the
// chain's float32 operations term by term.  Two parts of the chain have
// no order to follow: torch's `mean` and `sum` (their own reduction
// order; here a fixed tree, and for the mean times 1/R as torch's mean
// multiplies by its factor) and the dot products it leaves to `mm` and
// `mv` (cuBLAS on the card; here each three-term dot left to right, and
// the frustum's distance the centre terms' sum plus the half-extent
// terms' sum).  A mask entry can therefore differ from the chain's only
// where a plane, interval or cone test is within rounding of its
// threshold.  The light direction is read through a device pointer and
// made unit here as `light_basis` makes l (its norm a three-term dot,
// where torch's `vector_norm` has its own order); u and v are made from
// l.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = rt::kThreads;
// The box of an inactive ray, as `swept_tile_beams` pads it.
constexpr float kBig = 3.0e37f;

template <bool kRowMajor>
__device__ __forceinline__ float at(const float* __restrict__ tile, int k,
                                    int r, int R) {
  return kRowMajor ? tile[r * 3 + k] : tile[k * R + r];
}

// `ops/math.cross`'s term order.
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* n) {
  n[0] = a[1] * b[2] - a[2] * b[1];
  n[1] = a[2] * b[0] - a[0] * b[2];
  n[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// torch's amin and amax: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// `occlusion_cull.box_interval`: the projection of the box [bmin, bmax]
// onto a unit axis with components `a` and magnitudes `abs_a`.
__device__ __forceinline__ void box_interval(const float* bmin,
                                             const float* bmax,
                                             const float* a,
                                             const float* abs_a, float* lo,
                                             float* hi) {
  float c[3], h[3];
  for (int k = 0; k < 3; ++k) {
    c[k] = (bmin[k] + bmax[k]) * 0.5f;
    h[k] = (bmax[k] - bmin[k]) * 0.5f;
  }
  const float pc = dot3(c, a);
  const float ph = dot3(h, abs_a);
  *lo = pc - ph;
  *hi = pc + ph;
}

// Sums v[k][tid] over the block's threads in a fixed tree order; every
// thread returns with v[k][0] the sum.
__device__ __forceinline__ void block_sum3(float (*v)[kThreads]) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      for (int k = 0; k < 3; ++k) v[k][threadIdx.x] += v[k][threadIdx.x + s];
    }
  }
  __syncthreads();
}

template <bool kRowMajor>
__global__ void __launch_bounds__(kThreads) frustum_cull_kernel(
    const float* __restrict__ dirs, int R, int tile_px,
    const float* __restrict__ eye, const float* __restrict__ cmin,
    const float* __restrict__ cmax, int C, bool* __restrict__ out) {
  __shared__ float s_sum[3][kThreads];
  const int tile = blockIdx.x;
  const float* d = dirs + static_cast<size_t>(tile) * 3 * R;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int r = threadIdx.x; r < R; r += kThreads) {
    for (int k = 0; k < 3; ++k) acc[k] += at<kRowMajor>(d, k, r, R);
  }
  for (int k = 0; k < 3; ++k) s_sum[k][threadIdx.x] = acc[k];
  block_sum3(s_sum);

  // `frustum_planes(c00, c01, c10, c11, mean)`, in every thread.
  const float factor = 1.0f / static_cast<float>(R);
  float mean[3];
  for (int k = 0; k < 3; ++k) mean[k] = s_sum[k][0] * factor;
  const int corner[4] = {0, tile_px - 1, R - 1, R - tile_px};  // 00 01 11 10
  float c[4][3];
  for (int i = 0; i < 4; ++i) {
    for (int k = 0; k < 3; ++k) c[i][k] = at<kRowMajor>(d, k, corner[i], R);
  }
  float n[5][3], abs_n[5][3];
  for (int p = 0; p < 4; ++p) {
    cross3(c[p], c[(p + 1) % 4], n[p]);
    const float dn = dot3(n[p], mean);
    // torch.sign ((0 < x) - (x < 0): 0 for a NaN), then where(s == 0, 1,
    // s): only a negative dot product flips the plane.
    const float s = dn < 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) n[p][k] = n[p][k] * s;
  }
  for (int k = 0; k < 3; ++k) n[4][k] = mean[k];
  for (int p = 0; p < 5; ++p) {
    for (int k = 0; k < 3; ++k) abs_n[p][k] = fabsf(n[p][k]);
  }
  const float e[3] = {eye[0], eye[1], eye[2]};

  bool* row = out + static_cast<size_t>(tile) * C;
  for (int j = threadIdx.x; j < C; j += kThreads) {
    float mid[3], half[3];
    for (int k = 0; k < 3; ++k) {
      const float lo = cmin[j * 3 + k];
      const float hi = cmax[j * 3 + k];
      mid[k] = (lo + hi) * 0.5f - e[k];
      half[k] = (hi - lo) * 0.5f;
    }
    bool keep = true;
    for (int p = 0; p < 5; ++p) {
      const float dist = dot3(n[p], mid) + dot3(abs_n[p], half);
      keep = keep && dist >= 0.0f;  // false on NaN, as amin's NaN is
    }
    row[j] = keep;
  }
}

template <bool kRowMajor>
__global__ void __launch_bounds__(kThreads) beam_cull_kernel(
    const float* __restrict__ origins, const bool* __restrict__ active,
    int R, const float* __restrict__ light_dir,
    const float* __restrict__ cmin,
    const float* __restrict__ cmax, int C, bool* __restrict__ out) {
  __shared__ float s_min[3][kThreads];
  __shared__ float s_max[3][kThreads];
  const int tile = blockIdx.x;
  const float* o = origins + static_cast<size_t>(tile) * 3 * R;
  const bool* act = active + static_cast<size_t>(tile) * R;

  // The active origins' box; min and max are exact in any order.
  float lo[3] = {kBig, kBig, kBig};
  float hi[3] = {-kBig, -kBig, -kBig};
  int any = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    if (act[r]) {
      any = 1;
      for (int k = 0; k < 3; ++k) {
        const float x = at<kRowMajor>(o, k, r, R);
        lo[k] = min_nan(lo[k], x);
        hi[k] = max_nan(hi[k], x);
      }
    }
  }
  for (int k = 0; k < 3; ++k) {
    s_min[k][threadIdx.x] = lo[k];
    s_max[k][threadIdx.x] = hi[k];
  }
  const bool tile_any = __syncthreads_or(any);
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int k = 0; k < 3; ++k) {
        s_min[k][threadIdx.x] =
            min_nan(s_min[k][threadIdx.x], s_min[k][threadIdx.x + s]);
        s_max[k][threadIdx.x] =
            max_nan(s_max[k][threadIdx.x], s_max[k][threadIdx.x + s]);
      }
    }
    __syncthreads();
  }
  bool* row = out + static_cast<size_t>(tile) * C;
  if (!tile_any) {
    for (int j = threadIdx.x; j < C; j += kThreads) row[j] = false;
    return;
  }

  // `light_basis`: l = light_dir made unit, u = cross(l, ex or ey) made
  // unit, v = cross(l, u).
  float ax[3][3], abs_ax[3][3];  // u, v, l
  const float ld[3] = {light_dir[0], light_dir[1], light_dir[2]};
  const float norm = sqrtf(dot3(ld, ld));
  const float l[3] = {ld[0] / norm, ld[1] / norm, ld[2] / norm};
  const float pick[3] = {fabsf(l[0]) < 0.9f ? 1.0f : 0.0f,
                         fabsf(l[0]) < 0.9f ? 0.0f : 1.0f, 0.0f};
  cross3(l, pick, ax[0]);
  const float len = sqrtf(dot3(ax[0], ax[0]));
  for (int k = 0; k < 3; ++k) ax[0][k] = ax[0][k] / len;
  cross3(l, ax[0], ax[1]);
  for (int k = 0; k < 3; ++k) ax[2][k] = l[k];
  for (int a = 0; a < 3; ++a) {
    for (int k = 0; k < 3; ++k) abs_ax[a][k] = fabsf(ax[a][k]);
  }
  float box_lo[3], box_hi[3];
  for (int k = 0; k < 3; ++k) {
    box_lo[k] = s_min[k][0];
    box_hi[k] = s_max[k][0];
  }
  float ou_lo, ou_hi, ov_lo, ov_hi, ol_lo, ol_hi;
  box_interval(box_lo, box_hi, ax[0], abs_ax[0], &ou_lo, &ou_hi);
  box_interval(box_lo, box_hi, ax[1], abs_ax[1], &ov_lo, &ov_hi);
  box_interval(box_lo, box_hi, ax[2], abs_ax[2], &ol_lo, &ol_hi);

  for (int j = threadIdx.x; j < C; j += kThreads) {
    const float bmin[3] = {cmin[j * 3], cmin[j * 3 + 1], cmin[j * 3 + 2]};
    const float bmax[3] = {cmax[j * 3], cmax[j * 3 + 1], cmax[j * 3 + 2]};
    float cu_lo, cu_hi, cv_lo, cv_hi, cl_lo, cl_hi;
    box_interval(bmin, bmax, ax[0], abs_ax[0], &cu_lo, &cu_hi);
    box_interval(bmin, bmax, ax[1], abs_ax[1], &cv_lo, &cv_hi);
    box_interval(bmin, bmax, ax[2], abs_ax[2], &cl_lo, &cl_hi);
    row[j] = cu_hi >= ou_lo && cu_lo <= ou_hi && cv_hi >= ov_lo &&
             cv_lo <= ov_hi && cl_hi >= ol_lo;
  }
}

// `bounce_sweep._general_cull_plain`, a tile a block: its active rays'
// origin and direction boxes, the direction sum, the unit mean m and the
// least cosine to m, then a mask byte a cluster.
__global__ void __launch_bounds__(kThreads) general_cull_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const bool* __restrict__ active, int R, const float* __restrict__ cmin,
    const float* __restrict__ cmax, int C, bool* __restrict__ out) {
  // Rows 0-2: the origins' minimum a component, 3-5 the directions';
  // 6-8 and 9-11 their maximum.
  __shared__ float s_ext[12][kThreads];
  __shared__ float s_sum[3][kThreads];
  __shared__ float s_cos[kThreads];
  const int tile = blockIdx.x;
  const float* o = origins + static_cast<size_t>(tile) * 3 * R;
  const float* d = dirs + static_cast<size_t>(tile) * 3 * R;
  const bool* act = active + static_cast<size_t>(tile) * R;

  // The chain's where(act, x, kBig).amin, where(act, x, -kBig).amax and
  // where(act, d, 0).sum; min and max are exact in any order.
  float ext[12];
  for (int k = 0; k < 6; ++k) {
    ext[k] = INFINITY;
    ext[k + 6] = -INFINITY;
  }
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int any = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool a = act[r];
    any |= a;
    for (int k = 0; k < 3; ++k) {
      const float x = o[k * R + r];
      const float y = d[k * R + r];
      ext[k] = min_nan(ext[k], a ? x : kBig);
      ext[k + 3] = min_nan(ext[k + 3], a ? y : kBig);
      ext[k + 6] = max_nan(ext[k + 6], a ? x : -kBig);
      ext[k + 9] = max_nan(ext[k + 9], a ? y : -kBig);
      acc[k] += a ? y : 0.0f;
    }
  }
  for (int k = 0; k < 12; ++k) s_ext[k][threadIdx.x] = ext[k];
  for (int k = 0; k < 3; ++k) s_sum[k][threadIdx.x] = acc[k];
  bool* row = out + static_cast<size_t>(tile) * C;
  if (!__syncthreads_or(any)) {
    for (int j = threadIdx.x; j < C; j += kThreads) row[j] = false;
    return;
  }
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int t = threadIdx.x;
      for (int k = 0; k < 6; ++k) {
        s_ext[k][t] = min_nan(s_ext[k][t], s_ext[k][t + s]);
        s_ext[k + 6][t] = max_nan(s_ext[k + 6][t], s_ext[k + 6][t + s]);
      }
      for (int k = 0; k < 3; ++k) s_sum[k][t] += s_sum[k][t + s];
    }
    __syncthreads();
  }

  // The unit mean: dsum / sqrt(clamp(dsum.dsum, 1e-30)), the dot left to
  // right, in every thread.
  const float ds[3] = {s_sum[0][0], s_sum[1][0], s_sum[2][0]};
  float len2 = ds[0] * ds[0] + ds[1] * ds[1];
  len2 = len2 + ds[2] * ds[2];
  const float len = sqrtf(len2 < 1e-30f ? 1e-30f : len2);  // NaN stays
  const float m[3] = {ds[0] / len, ds[1] / len, ds[2] / len};

  // cos_min: where(act, d.m, 1).amin over the tile's rays.
  float cos_lo = INFINITY;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float c = 1.0f;
    if (act[r]) {
      c = d[r] * m[0] + d[R + r] * m[1];
      c = c + d[2 * R + r] * m[2];
    }
    cos_lo = min_nan(cos_lo, c);
  }
  s_cos[threadIdx.x] = cos_lo;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_cos[threadIdx.x] = min_nan(s_cos[threadIdx.x],
                                   s_cos[threadIdx.x + s]);
    }
    __syncthreads();
  }
  const float cos_min = s_cos[0];
  // The cone constrains only while the bundle fits in a half-space.
  const bool cone_free = cos_min <= 0.0f;

  float omin[3], omax[3], reach_lo[3], reach_hi[3];
  for (int k = 0; k < 3; ++k) {
    omin[k] = s_ext[k][0];
    omax[k] = s_ext[k + 6][0];
    reach_lo[k] = s_ext[k + 3][0] >= 0.0f ? omin[k] : -kBig;
    reach_hi[k] = s_ext[k + 9][0] <= 0.0f ? omax[k] : kBig;
  }

  for (int j = threadIdx.x; j < C; j += kThreads) {
    bool keep = true;
    float sup = 0.0f;
    float gap2 = 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float lo = cmin[j * 3 + k];
      const float hi = cmax[j * 3 + k];
      keep = keep & (hi >= reach_lo[k]) & (lo <= reach_hi[k]);
      const float wlo = lo - omax[k];
      const float whi = hi - omin[k];
      sup = sup + max_nan(m[k] * wlo, m[k] * whi);
      const float g = max_nan(max_nan(wlo, -whi), 0.0f);
      gap2 = gap2 + g * g;
    }
    // false on NaN, as the chain's comparison is
    row[j] = keep & (cone_free | (sup >= cos_min * sqrtf(gap2)));
  }
}

}  // namespace

extern "C" {

// Each returns the first launch error (0 on success).  Cluster boxes cmin,
// cmax [C, 3]; out [T, C] bool.  row_major: the tiles are [T, R, 3], else
// planar [T, 3, R].

// The frustum cull: directions of T tiles of R = tile_px^2 rays, the
// common eye [3].
int rt_frustum_cull(const float* dirs, int row_major, int num_tiles,
                    int rays_per_tile, int tile_px, const float* eye,
                    const float* cmin, const float* cmax, int num_clusters,
                    bool* out, void* stream) {
  if (num_tiles == 0 || num_clusters == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_major) {
    frustum_cull_kernel<true><<<num_tiles, kThreads, 0, s>>>(
        dirs, rays_per_tile, tile_px, eye, cmin, cmax, num_clusters, out);
  } else {
    frustum_cull_kernel<false><<<num_tiles, kThreads, 0, s>>>(
        dirs, rays_per_tile, tile_px, eye, cmin, cmax, num_clusters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The swept-beam cull: shadow-ray origins of T tiles of R rays, their
// activity [T, R] bool, the light direction [3].
int rt_beam_cull(const float* origins, const bool* active, int row_major,
                 int num_tiles, int rays_per_tile, const float* light_dir,
                 const float* cmin, const float* cmax, int num_clusters,
                 bool* out, void* stream) {
  if (num_tiles == 0 || num_clusters == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_major) {
    beam_cull_kernel<true><<<num_tiles, kThreads, 0, s>>>(
        origins, active, rays_per_tile, light_dir, cmin, cmax,
        num_clusters, out);
  } else {
    beam_cull_kernel<false><<<num_tiles, kThreads, 0, s>>>(
        origins, active, rays_per_tile, light_dir, cmin, cmax,
        num_clusters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The general cull: origins and unit directions of T tiles of R rays,
// both planar [T, 3, R], their activity [T, R] bool.
int rt_general_cull(const float* origins, const float* dirs,
                    const bool* active, int num_tiles, int rays_per_tile,
                    const float* cmin, const float* cmax, int num_clusters,
                    bool* out, void* stream) {
  if (num_tiles == 0 || num_clusters == 0) return 0;
  general_cull_kernel<<<num_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, active, rays_per_tile, cmin, cmax, num_clusters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
