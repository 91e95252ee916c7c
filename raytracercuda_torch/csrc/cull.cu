// The two tile culls, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (`ops/cuda_build.py`).  They replace no TPU kernel: the
// JAX package culls with XLA ops (raytracercuda_tpu/trace/dense.py's
// `_cull_frustum`, occlusion_cull.py's `beam_survive_matrix`), and the
// port's plain chains of the same ops took ~80 and ~97 PyTorch launches a
// cull.  Each kernel writes the [T, C] bool survive mask that its chain
// writes, in one launch; `sweep._tile_lists` compacts it as before.
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
//
// One block of kThreads a tile.  The block reads its tile's 3R floats (and
// R active bytes) once, coalesced, and reduces them in a fixed tree order;
// then its threads stride over the clusters and write one mask byte a
// (tile, cluster), consecutive threads on consecutive bytes.  What bounds
// them on the H100: bytes, T x 3 x R x 4 read and T x C written (the
// cluster boxes, 24 bytes each, come from L2 for every block).  The work
// is T x C box tests of ~40 FP32 operations, about 22 M tests at
// T = 1,024, C = 543.  The chains' [T * 5, 6] @ [6, C] product and its
// [T, 5, C] float32 intermediate (224 MB at 1024x1024) are gone.
//
// The library is built with -fmad=false, and every expression follows the
// chain's float32 operations term by term.  Two parts of the chain have
// no order to follow: torch's `mean` (its own reduction order; here a
// fixed tree, times 1/R as torch's mean multiplies by its factor) and the
// dot products it leaves to `mm` and `mv` (cuBLAS on the card; here each
// three-term dot left to right, and the frustum's distance the centre
// terms' sum plus the half-extent terms' sum).  A mask entry can
// therefore differ from the chain's only where a plane or interval test is
// within rounding of its threshold.  The light direction is read through
// a device pointer and made unit here as `light_basis` makes l (its norm
// a three-term dot, where torch's `vector_norm` has its own order); u and
// v are made from l.

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

}  // extern "C"
