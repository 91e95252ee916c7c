// Kernel E of the port, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (`ops/cuda_build.py`).
//
// E, `brute_kernel`, replaces `_mt_kernel` in
//   raytracercuda_tpu/trace/pallas_brute.py (and the XLA oracle it stands
//   for, `trace/bruteforce.py:trace_brute`): the closest hit of each ray
//   against every triangle of the scene, with no acceleration structure.
//
// The rules are the oracle's, not the tile sweeps':
//   * Moller-Trumbore in `ops/math.tri_intersect`'s term order;
//   * a triangle misses when u, v or t is NaN or on the u/v window tests
//     (no |det| threshold), and, with t_eps, when t < t_eps;
//   * the winner is the first minimum in face order;
//   * a miss carries t = FLT_MAX, u = v = 0 and face -1.
// The TPU kernel keeps only (t, index) and re-intersects the winner outside
// the kernel; this one evaluates the oracle formula itself and keeps the
// winner's u and v, so it needs no second pass.
//
// What bounds it on the H100: about 40 FP32 operations and one IEEE
// division per ray-triangle pair, every pair tested (rays x faces), with
// each triangle read once per block from shared memory: bound by the FP32
// pipes, not by device memory.
//
// The design is the simple one: one thread per ray.  Each block stages a
// run of kRun faces (v0 | e1 | e2, structure of arrays, so a warp reads one
// broadcast word per operand) in shared memory and every thread scans the
// run in ascending face id with a strict `<`, which keeps the first minimum
// in face order with no reduction.  The edges e1 = v1 - v0 and e2 = v2 - v0
// are the wrapper's float32 subtractions, the same values the oracle forms
// per pair.  Built with -fmad=false and IEEE division, so each expression
// rounds as in the plain PyTorch version.
//
// Later work: several rays per thread to reuse each staged triangle from
// registers, cp.async double-buffering of the runs.

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 256;  // faces staged in shared memory per run
constexpr float kFltMax = 3.40282346638528859812e+38f;

// Grid: ceil(R / blockDim.x) blocks; block: one thread per ray.
// origins, dirs [R, 3]; tris [9, F] (v0 | e1 | e2 components, each row F
// floats); out_t, out_u, out_v [R] float32, out_face [R] int32.
__global__ void brute_kernel(const float* __restrict__ origins,
                             const float* __restrict__ dirs,
                             const float* __restrict__ tris, int num_rays,
                             int num_faces, int use_eps, float t_eps,
                             float* __restrict__ out_t,
                             float* __restrict__ out_u,
                             float* __restrict__ out_v,
                             int* __restrict__ out_face) {
  __shared__ float s[9 * kRun];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < num_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = origins[3 * i];
    oy = origins[3 * i + 1];
    oz = origins[3 * i + 2];
    dx = dirs[3 * i];
    dy = dirs[3 * i + 1];
    dz = dirs[3 * i + 2];
  }
  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bf = -1;
  for (int base = 0; base < num_faces; base += kRun) {
    const int n = min(kRun, num_faces - base);
    __syncthreads();  // every thread is done with the previous run
    for (int e = threadIdx.x; e < 9 * n; e += blockDim.x) {
      const int k = e / n;
      const int j = e - k * n;
      s[k * kRun + j] = tris[static_cast<size_t>(k) * num_faces + base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float v0x = s[0 * kRun + j], v0y = s[1 * kRun + j],
                  v0z = s[2 * kRun + j];
      const float e1x = s[3 * kRun + j], e1y = s[4 * kRun + j],
                  e1z = s[5 * kRun + j];
      const float e2x = s[6 * kRun + j], e2y = s[7 * kRun + j],
                  e2z = s[8 * kRun + j];
      // pvec = d x e2; det = e1 . pvec (`tri_intersect`, math.py:80-108).
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv = 1.0f / det;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
      // qvec = tvec x e1.
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
      float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
      const bool miss = (u < 0.0f) | (u > 1.0f) | (v < 0.0f) |
                        (u + v > 1.0f) | isnan(u) | isnan(v) | isnan(t);
      if (miss) t = kFltMax;
      if (use_eps && t < t_eps) t = kFltMax;
      if (t < bt) {
        bt = t;
        bu = u;
        bv = v;
        bf = base + j;
      }
    }
  }
  if (live) {
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_face[i] = bf;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int rt_brute(const float* origins, const float* dirs, const float* tris,
             int num_rays, int num_faces, int use_eps, float t_eps,
             float* out_t, float* out_u, float* out_v, int* out_face,
             void* stream) {
  if (num_rays == 0) return 0;
  const int threads = 128;
  const int blocks = (num_rays + threads - 1) / threads;
  brute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, tris, num_rays, num_faces, use_eps, t_eps, out_t, out_u,
      out_v, out_face);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
