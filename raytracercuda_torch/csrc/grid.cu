// Kernel M of the port, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (`ops/cuda_build.py`): the DDA march over the hashed
// uniform grid of `accel/grid.py:build_grid`.
//
// M, `march_kernel`, replaces the XLA `while_loop` of `trace_grid`
//   (raytracercuda_tpu/trace/grid_march.py:29-109, no Pallas kernel), the
//   TPU form of the reference's `bmMarchKernelSpace` (Hash.cu:235-302).
//   One thread per ray.  JAX steps every ray in lockstep, but a ray's state
//   depends on its own cell visits only, so a ray that loops on its own
//   gives the same bits.  For at most max_iters steps the ray:
//   * maps its point p to the cell floor(p / cell_res) (IEEE division, as
//     the plain version's) and hashes it: the per-axis Fletcher16 sums of
//     the cell's u32 coordinates mod num_cells (Hash.cu:17-46);
//   * tests the bucket's first min(count, max_faces) faces in CSR order
//     with the oracle's Moller-Trumbore (`mt.cuh`) on the ORIGINAL ray, not
//     from p (Hash.cu:272), a hit replacing the best only on a strict `<`:
//     the winner is the first minimum in CSR order;
//   * stops once it has a hit (Hash.cu:280); otherwise steps through the
//     cell: p += d * (box_d + cell_res * pinch), box_d the exit distance of
//     `ops/math.box_ray_intersect_no_zero` with NaN-propagating min and
//     max (a zero direction component makes 0 * inf a NaN where p lies on
//     the slab, as in the JAX package, and the NaN p then ends the march),
//     and stops where the new point is not finite, keeping p.
//   The triangles come from `grid_march.march_rows`: one 48-byte row v0 |
//   e1 | e2 per CSR entry, built once per (grid, scene), so a test costs
//   one load that depends on the bucket's offset, not two (no face-id
//   read; the winner's face id is read from the entry on the host side).
//
// What bounds it on the H100: the FP32 work of the ray-triangle tests (46
// operations each) and of each step's map, slab and advance, at 67
// TFLOP/s; the rows a frame reads fit in the 50 MB L2.  It does not reach
// it: a ray that misses walks all max_iters cells (400 by default), and a
// bucket holds hundreds of faces (the hash's collisions), so a warp's time
// is its slowest lane's serial chain of steps and tests.  Each step is two
// dependent loads (the bucket's offsets, then its rows); the next row is
// requested before the current one is tested.
// Built with -fmad=false and IEEE division, every expression rounds as the
// plain PyTorch version's separate operations do: t, u and v are bit-equal
// to it.

#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "mt.cuh"

namespace {

constexpr int kMarchThreads = 128;  // rays a block

// `bmHash` (Hash.cu:17-32): Fletcher16 over the four little-endian bytes.
__device__ __forceinline__ unsigned int fletcher16(unsigned int h) {
  unsigned int s1 = 0, s2 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s1 = (s1 + ((h >> (8 * k)) & 0xFFu)) % 255u;
    s2 = (s2 + s1) % 255u;
  }
  return (s2 << 8) | s1;
}

// min and max that return a NaN operand, as torch.minimum/maximum and
// jnp.minimum/maximum do (fminf and fmaxf drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(kMarchThreads)
    march_kernel(const int* __restrict__ cell_start, int num_cells,
                 const float4* __restrict__ rows, int num_rows,
                 const float* __restrict__ origins,
                 const float* __restrict__ dirs, int num_rays,
                 float cell_res, float pinch, int max_iters, int max_faces,
                 int use_eps, float t_eps, float* __restrict__ out_t,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 int* __restrict__ out_slot) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float ox = origins[3 * i], oy = origins[3 * i + 1],
              oz = origins[3 * i + 2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float px = ox, py = oy, pz = oz;
  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  for (int step = 0; step < max_iters; ++step) {
    const int cx = static_cast<int>(floorf(px / cell_res));
    const int cy = static_cast<int>(floorf(py / cell_res));
    const int cz = static_cast<int>(floorf(pz / cell_res));
    const unsigned int h =
        (fletcher16(static_cast<unsigned int>(cx)) +
         fletcher16(static_cast<unsigned int>(cy)) +
         fletcher16(static_cast<unsigned int>(cz))) %
        static_cast<unsigned int>(num_cells);
    const int start = __ldg(cell_start + h);
    const int count = min(__ldg(cell_start + h + 1) - start, max_faces);
    if (count > 0) {
      int slot = min(max(start, 0), num_rows - 1);
      Tri w = load_tri(rows, slot);
      for (int k = 0; k < count; ++k) {
        Tri next = w;
        const int next_slot = min(max(start + k + 1, 0), num_rows - 1);
        if (k + 1 < count) next = load_tri(rows, next_slot);
        float u, v;
        const float t = tri_mt(w, ox, oy, oz, dx, dy, dz, use_eps != 0,
                               t_eps, u, v);
        if (t < bt) {
          bt = t;
          bu = u;
          bv = v;
          bs = slot;
        }
        w = next;
        slot = next_slot;
      }
    }
    if (bt < kFltMax) break;
    // Step through the cell (Hash.cu:283-286).
    const float bx0 = static_cast<float>(cx) * cell_res;
    const float by0 = static_cast<float>(cy) * cell_res;
    const float bz0 = static_cast<float>(cz) * cell_res;
    const float bx1 = bx0 + cell_res, by1 = by0 + cell_res,
                bz1 = bz0 + cell_res;
    const float ax = (bx0 - px) * ix, bx = (bx1 - px) * ix;
    const float ay = (by0 - py) * iy, by = (by1 - py) * iy;
    const float az = (bz0 - pz) * iz, bz = (bz1 - pz) * iz;
    const float t_near = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)),
                                 nan_min(az, bz));
    const float t_far = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)),
                                nan_max(az, bz));
    const float box_d = (isinf(t_near) || t_near < 0.0f) ? t_far : t_near;
    const float s = box_d + pinch;
    const float nx = px + dx * s, ny = py + dy * s, nz = pz + dz * s;
    if (!(isfinite(nx) && isfinite(ny) && isfinite(nz))) break;
    px = nx;
    py = ny;
    pz = nz;
  }
  out_t[i] = bt;
  out_u[i] = bu;
  out_v[i] = bv;
  out_slot[i] = bs;
}

}  // namespace

extern "C" {

// M.  cell_start [num_cells + 1] int32 (`HashGrid.cell_start`); rows
// [num_rows, 12] float32, v0 | e1 | e2 | zeros of each CSR entry
// (`grid_march.march_rows`), a slot clipped to [0, num_rows); origins,
// dirs [R, 3]; pinch = cell_res * pinch_epsilon_frac; out_t, out_u, out_v
// [R] float32 and out_slot [R] int32, the winner's CSR entry (t =
// FLT_MAX, u = v = 0, slot 0 on a miss).  Returns the launch error (0 on
// success).
int rt_grid_march(const int* cell_start, int num_cells, const float* rows,
                  int num_rows, const float* origins, const float* dirs,
                  int num_rays, float cell_res, float pinch, int max_iters,
                  int max_faces, int use_eps, float t_eps, float* out_t,
                  float* out_u, float* out_v, int* out_slot, void* stream) {
  if (num_rays <= 0) return 0;
  const int blocks = (num_rays + kMarchThreads - 1) / kMarchThreads;
  march_kernel<<<blocks, kMarchThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      cell_start, num_cells, reinterpret_cast<const float4*>(rows), num_rows,
      origins, dirs, num_rays, cell_res, pinch, max_iters, max_faces,
      use_eps, t_eps, out_t, out_u, out_v, out_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
