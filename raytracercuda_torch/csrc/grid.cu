// Kernel M of the port, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (`ops/cuda_build.py`): the DDA march over the hashed
// uniform grid of `accel/grid.py:build_grid`.
//
// M, `march_kernel<kEye>`, replaces the XLA `while_loop` of
//   `trace_grid` (raytracercuda_tpu/trace/grid_march.py:29-109, no Pallas
//   kernel), the TPU form of the reference's `bmMarchKernelSpace`
//   (Hash.cu:235-302).  Each ray marches on its own; JAX steps every ray
//   in lockstep, but a ray's state depends on its own cell visits only, so
//   a ray that loops on its own gives the same bits.  For at most max_iters
//   steps the ray:
//   * maps its point p to the cell floor(p / cell_res) (IEEE division, as
//     the plain version's) and hashes it: the per-axis Fletcher16 sums of
//     the cell's u32 coordinates mod num_cells (Hash.cu:17-46);
//   * tests the bucket's first min(count, max_faces) faces in CSR order
//     with the oracle's Moller-Trumbore (`mt.cuh`) on the ORIGINAL ray, not
//     from p (Hash.cu:272); the winner is the first minimum in CSR order;
//   * stops once it has a hit (Hash.cu:280); otherwise steps through the
//     cell: p += d * (box_d + cell_res * pinch), box_d the exit distance of
//     `ops/math.box_ray_intersect_no_zero` with NaN-propagating min and
//     max (a zero direction component makes 0 * inf a NaN where p lies on
//     the slab, as in the JAX package, and the NaN p then ends the march),
//     and stops where the new point is not finite, keeping p.
//
// What bounds it on the H100: the FP32 work of the ray-triangle tests (46
// operations each) and of each step's map, slab and advance, at 67
// TFLOP/s.  Built with -fmad=false (every expression rounds as the plain
// PyTorch version's separate operations do: t, u and v are bit-equal to
// it), each add and multiply issues alone, so about half of that peak is
// the ceiling; a test's IEEE division, branches and the loop add issue
// slots beyond the 46.  The rows a frame reads fit in the 50 MB L2.
//
// The design.  A bucket holds hundreds of faces (the hash's collisions)
// and most rays march all 400 cells, so the tests are the work.  With one
// thread a ray each lane tests its own bucket in series: a warp-step lasts
// as long as its largest bucket (idle lanes), and every test loads its own
// 48-byte row, though neighbouring rays visit the same buckets.  Here a
// block's two warps (kMarchWarps) share the work of 32 rays:
//   * the 32 rays are an 8x4 pixel patch when the caller gives the frame's
//     (height, width) (neighbouring rays share more buckets), else 32
//     consecutive rays; lanes outside the frame march nothing.  Lane l of
//     each warp holds ray l and steps it (the same bits in both warps);
//   * at each step the testing lanes group by bucket (the lowest pending
//     lane's bucket and a ballot of the lanes that share it).  A group's
//     rows are read in rounds of 32, one row a lane (coalesced), the
//     step's rounds dealt to the warps in turn; in a round each lane tests
//     its row against each ray of the group, the group's rays staged in
//     shared memory in lane order (direction and lane, and origin) and
//     read by broadcast.  So the lanes are busy while the bucket has rows,
//     a row is read once a group and not once a ray, and a patch's tests
//     spread over two warps (one warp a patch leaves the frame's heaviest
//     patches as its critical path; one to four warps were timed, and two
//     was the fastest: PERF.md);
//   * a round's winner for a ray is the least (ordered t, lane): a ballot
//     of the hits (rare: the warp skips the rest when it is empty), the
//     least ordered t of `hit_key` by `__reduce_min_sync` (-0.0 ties
//     +0.0) and its first lane; it replaces the warp's best for the ray on
//     a strict `<`.  A hit stamps the step into shared memory, after the
//     step's barrier every warp stops the ray, and at the end the least
//     `hit_key` (t, slot) over the warps' bests, an atomicMin in shared
//     memory, picks the first minimum in CSR order, whose warp writes it;
//   * from a common origin (kEye), the test reads the staged eye terms
//     (`grid_march.eye_rows`: e1 | e2 | tvec | qvec | tq, 64 bytes a CSR
//     entry) and computes only the ray's terms (`mt.cuh:eye_mt`).

#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "mt.cuh"

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
// A block's pixel patch on a frame (`grid_march.PATCH_W`, `PATCH_H`).
constexpr int kPatchW = 8;
constexpr int kPatchH = 4;
// The warps that share a block's 32 rays.
constexpr int kMarchWarps = 2;

// `bmHash` (Hash.cu:17-32): Fletcher16 over the four little-endian bytes
// b0..b3.  The reference reduces both running sums mod 255 after each
// byte; the same sums reduced once are equal (`accel/grid.py:fletcher16`).
__device__ __forceinline__ unsigned int fletcher16(unsigned int h) {
  const unsigned int b0 = h & 0xFFu, b1 = (h >> 8) & 0xFFu,
                     b2 = (h >> 16) & 0xFFu, b3 = h >> 24;
  const unsigned int s1 = (b0 + b1 + b2 + b3) % 255u;
  const unsigned int s2 = (4u * b0 + 3u * b1 + 2u * b2 + b3) % 255u;
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

// A CSR entry's row as the test reads it: v0 | e1 | e2 (`Tri`, 48 bytes),
// or the staged eye terms e1 | e2 | tvec | qvec | tq (64 bytes).
template <bool kEye>
struct MarchRow;

template <>
struct MarchRow<false> {
  Tri w;
  __device__ __forceinline__ void load(const float4* __restrict__ rows,
                                       int slot) {
    w = load_tri(rows, slot);
  }
  __device__ __forceinline__ float test(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        bool use_eps, float t_eps, float& u,
                                        float& v) const {
    return tri_mt(w, ox, oy, oz, dx, dy, dz, use_eps, t_eps, u, v);
  }
};

template <>
struct MarchRow<true> {
  float4 a, b, c, d;
  __device__ __forceinline__ void load(const float4* __restrict__ rows,
                                       int slot) {
    a = __ldg(rows + 4 * slot);
    b = __ldg(rows + 4 * slot + 1);
    c = __ldg(rows + 4 * slot + 2);
    d = __ldg(rows + 4 * slot + 3);
  }
  __device__ __forceinline__ float test(float, float, float, float dx,
                                        float dy, float dz, bool use_eps,
                                        float t_eps, float& u,
                                        float& v) const {
    return eye_mt(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z,
                  c.w, d.x, dx, dy, dz, use_eps, t_eps, u, v);
  }
};

// One block of kMarchWarps warps marches 32 rays: an 8x4 patch of a width x
// height frame (patch blockIdx.x, patches row-major), or rays 32 *
// blockIdx.x + lane when width is 0; lane l of every warp holds ray l, and
// every warp steps every ray (the same bits).  rows: `march_rows` (kEye
// false) or `eye_rows` (kEye true), num_rows of them; origins[origin_stride
// * i] is ray i's origin (stride 0: the common origin).
template <bool kEye>
__global__ void __launch_bounds__(32 * kMarchWarps)
    march_kernel(const int* __restrict__ cell_start, int num_cells,
                 const float4* __restrict__ rows, int num_rows,
                 const float* __restrict__ origins, int origin_stride,
                 const float* __restrict__ dirs, int num_rays, int height,
                 int width, float cell_res, float pinch, int max_iters,
                 int max_faces, int use_eps, float t_eps,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v, int* __restrict__ out_slot) {
  // The step at which each ray found its hit (a ray stops there), and each
  // ray's least hit key over the block's warps.
  __shared__ int hit_step[32];
  __shared__ unsigned long long best_key[32];
  // Each warp's current group: its rays' directions (and lanes), origins.
  __shared__ float4 ray_dir[kMarchWarps][32];
  __shared__ float4 ray_org[kEye ? 1 : kMarchWarps][32];
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int me = static_cast<int>(threadIdx.x) / 32;
  const int patch = static_cast<int>(blockIdx.x);
  long long i;
  if (width > 0) {
    const int patches_x = (width + kPatchW - 1) / kPatchW;
    const int y = (patch / patches_x) * kPatchH + lane / kPatchW;
    const int x = (patch % patches_x) * kPatchW + lane % kPatchW;
    i = (y < height && x < width) ? static_cast<long long>(y) * width + x
                                  : -1;
  } else {
    i = static_cast<long long>(patch) * 32 + lane;
    if (i >= num_rays) i = -1;
  }
  if (me == 0) {
    hit_step[lane] = max_iters;
    best_key[lane] = kMissKey;
  }
  __syncthreads();
  bool marching = i >= 0;
  const long long ri = marching ? i : 0;
  const float* o = origins + origin_stride * ri;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = dirs[3 * ri], dy = dirs[3 * ri + 1],
              dz = dirs[3 * ri + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const bool eps = use_eps != 0;
  float px = ox, py = oy, pz = oz;
  // This warp's best for ray `lane` over the rounds it tested.
  float bt = kFltMax, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  for (int step = 0; step < max_iters; ++step) {
    if (!__any_sync(kFullMask, marching)) break;  // the same in every warp
    int cx = 0, cy = 0, cz = 0;
    unsigned int h = 0;
    int start = 0, count = 0;
    if (marching) {
      cx = static_cast<int>(floorf(px / cell_res));
      cy = static_cast<int>(floorf(py / cell_res));
      cz = static_cast<int>(floorf(pz / cell_res));
      h = (fletcher16(static_cast<unsigned int>(cx)) +
           fletcher16(static_cast<unsigned int>(cy)) +
           fletcher16(static_cast<unsigned int>(cz))) %
          static_cast<unsigned int>(num_cells);
      start = __ldg(cell_start + h);
      count = min(__ldg(cell_start + h + 1) - start, max_faces);
    }
    const bool tests = marching && count > 0;
    unsigned pending = __ballot_sync(kFullMask, tests);
    // The step's rounds (a group's 32 rows) in order, round `unit` to
    // warp (unit + step) % kMarchWarps.
    int unit = step;
    while (pending) {
      // The group of the lowest pending lane's bucket.
      const int leader = __ffs(pending) - 1;
      const unsigned gh = __shfl_sync(kFullMask, h, leader);
      const int gstart = __shfl_sync(kFullMask, start, leader);
      const int gcount = __shfl_sync(kFullMask, count, leader);
      const unsigned group = __ballot_sync(kFullMask, tests && h == gh);
      pending &= ~group;
      // The group's rays in lane order, staged for the rounds' tests.
      const int members = __popc(group);
      __syncwarp();
      if ((group >> lane) & 1u) {
        const int j = __popc(group & ((1u << lane) - 1u));
        ray_dir[me][j] = make_float4(dx, dy, dz, __int_as_float(lane));
        if (!kEye) ray_org[me][j] = make_float4(ox, oy, oz, 0.0f);
      }
      __syncwarp();
      for (int base = 0; base < gcount; base += 32, ++unit) {
        if (unit % kMarchWarps != me) continue;
        const bool has = base + lane < gcount;
        const int slot = min(max(gstart + base + lane, 0), num_rows - 1);
        MarchRow<kEye> row;
        row.load(rows, slot);
        for (int j = 0; j < members; ++j) {
          const float4 rd = ray_dir[me][j];  // a broadcast read
          const int r = __float_as_int(rd.w);
          float4 ro = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (!kEye) ro = ray_org[me][j];
          float u, v;
          float t = row.test(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, eps, t_eps,
                             u, v);
          if (!has) t = kFltMax;
          const bool hit = t < kFltMax;
          if (!__any_sync(kFullMask, hit)) continue;
          // The least (ordered t, lane) of the round: its first minimum.
          const unsigned ord =
              hit ? static_cast<unsigned>(hit_key(t, 0) >> 32) : kFullMask;
          const unsigned least = __reduce_min_sync(kFullMask, ord);
          const int win = __ffs(__ballot_sync(kFullMask, ord == least)) - 1;
          const float tw = __shfl_sync(kFullMask, t, win);
          const float uw = __shfl_sync(kFullMask, u, win);
          const float vw = __shfl_sync(kFullMask, v, win);
          if (lane == r && tw < bt) {
            bt = tw;
            bu = uw;
            bv = vw;
            bs = min(max(gstart + base + win, 0), num_rows - 1);
            hit_step[r] = step;  // every writer writes this step
          }
        }
      }
    }
    // Every warp's hits of this step are in hit_step; a later step's
    // writes are larger than this step, so no second barrier is needed.
    __syncthreads();
    if (!marching) continue;
    if (hit_step[lane] <= step) {
      marching = false;
      continue;
    }
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
    if (!(isfinite(nx) && isfinite(ny) && isfinite(nz))) {
      marching = false;
      continue;
    }
    px = nx;
    py = ny;
    pz = nz;
  }
  // A ray's winner: the least (ordered t, slot) over the warps' bests, the
  // first minimum in CSR order; its warp writes it.
  const unsigned long long key = bt < kFltMax ? hit_key(bt, bs) : kMissKey;
  if (key != kMissKey) atomicMin(&best_key[lane], key);
  __syncthreads();
  if (i < 0) return;
  const unsigned long long least = best_key[lane];
  if (least == kMissKey ? me == 0 : key == least) {
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_slot[i] = bs;
  }
}

}  // namespace

extern "C" {

// M.  cell_start [num_cells + 1] int32 (`HashGrid.cell_start`); rows
// [num_rows, 12] float32, v0 | e1 | e2 | zeros of each CSR entry
// (`grid_march.march_rows`), or with eye_rows [num_rows, 16] (not null)
// the staged eye terms of the common origin (`grid_march.eye_rows`), a
// slot clipped to [0, num_rows); origins [R, 3] (origin_stride 3) or the
// common origin [3] (origin_stride 0); dirs [R, 3]; height x width = R
// for pixel-patch blocks, width 0 for blocks of 32 consecutive rays;
// pinch = cell_res * pinch_epsilon_frac; out_t, out_u, out_v [R] float32
// and out_slot [R] int32, the winner's CSR entry (t = FLT_MAX, u = v = 0,
// slot 0 on a miss).  Returns the launch error (0 on success).
int rt_grid_march(const int* cell_start, int num_cells, const float* rows,
                  const float* eye_rows, int num_rows, const float* origins,
                  int origin_stride, const float* dirs, int num_rays,
                  int height, int width, float cell_res, float pinch,
                  int max_iters, int max_faces, int use_eps, float t_eps,
                  float* out_t, float* out_u, float* out_v, int* out_slot,
                  void* stream) {
  if (num_rays <= 0) return 0;
  if (width > 0 && static_cast<long long>(height) * width != num_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = width > 0 ? ((height + kPatchH - 1) / kPatchH) *
                                     ((width + kPatchW - 1) / kPatchW)
                               : (num_rays + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool eye = eye_rows != nullptr;
  const float4* table = reinterpret_cast<const float4*>(eye ? eye_rows : rows);
  const auto kernel = eye ? march_kernel<true> : march_kernel<false>;
  kernel<<<blocks, 32 * kMarchWarps, 0, s>>>(
      cell_start, num_cells, table, num_rows, origins, origin_stride, dirs,
      num_rays, height, width, cell_res, pinch, max_iters, max_faces, use_eps,
      t_eps, out_t, out_u, out_v, out_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
