// Kernel E of the port, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (`ops/cuda_build.py`).
//
// E, `brute_items_kernel<P>` + `brute_epilogue_kernel`, replaces
//   `_mt_kernel` in raytracercuda_tpu/trace/pallas_brute.py (and the XLA
//   oracle it stands for, `trace/bruteforce.py:trace_brute`): the closest
//   hit of each ray against every triangle of the scene, with no
//   acceleration structure.
//
// The rules are the oracle's, not the tile sweeps':
//   * Moller-Trumbore in `ops/math.tri_intersect`'s term order;
//   * a triangle misses when u, v or t is NaN or on the u/v window tests
//     (no |det| threshold), and, with t_eps, when t < t_eps;
//   * the winner is the first minimum in face order;
//   * a miss carries t = FLT_MAX, u = v = 0 and face -1.
//
// What bounds it on the H100: about 40 FP32 operations and one IEEE
// division per ray-triangle pair, every pair tested (rays x faces): bound
// by the FP32 pipes, not by device memory.  Built with -fmad=false, so the
// adds and multiplies run one by one and a test cannot take less than
// about twice the 67 TFLOP/s bound, which counts an FMA as two operations.
//
// The design keeps the pipes fed and runs fewer instructions a pair:
//   * `oracle_mt` runs the miss tests as their terms come: a pair that
//     misses on u (most pairs) computes no v or t, and a warp whose rays
//     all miss skips them; a hit runs every term in the oracle's order;
//   * each thread holds P rays in registers (`rays_per_thread`), and reads
//     each staged triangle from shared memory once, as three 16-byte
//     broadcast loads of a [run][12] row, for all P tests;
//   * the grid is (ray groups of 128 * P rays) x (face chunks of
//     `face_chunk` faces), so that even a few tens of thousands of rays
//     fill the 132 SMs; each block stages its chunk a run of kRun faces at
//     a time from the [9, F] face columns, double-buffered with cp.async;
//   * a block sweeps its chunk in ascending face order with the strict
//     `<`, then merges each ray's best with one 64-bit atomicMin on
//     (ordered t, face) (`hit_key.cuh`): the smallest t wins, then the
//     smallest face, the oracle's first minimum in face order.  Only
//     t < FLT_MAX is keyed, as the serial `t < bt` from FLT_MAX keeps it:
//     +inf never wins, and with clip_backward_hits off -inf and negative
//     t do;
//   * pass 2, one thread per ray, decodes the key and re-runs the same
//     `oracle_mt` on the winning face's columns, so t (with its sign), u
//     and v are bit-equal to the plain version's.  The TPU kernel also
//     re-intersects its winner outside its sweep.
// The edges e1 = v1 - v0 and e2 = v2 - v0 are the wrapper's float32
// subtractions, the same values the oracle forms per pair.  IEEE division
// and -fmad=false make each expression round as in the plain PyTorch
// version.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "launch.cuh"
#include "mt.cuh"

namespace {

constexpr int kBruteThreads = 128;  // threads of a pass-1 block
constexpr int kRun = 128;           // faces staged in shared memory at once
constexpr int kRowFloats = 12;      // floats per staged face: v0|e1|e2, pad

// Starts the copy of faces [f, f + n) of the [9, F] columns into `s` as
// [n][12] rows (4-byte cp.async copies, each column read in order) and
// commits them as one group.
__device__ __forceinline__ void stage_run(float* s,
                                          const float* __restrict__ tris,
                                          int num_faces, int f, int n) {
  for (int e = threadIdx.x; e < 9 * n; e += blockDim.x) {
    const int k = e / n;
    const int j = e - k * n;
    __pipeline_memcpy_async(s + j * kRowFloats + k,
                            tris + static_cast<size_t>(k) * num_faces + f + j,
                            sizeof(float));
  }
  __pipeline_commit();
}

// Pass 1.  Grid: (ceil(num_rays / (128 P)), ceil(num_faces / chunk));
// block: 128 threads, thread x holding rays base + x + 128 p of its group.
// origins, dirs [R, 3]; tris [9, F].  Merges each ray's closest hit over
// faces [chunk * blockIdx.y, + chunk) into keys [R].
template <int P>
__global__ void __launch_bounds__(kBruteThreads) brute_items_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tris, int num_rays, int num_faces, int chunk,
    int use_eps, float t_eps, unsigned long long* __restrict__ keys) {
  extern __shared__ float4 s_rows[];  // two buffers of [kRun][12] floats
  const int f0 = blockIdx.y * chunk;
  const int f_end = min(f0 + chunk, num_faces);
  const long long base =
      static_cast<long long>(blockIdx.x) * P * kBruteThreads + threadIdx.x;
  float ox[P], oy[P], oz[P], dx[P], dy[P], dz[P], bt[P];
  int bf[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + p * kBruteThreads;
    // A ray past the end tests a zero direction: det = 0 gives NaN u, a
    // miss, and it keys nothing.
    const bool live = i < num_rays;
    ox[p] = live ? origins[3 * i] : 0.0f;
    oy[p] = live ? origins[3 * i + 1] : 0.0f;
    oz[p] = live ? origins[3 * i + 2] : 0.0f;
    dx[p] = live ? dirs[3 * i] : 0.0f;
    dy[p] = live ? dirs[3 * i + 1] : 0.0f;
    dz[p] = live ? dirs[3 * i + 2] : 0.0f;
    bt[p] = kFltMax;
    bf[p] = 0;
  }

  float* s = reinterpret_cast<float*>(s_rows);
  constexpr int kBuf = kRun * kRowFloats;
  const int runs = (f_end - f0 + kRun - 1) / kRun;
  stage_run(s, tris, num_faces, f0, min(kRun, f_end - f0));
  for (int r = 0; r < runs; ++r) {
    const int f = f0 + r * kRun;
    // The other buffer was freed by the barrier that ended step r - 1.
    if (r + 1 < runs)
      stage_run(s + ((r + 1) & 1) * kBuf, tris, num_faces, f + kRun,
                min(kRun, f_end - f - kRun));
    else
      __pipeline_commit();  // an empty group keeps the count of groups
    __pipeline_wait_prior(1);  // this thread's copies of run r landed
    __syncthreads();           // and every other thread's
    const float4* rows = s_rows + (r & 1) * (kBuf / 4);
    const int n = min(kRun, f_end - f);
    for (int j = 0; j < n; ++j) {
      const float4 a = rows[3 * j];
      const float4 b = rows[3 * j + 1];
      const float4 e = rows[3 * j + 2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float u, v;
        const float t = oracle_mt(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                  e.x, ox[p], oy[p], oz[p], dx[p], dy[p],
                                  dz[p], use_eps != 0, t_eps, u, v);
        if (t < bt[p]) {
          bt[p] = t;
          bf[p] = f + j;
        }
      }
    }
    __syncthreads();  // every thread is done with buffer r & 1
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = base + p * kBruteThreads;
    if (i < num_rays && bt[p] < kFltMax)
      atomicMin(keys + i, hit_key(bt[p], bf[p]));
  }
}

// Pass 2: one thread per ray.  A miss writes t = FLT_MAX, u = v = 0 and
// face -1; a hit re-runs `oracle_mt` on the winning face's columns.
__global__ void brute_epilogue_kernel(
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ tris, int num_rays, int num_faces, int use_eps,
    float t_eps, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_face) {
  const long long i = rt::thread_index();
  if (i >= num_rays) return;
  const unsigned long long key = keys[i];
  float t = kFltMax, u = 0.0f, v = 0.0f;
  int face = -1;
  if (key < kMissKey) {
    face = static_cast<int>(static_cast<unsigned int>(key));
    const float* c = tris + face;
    const size_t F = num_faces;
    t = oracle_mt(c[0], c[F], c[2 * F], c[3 * F], c[4 * F], c[5 * F],
                  c[6 * F], c[7 * F], c[8 * F], origins[3 * i],
                  origins[3 * i + 1], origins[3 * i + 2], dirs[3 * i],
                  dirs[3 * i + 1], dirs[3 * i + 2], use_eps != 0, t_eps, u,
                  v);
  }
  out_t[i] = t;
  out_u[i] = u;
  out_v[i] = v;
  out_face[i] = face;
}

template <int P>
cudaError_t launch_items(dim3 grid, cudaStream_t stream,
                         const float* origins, const float* dirs,
                         const float* tris, int num_rays, int num_faces,
                         int chunk, int use_eps, float t_eps,
                         unsigned long long* keys) {
  const size_t smem = sizeof(float) * 2 * kRun * kRowFloats;
  brute_items_kernel<P><<<grid, kBruteThreads, smem, stream>>>(
      origins, dirs, tris, num_rays, num_faces, chunk, use_eps, t_eps, keys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// origins, dirs [R, 3]; tris [9, F]; keys [R] of scratch; out_t, out_u,
// out_v [R] float32, out_face [R] int32.  rays_per_thread is 1, 2, 4 or 8
// and face_chunk at least 1.  Returns the first launch error (0 on
// success).
int rt_brute(const float* origins, const float* dirs, const float* tris,
             int num_rays, int num_faces, int use_eps, float t_eps,
             int rays_per_thread, int face_chunk, unsigned long long* keys,
             float* out_t, float* out_u, float* out_v, int* out_face,
             void* stream) {
  if (num_rays == 0) return 0;
  if (face_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_keys_kernel<<<rt::card_grid(num_rays), rt::kThreads, 0, s>>>(
      keys, num_rays);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_faces > 0) {
    const int group = kBruteThreads * rays_per_thread;
    const dim3 grid((num_rays + group - 1) / group,
                    (num_faces + face_chunk - 1) / face_chunk);
    switch (rays_per_thread) {
      case 1:
        err = launch_items<1>(grid, s, origins, dirs, tris, num_rays,
                              num_faces, face_chunk, use_eps, t_eps, keys);
        break;
      case 2:
        err = launch_items<2>(grid, s, origins, dirs, tris, num_rays,
                              num_faces, face_chunk, use_eps, t_eps, keys);
        break;
      case 4:
        err = launch_items<4>(grid, s, origins, dirs, tris, num_rays,
                              num_faces, face_chunk, use_eps, t_eps, keys);
        break;
      case 8:
        err = launch_items<8>(grid, s, origins, dirs, tris, num_rays,
                              num_faces, face_chunk, use_eps, t_eps, keys);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  brute_epilogue_kernel<<<(num_rays + rt::kThreads - 1) / rt::kThreads,
                          rt::kThreads, 0, s>>>(
      keys, origins, dirs, tris, num_rays, num_faces, use_eps, t_eps, out_t,
      out_u, out_v, out_face);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
