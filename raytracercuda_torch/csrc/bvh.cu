// Kernels K and L of the port, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (`ops/cuda_build.py`).  They walk the threaded LBVH
// of `accel/bvh.py:build_bvh` through the kernels' copy of it
// (`traverse.kernel_rows`, built once per structure on the card):
//   * node rows [N, 8] of 32 bytes, two aligned 16-byte loads: box min
//     xyz | max xyz | a-link | skip link (the links' int32 bits).  The
//     a-link is >= 0 the hit link of an internal node, < 0 a leaf's
//     -(first * 64 + count) - 2; a skip link of -1 ends the walk.  The
//     rows are in walk order (`traverse.walk_order`: the order a walk that
//     enters every box visits the nodes, the root row 0), the links
//     renumbered with them;
//   * triangle rows [F + 64, 12] of 48 bytes, three aligned 16-byte loads:
//     v0 | e1 | e2 | three zeros of the faces in Morton order, with e1 =
//     v1 - v0 and e2 = v2 - v0 the single subtractions the plain versions
//     form from `Bvh.packed_tris`, so every test rounds as theirs do.
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
// L, `beam_walk_kernel` + `beam_test_kernel` + `beam_epilogue_kernel`,
//   replaces the XLA rounds of `trace_beam` (raytracercuda_tpu/trace/
//   beam.py:121-290).  Each round of the C entry:
//   * the walk: one warp per tile whose cursor is still >= 0.  Its lanes
//     reduce tile_tmax, the largest best t of the tile's rays, from the
//     high words of their hit keys, then walk the tile's cursor: a node
//     survives when it is outside none of the tile's 5 planes (p-vertex
//     test) and gap^2 <= tile_tmax^2; a surviving leaf appends (first,
//     count) to the round's queue in device memory.  The walk ends when
//     the queue is full, the cursor is -1 or `steps` steps have passed.
//     The warp tests 32 rows from the cursor at once and keeps those the
//     walk visits (below).  It then cuts its queue into work items of
//     `chunk` entries, appends them to the round's item list (one
//     atomicAdd a tile), and raises the round's flag when its cursor is
//     still >= 0;
//   * the test: blocks of one thread per pixel of a tile take the round's
//     items in turn.  A block stages its item's triangle rows (rows
//     max(first, 0) + k, k < min(count, k_leaf), contiguous per entry) in
//     shared memory with cp.async; each thread keeps its ray's first
//     minimum over the item with a strict `<` and merges it with one
//     64-bit atomicMin on (ordered t, candidate ordinal) (`hit_key.cuh`).
//     The ordinal is ((round * queue + entry) * 64 + k): it rises along the
//     tile's candidate sequence (round, queue order, then k), so the
//     smallest key is the sequence's first minimum, the winner of the JAX
//     package's rounds (first minimum within a 64-entry block, strict `<`
//     across blocks and rounds);
//   * rounds go out in batches of 2, 4, 8, ...; the host waits once a
//     batch, for its rounds' flags (a round after every walk has ended
//     does nothing);
//   * after the last round the epilogue, one thread per pixel, decodes the
//     ordinal to the round's queue entry and k, recovers the tested row
//     max(first, 0) + k and the recorded slot clip(first + k) (they differ
//     for the first = -1 of a Karras leaf the collapse left internal), and
//     re-runs the winner's test, so t, u and v are bit-equal to the plain
//     version's.
//   The planes come from the wrapper (`dense.tile_frustum_planes`), the same
//   tensor the plain version reads.
//
// What bounds them on the H100: the FP32 work of the ray-triangle tests
// (46 operations each) and of the slab or plane tests, at 67 TFLOP/s; the
// nodes and triangles they read fit in the 50 MB L2.  Neither reaches it:
//   * K: a walk is a chain of dependent loads (each node's row gives the
//     next node), and about 95% of a frame's rays leave at the root, so
//     the few warps whose rays walk far set the time.  Each step costs one
//     load latency: the row holds the box and both links, and the rows of
//     both successors are requested before the box test decides between
//     them; in walk order the hit link's row is the next one, often in
//     the same cache line; a leaf's next triangle row is requested before
//     the current one is tested; the rays' leaf tests are grouped (a lane
//     that reaches a leaf waits for the warp's others to reach theirs or
//     end).
//   * L: a tile's walk is serial along the skip links, and the tiles that
//     see the mesh walk hundreds of nodes a round.  In walk order a walk
//     only moves forward, to the next row or past a subtree, so 32 rows
//     tested at once give up to 32 steps for one load latency.  The
//     ray-triangle tests, ~1,000 a ray in the tiles that see the mesh, are
//     spread over the card as work items; the rounds' host syncs and
//     launches remain.
// Built with -fmad=false and IEEE division, every expression rounds as the
// plain PyTorch versions' separate operations do: t, u and v are bit-equal
// to them.

#include <climits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hit_key.cuh"
#include "launch.cuh"
#include "mt.cuh"

namespace {

constexpr int kLeafPack = 64;   // accel/bvh.py:LEAF_PACK
constexpr int kLeafBits = 6;    // log2(kLeafPack): k in the ordinal
constexpr int kWalkThreads = 128;  // K: rays a block
constexpr int kTileWarps = 4;      // L's walk: tiles a block
constexpr int kMaxChunk = 32;      // L's test: queue entries an item

// A row of the node table: box min xyz | max x, then max yz | a-link |
// skip link.
struct Node {
  float4 lo, hi;
};

__device__ __forceinline__ Node load_node(const float4* __restrict__ rows,
                                          int n) {
  return Node{__ldg(rows + 2 * n), __ldg(rows + 2 * n + 1)};
}

__device__ __forceinline__ int a_link(const Node& r) {
  return __float_as_int(r.hi.z);
}

__device__ __forceinline__ int skip_link(const Node& r) {
  return __float_as_int(r.hi.w);
}

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

// The slab test of `ops/math.box_ray_intersect` on a node row: the entry
// distance, clamped to 0 when the origin is inside; FLT_MAX on a miss and
// where a product is NaN (0 * inf), as the plain version's NaN-propagating
// min and max make it.
__device__ __forceinline__ float slab(const Node& n, float ox, float oy,
                                      float oz, float ix, float iy,
                                      float iz) {
  const float ax = (n.lo.x - ox) * ix, bx = (n.lo.w - ox) * ix;
  const float ay = (n.lo.y - oy) * iy, by = (n.hi.x - oy) * iy;
  const float az = (n.lo.z - oz) * iz, bz = (n.hi.y - oz) * iz;
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

// K.  One thread per ray; origins, dirs [R, 3].  Closest hit writes t, u,
// v and the winning slot (t = FLT_MAX, u = v = 0, slot 0 on a miss); any
// hit writes the occlusion flag.  Each pass of the outer loop walks to the
// next leaf the ray enters (or to the walk's end), then tests that leaf:
// the same steps in the same order as one step a pass, with the leaf tests
// of a warp's rays grouped.
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const float4* __restrict__ nodes,
                const float4* __restrict__ tris, int num_slots,
                const float* __restrict__ origins,
                const float* __restrict__ dirs,
                const float* __restrict__ t_max, int num_rays, int max_iters,
                int use_eps, float t_eps, float* __restrict__ out_t,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int* __restrict__ out_slot, bool* __restrict__ out_occluded) {
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
  int cur = 0, step = 0;
  Node row = load_node(nodes, 0);
  while (cur >= 0 && step < max_iters) {
    int first = 0, count = 0;
    bool leaf = false;
    while (cur >= 0 && step < max_iters) {
      const int a = a_link(row), skip = skip_link(row);
      // Both successors' rows are requested before the box test decides
      // between them: a step costs one load latency.
      Node down_row = row, skip_row = row;
      if (a >= 0) down_row = load_node(nodes, a);
      if (skip >= 0) skip_row = load_node(nodes, skip);
      const float box_d = slab(row, ox, oy, oz, ix, iy, iz);
      ++step;
      const bool enter = box_d < (kAnyHit ? tmax : bt);
      const bool down = enter && a >= 0;
      cur = down ? a : skip;
      row = down ? down_row : skip_row;
      if (enter && a < 0) {
        leaf_range(a, first, count);
        leaf = true;
        break;
      }
    }
    if (!leaf) break;
    // The leaf's faces in ascending slot; the next row is requested before
    // the current one is tested.
    Tri w = load_tri(tris, clip_slot(first, num_slots));
    for (int k = 0; k < count; ++k) {
      const int slot = clip_slot(first + k, num_slots);
      Tri next = w;
      if (k + 1 < count)
        next = load_tri(tris, clip_slot(first + k + 1, num_slots));
      float u, v;
      if (kAnyHit) {
        const float t = tri_mt(w, ox, oy, oz, dx, dy, dz, false, 0.0f, u, v);
        if (t > t_eps && t < tmax) {
          occluded = true;
          cur = -1;
          break;
        }
      } else {
        const float t = tri_mt(w, ox, oy, oz, dx, dy, dz, use_eps != 0,
                               t_eps, u, v);
        if (t < bt) {
          bt = t;
          bu = u;
          bv = v;
          bs = slot;
        }
      }
      w = next;
    }
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

// The inverse of hit_key's order map on a key's high word: the float it
// came from (-0.0 comes back as +0.0; the two square alike).
__device__ __forceinline__ float key_t(unsigned int ordered) {
  const unsigned int b = (ordered & 0x80000000u) ? ordered ^ 0x80000000u
                                                 : ~ordered;
  return __uint_as_float(b);
}

// A round's block of L's log, int32 words in device memory: q_first [T,
// queue], q_count [T, queue], q_n [T], items [3, item_cap] (tile, first
// entry, end entry).  `rt_beam` keeps one block per round, `round_stride`
// words apart; the epilogue reads every round's q_first.
struct Round {
  int* q_first;
  int* q_count;
  int* q_n;
  int* items;
};

__host__ __device__ inline long long round_stride(int tiles, int queue,
                                                  int item_cap) {
  return 2LL * tiles * queue + tiles + 3LL * item_cap;
}

__host__ __device__ inline Round round_at(int* log, long long stride,
                                          int tiles, int queue, long long r) {
  int* base = log + stride * r;
  const long long tq = static_cast<long long>(tiles) * queue;
  return Round{base, base + tq, base + 2 * tq, base + 2 * tq + tiles};
}

// Whether a node with box b0..b5 survives a tile's cone: outside none of
// its 5 planes pl (p-vertex test) and gap^2 <= reach, the gap from the eye
// e to the box; every sum left to right, as `beam._beam_enter`'s.
__device__ __forceinline__ bool beam_enters(float b0, float b1, float b2,
                                            float b3, float b4, float b5,
                                            const float* pl, float ex,
                                            float ey, float ez,
                                            float reach) {
  bool outside = false;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const float nx = pl[3 * p], ny = pl[3 * p + 1], nz = pl[3 * p + 2];
    const float qx = (nx > 0.0f ? b3 : b0) - ex;
    const float qy = (ny > 0.0f ? b4 : b1) - ey;
    const float qz = (nz > 0.0f ? b5 : b2) - ez;
    outside |= nx * qx + ny * qy + nz * qz < 0.0f;
  }
  const float gx = relu(b0 - ex) + relu(ex - b3);
  const float gy = relu(b1 - ey) + relu(ey - b4);
  const float gz = relu(b2 - ez) + relu(ez - b5);
  return !outside && !(gx * gx + gy * gy + gz * gz > reach);
}

// L's walk, one warp per tile.  Round 0 starts every tile's cursor at the
// root and fills its rays' keys with the miss key (tile_tmax FLT_MAX);
// later rounds skip the tiles whose cursor is -1.  keys [T * R], tile-major;
// counters[0] the round's item count, counters[1] its flag (zero before the
// round).
//
// The node rows are in walk order (`traverse.walk_order`), so the warp
// takes 32 rows at a time from the cursor, one a lane, and tests them all:
// the walk goes from a row to the next unless the row is a leaf or a
// culled node whose skip link leads elsewhere, and every skip passes over
// the row's subtree, so a row is visited exactly when no earlier row of
// the 32 from the cursor skips past it (a prefix max of the skip targets).
// The visited rows are the walk's next steps in order; the warp keeps them
// up to the step limit and the full queue, appends the entered leaves, and
// goes on from the next node of the last one kept: one load latency for up
// to 32 steps.
__global__ void __launch_bounds__(32 * kTileWarps)
    beam_walk_kernel(const float4* __restrict__ nodes, int num_nodes,
                     const float* __restrict__ eye,
                     const float* __restrict__ planes, int num_tiles,
                     int rays, int queue, int steps, int chunk, int item_cap,
                     int round, unsigned long long* __restrict__ keys,
                     int* __restrict__ cursor, Round q,
                     int* __restrict__ counters) {
  constexpr unsigned int kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  if (tile >= num_tiles) return;  // the whole warp
  unsigned long long* tkeys = keys + static_cast<long long>(tile) * rays;
  int cur = 0;
  unsigned int top = 0;  // the largest ordered t of the tile's keys
  if (round == 0) {
    for (int j = lane; j < rays; j += 32) tkeys[j] = kMissKey;
    top = static_cast<unsigned int>(kMissKey >> 32);
  } else {
    cur = cursor[tile];
    if (cur < 0) {
      if (lane == 0) q.q_n[tile] = 0;
      return;  // the whole warp
    }
    for (int j = lane; j < rays; j += 32)
      top = max(top, static_cast<unsigned int>(tkeys[j] >> 32));
    top = __reduce_max_sync(kAll, top);
  }
  const float tile_tmax = key_t(top);
  const float reach = tile_tmax * tile_tmax;
  const float ex = eye[0], ey = eye[1], ez = eye[2];
  float pl[15];
#pragma unroll
  for (int j = 0; j < 15; ++j) pl[j] = planes[15LL * tile + j];
  int* qf = q.q_first + static_cast<long long>(tile) * queue;
  int* qc = q.q_count + static_cast<long long>(tile) * queue;
  int n = 0, step = 0;
  const unsigned int below = (1u << lane) - 1u;
  while (cur >= 0 && step < steps && n < queue) {
    const int v = cur + lane;
    const bool valid = v < num_nodes;
    Node row{};
    if (valid) row = load_node(nodes, v);
    const int a = a_link(row), skip = skip_link(row);
    const bool enter =
        valid && beam_enters(row.lo.x, row.lo.y, row.lo.z, row.lo.w,
                             row.hi.x, row.hi.y, pl, ex, ey, ez, reach);
    const bool leaf = a < 0;
    // The row the walk goes to after this one when it is not the next:
    // -1 (the end) lies past every row.
    const int jump = valid && (leaf || !enter) ? (skip < 0 ? INT_MAX : skip)
                                               : 0;
    int past = jump;  // the furthest jump of the rows up to this one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kAll, past, d);
      if (lane >= d) past = max(past, o);
    }
    int before = __shfl_up_sync(kAll, past, 1);
    if (lane == 0) before = 0;
    const bool visited = valid && before <= v;
    const bool append = visited && enter && leaf;
    const int s_v = __popc(__ballot_sync(kAll, visited) & below);
    const unsigned int appends = __ballot_sync(kAll, append);
    const int n_v = __popc(appends & below);
    const unsigned int kept =
        __ballot_sync(kAll, visited && step + s_v < steps && n + n_v < queue);
    if (append && ((kept >> lane) & 1u))
      leaf_range(a, qf[n + n_v], qc[n + n_v]);
    // kept holds lane 0 (the cursor): the loop's test admits its step.
    cur = __shfl_sync(kAll, enter && !leaf ? a : skip, 31 - __clz(kept));
    step += __popc(kept);
    n += __popc(appends & kept);
  }
  const int n_items = (n + chunk - 1) / chunk;
  int at = 0;
  if (lane == 0 && n_items > 0) at = atomicAdd(counters, n_items);
  at = __shfl_sync(kAll, at, 0);
  for (int j = lane; j < n_items; j += 32) {
    q.items[at + j] = tile;
    q.items[item_cap + at + j] = j * chunk;
    q.items[2 * item_cap + at + j] = min(n, (j + 1) * chunk);
  }
  if (lane == 0) {
    cursor[tile] = cur;
    q.q_n[tile] = n;
    if (cur >= 0) counters[1] = 1;  // every writer writes the same 1
  }
}

// The pixel index of ray r of tile `tile` (tiles and rays row-major).
__device__ __forceinline__ long long tile_pixel(int tile, int r, int width,
                                                int tile_px) {
  const int tiles_x = width / tile_px;
  const long long py = static_cast<long long>(tile / tiles_x) * tile_px +
                       r / tile_px;
  const long long px = static_cast<long long>(tile % tiles_x) * tile_px +
                       r % tile_px;
  return py * width + px;
}

// L's test: each block takes the round's work items blockIdx.x,
// blockIdx.x + gridDim.x, ... below the count the walk wrote
// (counters[0]), one thread per pixel of the item's tile.  Dynamic shared
// memory: the item's triangle rows, at most chunk * min(k_leaf, 63) of
// them.
__global__ void beam_test_kernel(const float4* __restrict__ tris,
                                 const float* __restrict__ eye,
                                 const float* __restrict__ dirs, int width,
                                 int tile_px, int queue, int k_leaf,
                                 int item_cap, int round, int use_eps,
                                 float t_eps, Round q,
                                 const int* __restrict__ counters,
                                 unsigned long long* __restrict__ keys) {
  extern __shared__ float4 s_tri[];
  __shared__ int s_off[kMaxChunk + 1];
  __shared__ int s_row[kMaxChunk];
  const int num_items = counters[0];
  const int r = threadIdx.x;
  const float ex = eye[0], ey = eye[1], ez = eye[2];
  for (int it = blockIdx.x; it < num_items; it += gridDim.x) {
    const int tile = q.items[it];
    const int lo = q.items[item_cap + it];
    const int ne = q.items[2 * item_cap + it] - lo;
    const long long at = static_cast<long long>(tile) * queue + lo;
    __syncthreads();  // the previous item's rows are no longer read
    if (r == 0) {
      int off = 0;
      for (int e = 0; e < ne; ++e) {
        s_row[e] = max(q.q_first[at + e], 0);
        s_off[e] = off;
        off += min(q.q_count[at + e], k_leaf);
      }
      s_off[ne] = off;
    }
    __syncthreads();
    for (int e = 0; e < ne; ++e) {
      const float4* src = tris + 3LL * s_row[e];
      float4* dst = s_tri + 3 * s_off[e];
      const int n3 = 3 * (s_off[e + 1] - s_off[e]);
      for (int j = r; j < n3; j += blockDim.x)
        __pipeline_memcpy_async(dst + j, src + j, sizeof(float4));
    }
    __pipeline_commit();
    const long long i = tile_pixel(tile, r, width, tile_px);
    const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
    __pipeline_wait_prior(0);
    __syncthreads();
    float bt = kFltMax;
    unsigned int best = 0;
    for (int e = 0; e < ne; ++e) {
      const unsigned int ord0 =
          static_cast<unsigned int>(round * queue + lo + e) << kLeafBits;
      const int k0 = s_off[e], k1 = s_off[e + 1];
      for (int k = k0; k < k1; ++k) {
        const Tri w{s_tri[3 * k], s_tri[3 * k + 1], s_tri[3 * k + 2]};
        float u, v;
        const float t = tri_mt(w, ex, ey, ez, dx, dy, dz, use_eps != 0,
                               t_eps, u, v);
        if (t < bt) {
          bt = t;
          best = ord0 + static_cast<unsigned int>(k - k0);
        }
      }
    }
    if (bt < kFltMax)
      atomicMin(keys + static_cast<long long>(tile) * blockDim.x + r,
                hit_key(bt, static_cast<int>(best)));
  }
}

// L's epilogue, one thread per pixel: decode the key, recover the winner's
// row and slot from its round's queue in the log, re-run its test.
// Outputs row-major.
__global__ void beam_epilogue_kernel(
    const unsigned long long* __restrict__ keys, int* log, long long stride,
    int num_tiles, int rays, int queue, const float4* __restrict__ tris,
    int num_slots, const float* __restrict__ eye,
    const float* __restrict__ dirs, int width, int tile_px, int use_eps,
    float t_eps, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_slot) {
  const long long total = static_cast<long long>(num_tiles) * rays;
  for (long long o = rt::thread_index(); o < total; o += rt::thread_count()) {
    const int tile = static_cast<int>(o / rays);
    const int r = static_cast<int>(o - static_cast<long long>(tile) * rays);
    const long long i = tile_pixel(tile, r, width, tile_px);
    const unsigned long long key = keys[o];
    float t = kFltMax, u = 0.0f, v = 0.0f;
    int slot = 0;
    if (key < kMissKey) {
      const unsigned int ord = static_cast<unsigned int>(key);
      const int k = static_cast<int>(ord & (kLeafPack - 1));
      const long long entry = ord >> kLeafBits;  // round * queue + e
      const long long round = entry / queue;
      const int first = round_at(log, stride, num_tiles, queue, round)
                            .q_first[static_cast<long long>(tile) * queue +
                                     entry - round * queue];
      slot = clip_slot(first + k, num_slots);
      t = tri_mt(load_tri(tris, max(first, 0) + k), eye[0], eye[1], eye[2],
                 dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], use_eps != 0,
                 t_eps, u, v);
    }
    out_t[i] = t;
    out_u[i] = u;
    out_v[i] = v;
    out_slot[i] = slot;
  }
}

template <bool kAnyHit>
cudaError_t launch_walk(cudaStream_t stream, const int* nodes,
                        const float* tris, int num_slots,
                        const float* origins, const float* dirs,
                        const float* t_max, int num_rays, int max_iters,
                        int use_eps, float t_eps, float* out_t, float* out_u,
                        float* out_v, int* out_slot, bool* out_occluded) {
  if (num_rays == 0) return cudaSuccess;
  walk_kernel<kAnyHit><<<(num_rays + kWalkThreads - 1) / kWalkThreads,
                         kWalkThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), num_slots, origins, dirs, t_max,
      num_rays, max_iters, use_eps, t_eps, out_t, out_u, out_v, out_slot,
      out_occluded);
  return cudaGetLastError();
}

// A single thread follows `next` through `n` dependent loads from `start`:
// the probe of one load's latency behind K's and L's chain floor.
__global__ void chase_kernel(const int* __restrict__ next, int start, int n,
                             int* __restrict__ out) {
  int j = start;
  for (int s = 0; s < n; ++s) j = next[j];
  *out = j;
}

}  // namespace

extern "C" {

// K, closest hit.  node_rows [N, 8] int32, tri_rows [num_slots, 12]
// float32 (`traverse.kernel_rows`); origins, dirs [R, 3]; out_t, out_u,
// out_v [R] float32, out_slot [R] int32.  Returns the launch error (0 on
// success).
int rt_walk_closest(const int* node_rows, const float* tri_rows,
                    int num_slots, const float* origins, const float* dirs,
                    int num_rays, int max_iters, int use_eps, float t_eps,
                    float* out_t, float* out_u, float* out_v, int* out_slot,
                    void* stream) {
  return static_cast<int>(launch_walk<false>(
      static_cast<cudaStream_t>(stream), node_rows, tri_rows, num_slots,
      origins, dirs, nullptr, num_rays, max_iters, use_eps, t_eps, out_t,
      out_u, out_v, out_slot, nullptr));
}

// K, any hit: as rt_walk_closest, with t_max [R] float32 and the
// occlusion flags out_occluded [R] bool.
int rt_walk_any(const int* node_rows, const float* tri_rows, int num_slots,
                const float* origins, const float* dirs, const float* t_max,
                int num_rays, int max_iters, float t_eps, bool* out_occluded,
                void* stream) {
  return static_cast<int>(launch_walk<true>(
      static_cast<cudaStream_t>(stream), node_rows, tri_rows, num_slots,
      origins, dirs, t_max, num_rays, max_iters, 0, t_eps, nullptr, nullptr,
      nullptr, nullptr, out_occluded));
}

// L, rounds round_begin .. round_end - 1 of a frame.  node_rows [N, 8] in
// walk order, tri_rows [num_slots, 12] (`traverse.kernel_rows`); eye [3];
// dirs [height * width, 3] row-major; planes [T, 5, 3] for the T =
// (height / tile_px) * (width / tile_px) tiles; tile_px^2 <= 1024;
// 1 <= chunk <= 32.
// Scratch: keys [T * tile_px^2] uint64 and cursor [T] int32 (written by
// round 0); log [round_end, round_stride(T, queue, item_cap)] int32,
// item_cap = T * ceil(queue / chunk), each round's queues and items;
// counters [2 * round_end] int32, zero (each round's item count and
// flag); flags [2 * round_end] int32 in pinned host memory.  Rounds go out
// in batches of 2, 4, 8, ... with one host sync a batch, for its rounds'
// counters (a round after every tile's walk has ended does nothing).
// After the last round the epilogue writes the outputs (as
// rt_walk_closest's, row-major).  info [4] (host memory): the rounds the
// frame needed, 1 if it needs rounds past round_end (then nothing is
// written: call again with more log and counters), the host syncs, the
// rounds launched.  Returns the first launch or copy error (0 on
// success).
int rt_beam(const int* node_rows, int num_nodes, const float* tri_rows,
            int num_slots, const float* eye, const float* dirs,
            const float* planes, int height, int width, int tile_px,
            int queue, int k_leaf, int steps, int chunk, int use_eps,
            float t_eps, unsigned long long* keys, int* cursor, int* log,
            int* counters, int* flags, int round_begin, int round_end,
            int* info, float* out_t, float* out_u, float* out_v,
            int* out_slot, void* stream) {
  if (tile_px < 1 || tile_px * tile_px > 1024 || queue < 1 || chunk < 1 ||
      chunk > kMaxChunk || height % tile_px || width % tile_px)
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = round_begin;
  info[1] = 0;
  info[2] = 0;
  info[3] = round_begin;
  const int tiles = (height / tile_px) * (width / tile_px);
  if (tiles == 0) return 0;
  const int rays = tile_px * tile_px;
  const int item_cap = tiles * ((queue + chunk - 1) / chunk);
  const int rows = min(max(k_leaf, 0), kLeafPack - 1);
  const size_t smem = sizeof(float4) * 3 * rows * chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nodes = reinterpret_cast<const float4*>(node_rows);
  const float4* tris = reinterpret_cast<const float4*>(tri_rows);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(beam_test_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, beam_test_kernel, rays, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int test_grid = max(1, min(item_cap, per_sm * rt::sm_count()));
  const long long stride = round_stride(tiles, queue, item_cap);
  for (int r = round_begin, batch = 2; r < round_end; batch *= 2) {
    const int first = r, last = min(r + batch, round_end);
    for (; r < last; ++r) {
      const Round q = round_at(log, stride, tiles, queue, r);
      beam_walk_kernel<<<(tiles + kTileWarps - 1) / kTileWarps,
                         32 * kTileWarps, 0, s>>>(
          nodes, num_nodes, eye, planes, tiles, rays, queue, steps, chunk,
          item_cap, r, keys, cursor, q, counters + 2 * r);
      beam_test_kernel<<<test_grid, rays, smem, s>>>(
          tris, eye, dirs, width, tile_px, queue, k_leaf, item_cap, r,
          use_eps, t_eps, q, counters + 2 * r, keys);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaMemcpyAsync(flags, counters + 2 * first,
                          sizeof(int) * 2 * (last - first),
                          cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++info[2];
    info[3] = last;
    for (int j = first; j < last; ++j) {
      if (flags[2 * (j - first) + 1] != 0) continue;
      info[0] = j + 1;  // rounds after j found every walk ended
      beam_epilogue_kernel<<<rt::card_grid(static_cast<long long>(tiles) *
                                           rays),
                             rt::kThreads, 0, s>>>(
          keys, log, stride, tiles, rays, queue, tris, num_slots, eye, dirs,
          width, tile_px, use_eps, t_eps, out_t, out_u, out_v, out_slot);
      return static_cast<int>(cudaGetLastError());
    }
  }
  info[0] = round_end;
  info[1] = 1;
  return 0;
}

// The probe behind the chain floor: one thread follows next [n_entries]
// int32 from `start` through `steps` dependent loads; out [1].  Returns
// the launch error.
int rt_chase(const int* next, int start, int steps, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, start,
                                                               steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
