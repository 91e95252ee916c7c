// The oracle's Moller-Trumbore test (`ops/math.tri_intersect`), shared by
// kernel E (brute.cu), kernels K and L (bvh.cu) and kernel M (grid.cu): the
// NaN miss rule, no |det| threshold, and with use_eps t < t_eps clipped.
// K, L and M read a triangle as a 48-byte row v0 | e1 | e2 (`Tri`); M
// from a common origin reads its staged eye terms instead (`eye_mt`).
// Built with -fmad=false and IEEE division, each expression rounds as the
// plain PyTorch versions' separate operations do.
#pragma once

#include <cuda_runtime.h>

#include "hit_key.cuh"

namespace {

// The oracle's test of one ray against the face v0|e1|e2 (`tri_intersect`,
// math.py:80-108): returns t, FLT_MAX on a miss or, with use_eps, below
// t_eps; u and v as computed.
__device__ __forceinline__ float oracle_mt(float v0x, float v0y, float v0z,
                                           float e1x, float e1y, float e1z,
                                           float e2x, float e2y, float e2z,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           bool use_eps, float t_eps,
                                           float& u, float& v) {
  // pvec = d x e2; det = e1 . pvec.
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / det;
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  v = 0.0f;
  // The miss tests in the order the terms come: u < 0, u > 1 or a NaN u
  // needs no v or t, and most pairs leave here (a warp whose rays all
  // leave skips the rest).  A hit runs every term as the oracle does.
  if (!(u >= 0.0f && u <= 1.0f)) return kFltMax;
  // qvec = tvec x e1.
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  if (!(v >= 0.0f && u + v <= 1.0f)) return kFltMax;  // or a NaN v
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  if (isnan(t) || (use_eps && t < t_eps)) return kFltMax;
  return t;
}

// The oracle's test of a ray leaving the common origin o against a face
// whose eye terms are staged (`grid_march.eye_rows`): tvec = o - v0, qvec =
// tvec x e1 and tq = e2 . qvec, each rounded as `oracle_mt` rounds them.
// Only the terms of the ray are computed here, in the oracle's order and
// with its early exits: t, u and v are `oracle_mt`'s bit for bit.
__device__ __forceinline__ float eye_mt(float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float tvx, float tvy, float tvz,
                                        float qvx, float qvy, float qvz,
                                        float tq, float dx, float dy,
                                        float dz, bool use_eps, float t_eps,
                                        float& u, float& v) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / det;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  v = 0.0f;
  if (!(u >= 0.0f && u <= 1.0f)) return kFltMax;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  if (!(v >= 0.0f && u + v <= 1.0f)) return kFltMax;
  const float t = tq * inv;
  if (isnan(t) || (use_eps && t < t_eps)) return kFltMax;
  return t;
}

// A row of the triangle table: v0xyz e1x | e1yz e2xy | e2z and padding.
struct Tri {
  float4 a, b, c;
};

__device__ __forceinline__ Tri load_tri(const float4* __restrict__ rows,
                                        int row) {
  return Tri{__ldg(rows + 3 * row), __ldg(rows + 3 * row + 1),
             __ldg(rows + 3 * row + 2)};
}

__device__ __forceinline__ float tri_mt(const Tri& w, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, bool use_eps, float t_eps,
                                        float& u, float& v) {
  return oracle_mt(w.a.x, w.a.y, w.a.z, w.a.w, w.b.x, w.b.y, w.b.z, w.b.w,
                   w.c.x, ox, oy, oz, dx, dy, dz, use_eps, t_eps, u, v);
}

}  // namespace
