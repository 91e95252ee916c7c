// The 64-bit hit key that merges closest hits across blocks: the split
// sweeps C and F (sweep.cu) key a ray's hit by its slot, the face-split
// brute force E (brute.cu) by its face id.  A block merges each ray's best
// hit with one atomicMin on the key; the smallest t wins and, among equal
// t, the smallest id, which is the first minimum of a serial sweep in
// ascending id order with a strict `<`.
#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr float kFltMax = 3.40282346638528859812e+38f;
// The key of a miss: FLT_MAX's ordered bits, id 0.  Every hit's key is
// smaller, since only t < FLT_MAX is keyed.
constexpr unsigned long long kMissKey = 0xFF7FFFFF00000000ull;

// A hit's key: t's bits mapped to an unsigned order that is monotone over
// every non-NaN float, above the id.  -0.0 maps as +0.0 (the two tie under
// `<`).
__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  unsigned int b = __float_as_uint(t);
  if (b == 0x80000000u) b = 0u;  // -0.0
  const unsigned int ordered = b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu
                                                      : 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) |
         static_cast<unsigned int>(id);
}

// keys[0, n) = the miss key.
__global__ void fill_keys_kernel(unsigned long long* __restrict__ keys,
                                 long long n) {
  for (long long i = rt::thread_index(); i < n; i += rt::thread_count())
    keys[i] = kMissKey;
}

}  // namespace
