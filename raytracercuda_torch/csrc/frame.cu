// Kernels D, I and J of the port: full-frame fills of the packed
// framebuffer, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (`ops/cuda_build.py`).
//
// D, `clear_kernel`, replaces `_clear_kernel` in
//   raytracercuda_tpu/ops/clear.py: fill the packed framebuffer with one
//   u32 value.
// I, `gradient_kernel`, replaces the inline kernel of `color_gradient` in
//   raytracercuda_tpu/ops/gradient.py (the reference's `Gradient.cu`): six
//   colour ramps over the linear pixel index.
// J, `blob_kernel`, replaces the inline kernel of `blob` in
//   raytracercuda_tpu/ops/blob.py (the reference's `Blob.cu`): a rotating
//   rounded-square SDF, smoothstepped over a vignette, at a time read from
//   device memory (so a new time neither rebuilds nor syncs the host).
//
// The port keeps packed pixels in int64 (torch has little uint32 support),
// so each element is the u32 value zero-extended to 64 bits: 0xFF00FF00
// stays 4278255360, not a negative number.
//
// What bounds them on the H100: the store bandwidth, 8 bytes per pixel (a
// 256x256 frame is 512 KB, about 0.16 us at 3.35 TB/s, so at that size the
// launch itself dominates); J's ~40 FP32 operations per pixel are far below
// the FP32 rate.  The design: grid-stride loops.  D, a pure store stream,
// stores two pixels (16 bytes) per thread per step over a grid sized to
// the card (`launch.cuh`), and its wrapper takes the lean host path
// (`cuda_build.kernel_fn`, `raw_stream`), since at 256x256 the call is
// the cost; I and J store one pixel per step.  The library is built with
// -fmad=false and IEEE division and
// square root, and J calls the full-precision sinf/cosf: every expression
// rounds as in the plain PyTorch versions (`ops/gradient.py`,
// `ops/blob.py`), so `c*ux - s*uy`, `lx*lx + ly*ly` and `bg*(1-f) + f` are
// not contracted.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

int grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// out[0, n) = value: 16-byte stores of two pixels over the pairs (`out`
// is 16-byte aligned), the odd last pixel by the first thread.
__global__ void clear_kernel(long long* __restrict__ out, long long n,
                             unsigned int value) {
  const long long v = static_cast<long long>(value);
  const longlong2 vv = make_longlong2(v, v);
  const long long pairs = n / 2;
  longlong2* out2 = reinterpret_cast<longlong2*>(out);
  for (long long i = rt::thread_index(); i < pairs; i += rt::thread_count())
    out2[i] = vv;
  if ((n & 1) && rt::thread_index() == 0) out[n - 1] = v;
}

// `Gradient.cu:8-40`: i = i < size ? i : 0; block = size / 6; band i / block;
// c = u32(255 * (float(i % block) / block)); bands past 5 stay 0.
__global__ void gradient_kernel(long long* __restrict__ out, long long size) {
  const long long block = size / 6;
  const float fblock = static_cast<float>(block);
  for (long long i = first_index(); i < size; i += grid_stride()) {
    const long long j = i < size ? i : 0;
    const long long band = j / block;
    const long long c = static_cast<long long>(static_cast<int>(
        static_cast<float>(j % block) / fblock * 255.0f));
    long long v = 0;
    switch (band) {
      case 0: v = c << 16; break;
      case 1: v = c << 8; break;
      case 2: v = c; break;
      case 3: v = (c << 16) | (c << 8); break;
      case 4: v = (c << 8) | c; break;
      case 5: v = (c << 16) | c; break;
      default: break;
    }
    out[i] = v;
  }
}

// `ops/math.pack_rgb` of one channel: clamp(x * 255, 0, 255), truncated.
__device__ __forceinline__ long long to_u8(float x) {
  const float y = fminf(fmaxf(x * 255.0f, 0.0f), 255.0f);
  return static_cast<long long>(static_cast<int>(y));
}

// `Blob.cu:27-58`, in `blob.py:blob_values`' operation order.
__global__ void blob_kernel(long long* __restrict__ out, int w, int h,
                            const float* __restrict__ time) {
  const long long size = static_cast<long long>(w) * h;
  const float tm = time[0];
  const float s = sinf(tm);
  const float c = cosf(tm);
  const float half_w = static_cast<float>(w / 2);
  const float half_h = static_cast<float>(h / 2);
  for (long long i = first_index(); i < size; i += grid_stride()) {
    const long long j = i < size ? i : size;
    const float ux = static_cast<float>(j % w) - half_w;
    const float uy = static_cast<float>(j / w) - half_h;
    const float rx = c * ux - s * uy;
    const float ry = (s * ux + c * uy) * 2.0f;
    // Rounded square of half-size 100 (`Blob.cu:5-11`).
    const float dx = fabsf(rx) - 100.0f;
    const float dy = fabsf(ry) - 100.0f;
    const float inside = fminf(0.0f, fmaxf(dx, dy));
    const float lx = fmaxf(dx, 0.0f);
    const float ly = fmaxf(dy, 0.0f);
    const float d = inside + sqrtf(lx * lx + ly * ly);
    // 1 - smoothstep(-1, 1, d).
    const float st = fminf(fmaxf((d - -1.0f) / 2.0f, 0.0f), 1.0f);
    const float f = 1.0f - st * st * (3.0f - 2.0f * st);
    // The vignette (1 - clip(d / 1500))^2 over white, mixed with red by f.
    const float shade = 1.0f - fminf(fmaxf(d / 1500.0f, 0.0f), 1.0f);
    const float bg = shade * shade;
    const float keep = 1.0f - f;
    const float mr = bg * keep + 1.0f * f;
    const float mg = bg * keep;
    out[i] = (to_u8(mr) << 16) | (to_u8(mg) << 8) | to_u8(mg);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success).

// `out` must be 16-byte aligned.
int rt_clear(long long* out, long long n, unsigned int value, void* stream) {
  if (n == 0) return 0;
  clear_kernel<<<rt::card_grid(n / 2), rt::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(out, n, value);
  return static_cast<int>(cudaGetLastError());
}

// size >= 6 (the wrapper raises below that: block would be 0).
int rt_gradient(long long* out, long long size, void* stream) {
  if (size == 0) return 0;
  gradient_kernel<<<grid_for(size), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(out, size);
  return static_cast<int>(cudaGetLastError());
}

int rt_blob(long long* out, int w, int h, const float* time, void* stream) {
  const long long n = static_cast<long long>(w) * h;
  if (n == 0) return 0;
  blob_kernel<<<grid_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(out, w, h, time);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
