// Kernels D, I and J of the port: full-frame fills of the packed
// framebuffer, and the CLUSTER frame's two shading kernels, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (`ops/cuda_build.py`).
//
// D, `clear_kernel`, replaces `_clear_kernel` in
//   raytracercuda_tpu/ops/clear.py: fill the packed framebuffer with one
//   u32 value.
// I, `gradient_kernel`, replaces the inline kernel of `color_gradient` in
//   raytracercuda_tpu/ops/gradient.py (the reference's `Gradient.cu`): six
//   colour ramps over the linear pixel index.
// J, `blob_kernel`, replaces the inline kernel of `blob` in
//   raytracercuda_tpu/ops/blob.py (the reference's `Blob.cu`): a rotating
//   rounded-square SDF, smoothstepped over a vignette, at a time passed by
//   value or read from device memory (a new time neither rebuilds nor
//   syncs the host).
//
// Packed pixels are 32 bits, the JAX package's uint32 (`ops/math.py`
// hands them out as a torch.uint32 tensor): 0xFF00FF00 is 4278255360.
//
// What bounds them on the H100: the store bandwidth, 4 bytes per pixel (a
// 256x256 frame is 256 KB, about 0.08 us at 3.35 TB/s, so at that size the
// launch itself dominates; 1920x1080 is 8.3 MB, 2.48 us).  D and I run
// near that bound; J does not: its ~44 FP32 operations per pixel, two
// IEEE divisions and a square root among them, issue as several
// instructions each, and at 4 bytes a pixel those, not its stores, set
// its time (PERF.md section 6), so it spends none on index arithmetic.
// The designs:
//   D stores four pixels (16 bytes) per thread per step over a grid sized
//     to the card (`launch.cuh`); the first n % 4 threads store the tail.
//   I works band-major: a thread takes a ramp position k of [0, block),
//     computes its colour c(k) once (the one division) and stores it into
//     the six bands at b*block + k, so a warp writes six coalesced runs of
//     128 bytes; the tail past band 5 is zero.  (Four consecutive k a
//     thread with 16-byte stores, where block % 4 == 0, measured no faster
//     at 1920x1080: PERF.md section 6.)  Indices are 32-bit below 2^31
//     pixels.
//   J launches a block per (row, chunk of four-pixel groups): ux and uy
//     come from the column and row, with no integer division.  A thread
//     computes the four pixels from column 4q and stores them with one
//     16-byte store where every row starts 16-byte aligned (w % 4 == 0),
//     else with a 4-byte store each up to the row's end.  The block's first
//     thread takes sin and cos of the time and shares them (measured faster
//     than a sin and cos a thread, PERF.md section 6).
// The wrappers take the lean host path (`cuda_build.kernel_fn`,
// `raw_stream`), since at 256x256 the call is the cost.  The library is
// built with -fmad=false and IEEE division and square root, and J calls
// the full-precision sinf/cosf on the card: every expression rounds as in
// the plain PyTorch versions (`ops/gradient.py`, `ops/blob.py`), so
// `c*ux - s*uy`, `lx*lx + ly*ly` and `bg*(1-f) + f` are not contracted.

#include <cfloat>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

// out[0, n) = value: 16-byte stores of four pixels over the quads (`out`
// is 16-byte aligned), the last n % 4 pixels by the first threads.
__global__ void clear_kernel(unsigned int* __restrict__ out, long long n,
                             unsigned int value) {
  const uint4 vv = make_uint4(value, value, value, value);
  const long long quads = n / 4;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long i = rt::thread_index(); i < quads; i += rt::thread_count())
    out4[i] = vv;
  if (rt::thread_index() < (n & 3)) out[4 * quads + rt::thread_index()] = value;
}

// c(k) of `Gradient.cu:8-40`: u32(255 * (float(k) / block)).
__device__ __forceinline__ unsigned int ramp(float k, float fblock) {
  return static_cast<unsigned int>(static_cast<int>(k / fblock * 255.0f));
}

// I (`Gradient.cu:8-40`: block = size / 6; pixel i is band i / block at
// c = ramp(i % block); past band 5, 0), band-major: k runs over [0, block),
// out[b*block + k] = band b's colour of c(k).  `Index` is int when size <
// 2^31, else long long.
template <typename Index>
__global__ void gradient_kernel(unsigned int* __restrict__ out, Index size,
                                Index block) {
  const float fblock = static_cast<float>(block);
  const Index first = static_cast<Index>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index k = first; k < block; k += stride) {
    const unsigned int c = ramp(static_cast<float>(k), fblock);
    unsigned int* p = out + k;
    p[0] = c << 16;
    p[block] = c << 8;
    p[2 * block] = c;
    p[3 * block] = (c << 16) | (c << 8);
    p[4 * block] = (c << 8) | c;
    p[5 * block] = (c << 16) | c;
  }
  if (first < size - 6 * block) out[6 * block + first] = 0;  // < 6 pixels
}

// `ops/math.pack_rgb` of one channel: clamp(x * 255, 0, 255), truncated.
__device__ __forceinline__ unsigned int to_u8(float x) {
  const float y = fminf(fmaxf(x * 255.0f, 0.0f), 255.0f);
  return static_cast<unsigned int>(static_cast<int>(y));
}

// One pixel of `Blob.cu:27-58`, in `blob.py:blob_values`' operation order;
// s_uy = s * uy and c_uy = c * uy are the row's.
__device__ __forceinline__ unsigned int blob_pixel(float ux, float s, float c,
                                                   float s_uy, float c_uy) {
  const float rx = c * ux - s_uy;
  const float ry = (s * ux + c_uy) * 2.0f;
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
  const unsigned int g = to_u8(mg);
  return (to_u8(mr) << 16) | (g << 8) | g;
}

// J: block (x, y) takes four-pixel groups [x*blockDim.x, (x+1)*blockDim.x)
// of rows y, y + gridDim.y, ...  Pixel row*w + col has ux = col - w/2 and
// uy = row - h/2 (`blob_values`' i % w and i / w).  Thread q computes
// columns 4q .. 4q + 3; with kVector (w % 4 == 0: every row starts 16-byte
// aligned, as `out` does) it stores them with one 16-byte store, else it
// stores those below w one by one.  The block's first thread takes sin
// and cos of the time (`time[0]`, or `time_value` when `time` is null) and
// shares them.
template <bool kVector>
__global__ void blob_kernel(unsigned int* __restrict__ out, int w, int h,
                            const float* __restrict__ time,
                            float time_value) {
  __shared__ float sc[2];
  if (threadIdx.x == 0) {
    const float tm = time ? time[0] : time_value;
    sc[0] = sinf(tm);
    sc[1] = cosf(tm);
  }
  __syncthreads();
  const int col = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (col >= w) return;
  const float s = sc[0];
  const float c = sc[1];
  const float half_w = static_cast<float>(w / 2);
  const float half_h = static_cast<float>(h / 2);
  const float ux = static_cast<float>(col) - half_w;
  for (int row = blockIdx.y; row < h; row += gridDim.y) {
    unsigned int* line = out + static_cast<long long>(row) * w + col;
    const float uy = static_cast<float>(row) - half_h;
    const float s_uy = s * uy;
    const float c_uy = c * uy;
    unsigned int px[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      px[j] = blob_pixel(ux + static_cast<float>(j), s, c, s_uy, c_uy);
    if (kVector) {
      *reinterpret_cast<uint4*>(line) = make_uint4(px[0], px[1], px[2], px[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < w) line[j] = px[j];
    }
  }
}

// ---------------------------------------------------------------------------
// The CLUSTER frame's shading (`trace/shade.py`: `shadow_setup`,
// `frame_shade`), one thread a pixel of the [T, R] tiles, in place of the
// plain chains `_shadow_setup_plain` and `_frame_shade_plain` (~110 PyTorch
// launches a frame).  Each expression is written in the chains' operation
// order and rounds as their separate operations do (-fmad=false, IEEE
// division and sqrtf): the frames are bit-equal.  Both read and write a few
// planes of 4 bytes a pixel (the shade also four texels of a textured hit),
// so the bytes bound them; at 512x512 the launch is most of their time.

// torch.clamp(x, min=lo), torch.clamp(x, max=hi): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// torch.remainder(x, 1.0): fmod, moved into [0, 1) by the divisor's sign
// rule (its sum may round up to 1.0).
__device__ __forceinline__ float wrap_unit(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// frame.shadow_rays (`shade._shadow_setup_plain`: `faced_ndotl_planar`,
// the active mask, `shadow_origins_planar`).  Reads A's planes t, nx, ny,
// nz ([T, R] each) and the planar [T, 3, R] directions; writes the flat
// n.l and, where `active` is not null, the [T, R] active mask and the
// planar [T, 3, R] shadow-ray origins.  `eye`, `light` ([3]) and `eps`
// (one float) are read on the device.
__global__ void shadow_setup_kernel(
    const float* __restrict__ t, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const float* __restrict__ d3, const float* __restrict__ eye,
    const float* __restrict__ light, const float* __restrict__ eps, int R,
    long long n, float* __restrict__ ndotl, bool* __restrict__ active,
    float* __restrict__ o3) {
  const float l0 = light[0], l1 = light[1], l2 = light[2];
  for (long long i = rt::thread_index(); i < n; i += rt::thread_count()) {
    const long long tile = i / R;
    const long long r = i - tile * R;
    const float* d = d3 + tile * 3 * R + r;
    const float dx = d[0], dy = d[R], dz = d[2 * R];
    float x = nx[i], y = ny[i], z = nz[i];
    // normalize(n, eps=1e-30) per component, then face the ray.
    const float len = sqrtf(clamp_min(x * x + y * y + z * z, 1e-30f));
    x = x / len;
    y = y / len;
    z = z / len;
    if (x * dx + y * dy + z * dz > 0.0f) {
      x = -x;
      y = -y;
      z = -z;
    }
    const float nl = clamp_min(x * l0 + y * l1 + z * l2, 0.0f);
    ndotl[i] = nl;
    if (active == nullptr) continue;
    const float ti = t[i];
    const bool act = ti < FLT_MAX && nl > 0.0f;
    active[i] = act;
    // The hit point at t clamped at 1e6 where active, else the eye, pushed
    // eps along the light.
    const float tmin = clamp_max(ti, 1e6f);
    const float e = eps[0];
    const float dir[3] = {dx, dy, dz};
    float* o = o3 + tile * 3 * R + r;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float base = act ? eye[c] + dir[c] * tmin : eye[c];
      o[c * R] = base + light[c] * e;
    }
  }
}

// One channel of `sample_texture`'s bilinear fetch: rows y0 and y1 of
// texture `tex` (clamped into the atlas), columns x0 and x1.
__device__ __forceinline__ float bilinear(const float* __restrict__ texels,
                                          long long row0, long long row1,
                                          long long x0, long long x1, int c,
                                          float ax, float ay) {
  const float c00 = texels[(row0 + x0) * 3 + c];
  const float c01 = texels[(row0 + x1) * 3 + c];
  const float c10 = texels[(row1 + x0) * 3 + c];
  const float c11 = texels[(row1 + x1) * 3 + c];
  const float top = c00 * (1.0f - ax) + c01 * ax;
  const float bot = c10 * (1.0f - ax) + c11 * ax;
  return top * (1.0f - ay) + bot * ay;
}

// frame.shade (`shade._frame_shade_plain`: the shadow, `lambert_planar`
// with `sample_texture`, the background, `pack_rgb`, `untile_pixels`).
// Reads t, the flat n.l, the [T, R] occlusion (null: no shadows), the
// albedo planes and, where `tex` is not null, the texture id, u and v
// planes and the [tex_n, tex_h, tex_w, 3] atlas; writes each pixel's
// 0x00RRGGBB to its row-major place in `out` [H*W].
__global__ void frame_shade_kernel(
    const float* __restrict__ t, const float* __restrict__ ndotl,
    const bool* __restrict__ shadow, const float* __restrict__ ar,
    const float* __restrict__ ag, const float* __restrict__ ab,
    const float* __restrict__ tex, const float* __restrict__ tu,
    const float* __restrict__ tv, const float* __restrict__ textures,
    int tex_n, int tex_h, int tex_w, float ambient, float diffuse,
    float bg_r, float bg_g, float bg_b, int tile_px, int tiles_x, int width,
    long long n, unsigned int* __restrict__ out) {
  const long long R = static_cast<long long>(tile_px) * tile_px;
  for (long long i = rt::thread_index(); i < n; i += rt::thread_count()) {
    float r = bg_r, g = bg_g, b = bg_b;
    if (t[i] < FLT_MAX) {
      const float nl = shadow != nullptr && shadow[i] ? 0.0f : ndotl[i];
      r = ar[i];
      g = ag[i];
      b = ab[i];
      if (tex != nullptr) {
        const int id = static_cast<int>(tex[i]);
        if (id >= 0) {
          const float fu = wrap_unit(tu[i]) * static_cast<float>(tex_w - 1);
          const float fv = wrap_unit(tv[i]) * static_cast<float>(tex_h - 1);
          const long long x0 = static_cast<long long>(floorf(fu));
          const long long y0 = static_cast<long long>(floorf(fv));
          const long long x1 = x0 + 1 < tex_w - 1 ? x0 + 1 : tex_w - 1;
          const long long y1 = y0 + 1 < tex_h - 1 ? y0 + 1 : tex_h - 1;
          const float ax = fu - static_cast<float>(x0);
          const float ay = fv - static_cast<float>(y0);
          const long long tid = id < tex_n - 1 ? id : tex_n - 1;
          const long long row0 = (tid * tex_h + y0) * tex_w;
          const long long row1 = (tid * tex_h + y1) * tex_w;
          r = r * bilinear(textures, row0, row1, x0, x1, 0, ax, ay);
          g = g * bilinear(textures, row0, row1, x0, x1, 1, ax, ay);
          b = b * bilinear(textures, row0, row1, x0, x1, 2, ax, ay);
        }
      }
      const float lit = ambient + diffuse * nl;
      r = r * lit;
      g = g * lit;
      b = b * lit;
    }
    const long long tile = i / R;
    const long long p = i - tile * R;
    const long long row = tile / tiles_x * tile_px + p / tile_px;
    const long long col = tile % tiles_x * tile_px + p % tile_px;
    out[row * width + col] = (to_u8(r) << 16) | (to_u8(g) << 8) | to_u8(b);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success).

// `out` must be 16-byte aligned.
int rt_clear(unsigned int* out, long long n, unsigned int value,
             void* stream) {
  if (n == 0) return 0;
  clear_kernel<<<rt::card_grid(n / 4), rt::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(out, n, value);
  return static_cast<int>(cudaGetLastError());
}

// size >= 6 (the wrapper raises below that: block would be 0).
int rt_gradient(unsigned int* out, long long size, void* stream) {
  if (size == 0) return 0;
  const long long block = size / 6;
  const int grid = rt::card_grid(block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (size < (1LL << 31)) {
    gradient_kernel<int><<<grid, rt::kThreads, 0, s>>>(
        out, static_cast<int>(size), static_cast<int>(block));
  } else {
    gradient_kernel<long long><<<grid, rt::kThreads, 0, s>>>(out, size,
                                                             block);
  }
  return static_cast<int>(cudaGetLastError());
}

// `out` must be 16-byte aligned.  The time is `time[0]` on the device, or
// `time_value` when `time` is null.
int rt_blob(unsigned int* out, int w, int h, const float* time,
            float time_value, void* stream) {
  if (w <= 0 || h <= 0) return 0;
  const int groups = (w + 3) / 4;  // four-pixel groups a row
  int threads = (groups + 31) / 32 * 32;
  threads = threads > rt::kThreads ? rt::kThreads : threads;
  const dim3 grid((groups + threads - 1) / threads, h < 65535 ? h : 65535);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0) {
    blob_kernel<true><<<grid, threads, 0, s>>>(out, w, h, time, time_value);
  } else {
    blob_kernel<false><<<grid, threads, 0, s>>>(out, w, h, time, time_value);
  }
  return static_cast<int>(cudaGetLastError());
}

// frame.shadow_rays over n = T*R pixels of R a tile.  `active` and `o3`
// null: only n.l (a frame without shadows).
int rt_shadow_setup(const float* t, const float* nx, const float* ny,
                    const float* nz, const float* d3, const float* eye,
                    const float* light, const float* eps, int R, long long n,
                    float* ndotl, bool* active, float* o3, void* stream) {
  if (n == 0) return 0;
  shadow_setup_kernel<<<rt::card_grid(n), rt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      t, nx, ny, nz, d3, eye, light, eps, R, n, ndotl, active, o3);
  return static_cast<int>(cudaGetLastError());
}

// frame.shade over n = T*R pixels of tile_px^2 a tile, the frame `width`
// pixels wide (a multiple of tile_px).  `shadow` null: no shadows; `tex`
// null: untextured (`tu`, `tv`, `textures` unread).
int rt_frame_shade(const float* t, const float* ndotl, const bool* shadow,
                   const float* ar, const float* ag, const float* ab,
                   const float* tex, const float* tu, const float* tv,
                   const float* textures, int tex_n, int tex_h, int tex_w,
                   float ambient, float diffuse, float bg_r, float bg_g,
                   float bg_b, int tile_px, int width, long long n,
                   unsigned int* out, void* stream) {
  if (n == 0) return 0;
  frame_shade_kernel<<<rt::card_grid(n), rt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, ndotl, shadow, ar, ag, ab, tex, tu, tv, textures, tex_n, tex_h,
      tex_w, ambient, diffuse, bg_r, bg_g, bg_b, tile_px, width / tile_px,
      width, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
