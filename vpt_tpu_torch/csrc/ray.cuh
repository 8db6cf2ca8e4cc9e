// Per-pixel ray pieces shared by the kernels that run one thread a pixel:
// the MCM event kernel (mcm_event.cu), the march kernel (march.cu), the ISO
// shade kernel (iso_shade.cu) and the MCS delta-tracking kernel
// (mcs_frame.cu), the equirect environment lookup of the MC kernels, the
// pixel tiles of the frame kernels, the 2D TF lookup (also the LAO
// kernel's, lao_march.cu) and the fetch of two-channel and filtered
// volumes.
//
// Each function runs the float32 operations of its plain PyTorch version
// (vpt_tpu_torch/rng.py, sampling.py) in their order; the kernels are built
// with -fmad=false, so no product-sum contracts into one rounding.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "tf1d.cuh"

// rng.pcg: the PCG output permutation
__device__ __forceinline__ uint32_t vpt_pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

// rng.uniform: state = pcg(state); u = float(state) / float(~0u).
// float(~0u) is 2^32, so the quotient is exact and equals the product with
// 2^-32
__device__ __forceinline__ float vpt_uniform(uint32_t& s) {
  s = vpt_pcg(s);
  return __uint2float_rn(s) * 2.3283064365386963e-10f;
}

// rng.exponential: -log(max(u, 1e-38)) / rate, the IEEE quotient
__device__ __forceinline__ float vpt_exponential(uint32_t& s, float rate) {
  float x = vpt_nmax(vpt_uniform(s), 1e-38f);
  return -logf(x) / rate;
}

// rng.seed_pixels: pcg(19 x + 47 y + 101 seed + 131) over the float bits of
// the mapped position (ndc * 0.5 + 0.5) and of the seed
__device__ __forceinline__ uint32_t vpt_seed_pixel(float ndcx, float ndcy,
                                                   float seed) {
  return vpt_pcg(19u * __float_as_uint(ndcx * 0.5f + 0.5f)
                 + 47u * __float_as_uint(ndcy * 0.5f + 0.5f)
                 + 101u * __float_as_uint(seed) + 131u);
}

// sampling.pixel_ndc: (i + 0.5) / n * 2 - 1, the IEEE quotient; a launch
// over a window of rows passes the row in the whole image and its height
__device__ __forceinline__ float vpt_pixel_ndc(int i, int n) {
  return ((float)i + 0.5f) / (float)n * 2.0f - 1.0f;
}

// sampling.unproject(_rand): the near point (nx, ny, -1, 1) and the far
// point (fx, fy, 1, 1) through the row-major inverse MVP m (apply_mat4,
// math3d.py: out_i = v0 m[i,0] + v1 m[i,1] + v2 m[i,2] + v3 m[i,3], left
// to right), then the homogeneous divides.
__device__ __forceinline__ void vpt_unproject(const float* m, float nx,
                                              float ny, float fx, float fy,
                                              float from[3], float to[3]) {
  float f4[4], t4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f4[i] = nx * m[4 * i] + ny * m[4 * i + 1] + -1.0f * m[4 * i + 2]
            + 1.0f * m[4 * i + 3];
    t4[i] = fx * m[4 * i] + fy * m[4 * i + 1] + 1.0f * m[4 * i + 2]
            + 1.0f * m[4 * i + 3];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    from[k] = f4[k] / f4[3];
    to[k] = t4[k] / t4[3];
  }
}

// sampling.intersect_cube: the slab test against the unit cube, (tnear,
// tfar), with NaN-propagating min and max as torch.minimum/amax
__device__ __forceinline__ void vpt_intersect_cube(const float o[3],
                                                   const float d[3],
                                                   float* tnear,
                                                   float* tfar) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tmin = (0.0f - o[k]) / d[k];
    float tmax = (1.0f - o[k]) / d[k];
    float t1 = vpt_nmin(tmin, tmax);
    float t2 = vpt_nmax(tmin, tmax);
    *tnear = (k == 0) ? t1 : vpt_nmax(*tnear, t1);
    *tfar = (k == 0) ? t2 : vpt_nmin(*tfar, t2);
  }
}

// sampling.intersect_box: the slab test against the box [lo, hi] (the march
// clamp's boxes), as vpt_intersect_cube
__device__ __forceinline__ void vpt_intersect_box(const float o[3],
                                                  const float d[3],
                                                  const float lo[3],
                                                  const float hi[3],
                                                  float* tnear,
                                                  float* tfar) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tmin = (lo[k] - o[k]) / d[k];
    float tmax = (hi[k] - o[k]) / d[k];
    float t1 = vpt_nmin(tmin, tmax);
    float t2 = vpt_nmax(tmin, tmax);
    *tnear = (k == 0) ? t1 : vpt_nmax(*tnear, t1);
    *tfar = (k == 0) ? t2 : vpt_nmin(*tfar, t2);
  }
}

// sampling.sample_environment: the equirect lookup of direction d in an
// (eh, ew) RGBA float32 map, u = atan2(d.x, -d.z)/pi/2 + 0.5 and
// v = asin(clip(-d.y, -1, 1))*2/pi/2 + 0.5 in the plain order, then
// sample_texture2d's bilinear CLAMP_TO_EDGE fetch with its lerp order.  The
// map is read through the read-only cache from global memory (a 2048 x
// 1024 map is 32 MB).  atan2f and asinf are CUDA's: torch's CUDA atan2 and
// asin call the same functions, other libraries may differ in the last
// bit.
__device__ __forceinline__ float4 vpt_lerp4(float4 a, float4 b, float f) {
  const float g = 1.0f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f,
                     a.z * g + b.z * f, a.w * g + b.w * f);
}

__device__ __forceinline__ float4 vpt_sample_environment(const float4* map,
                                                         int eh, int ew,
                                                         float dx, float dy,
                                                         float dz) {
  const float invpi = 0.31830988618f;
  const float u = atan2f(dx, -dz) * invpi * 0.5f + 0.5f;
  const float v = asinf(vpt_clip(-dy, -1.0f, 1.0f)) * 2.0f * invpi * 0.5f
                  + 0.5f;
  const float ux = vpt_clip(u * (float)ew - 0.5f, 0.0f, (float)(ew - 1));
  const float uy = vpt_clip(v * (float)eh - 0.5f, 0.0f, (float)(eh - 1));
  const float ix = floorf(ux), iy = floorf(uy);
  const int x0 = vpt_index(ix), y0 = vpt_index(iy);
  const int x1 = min(x0 + 1, ew - 1), y1 = min(y0 + 1, eh - 1);
  const float fx = ux - ix, fy = uy - iy;
  const float4 c0 = vpt_lerp4(__ldg(map + (int64_t)y0 * ew + x0),
                              __ldg(map + (int64_t)y0 * ew + x1), fx);
  const float4 c1 = vpt_lerp4(__ldg(map + (int64_t)y1 * ew + x0),
                              __ldg(map + (int64_t)y1 * ew + x1), fx);
  return vpt_lerp4(c0, c1, fy);
}

// Trilinear fetch from a corner-packed (D*H*W, 8) table of float32 or
// bfloat16 rows (sampling.py, corner_fetch_plain): the GL CLAMP_TO_EDGE
// coordinate, one row of the 8 corners (z, y, x; x minor), then the lerp
// chain of trilerp_chain.  In three pieces, so that a kernel can issue
// several rows' reads before it folds any of them: vpt_cell (the row and
// the fractions), vpt_load_row (the read), vpt_lerp_row (the lerps).
// Row is the row index's type: int64_t takes any table; int takes tables
// below 2^31 rows, and its wrapper raises for larger ones.
template <class Row>
struct VptCell {
  Row row;
  float fx, fy, fz;
};

template <class Row>
__device__ __forceinline__ VptCell<Row> vpt_cell(int d, int h, int w,
                                                 float px, float py,
                                                 float pz) {
  const float ux = vpt_clip(px * (float)w - 0.5f, 0.0f, (float)(w - 1));
  const float uy = vpt_clip(py * (float)h - 0.5f, 0.0f, (float)(h - 1));
  const float uz = vpt_clip(pz * (float)d - 0.5f, 0.0f, (float)(d - 1));
  const float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  VptCell<Row> c;
  c.row = ((Row)vpt_index(iz) * h + vpt_index(iy)) * w + vpt_index(ix);
  c.fx = ux - ix;
  c.fy = uy - iy;
  c.fz = uz - iz;
  return c;
}

// One corner row as read: 8 bf16 in a uint4, or 8 float32 in two float4.
template <bool kBf16>
struct VptRow;
template <>
struct VptRow<true> {
  uint4 q;
};
template <>
struct VptRow<false> {
  float4 a, b;
};

template <bool kBf16, class Row>
__device__ __forceinline__ VptRow<kBf16> vpt_load_row(const void* table,
                                                      Row row) {
  if constexpr (kBf16) {
    return {__ldg(static_cast<const uint4*>(table) + row)};
  } else {
    const float4* p = static_cast<const float4*>(table) + 2 * (int64_t)row;
    return {__ldg(p), __ldg(p + 1)};
  }
}

// The lerp chain from the fractions f and their complements g = 1 - f of
// the three axes (a kernel that shares one axis's coordinate between
// several fetches computes each g once).
template <bool kBf16>
__device__ __forceinline__ float vpt_lerp_row_fg(const VptRow<kBf16>& r,
                                                 float fx, float gx,
                                                 float fy, float gy,
                                                 float fz, float gz) {
  float c[8];
  if constexpr (kBf16) {
    const uint32_t words[4] = {r.q.x, r.q.y, r.q.z, r.q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] = __uint_as_float(words[k] << 16);
      c[2 * k + 1] = __uint_as_float(words[k] & 0xFFFF0000u);
    }
  } else {
    c[0] = r.a.x; c[1] = r.a.y; c[2] = r.a.z; c[3] = r.a.w;
    c[4] = r.b.x; c[5] = r.b.y; c[6] = r.b.z; c[7] = r.b.w;
  }
  float cx0 = c[0] * gx + c[1] * fx;
  float cx1 = c[2] * gx + c[3] * fx;
  float cx2 = c[4] * gx + c[5] * fx;
  float cx3 = c[6] * gx + c[7] * fx;
  float cy0 = cx0 * gy + cx1 * fy;
  float cy1 = cx2 * gy + cx3 * fy;
  return cy0 * gz + cy1 * fz;
}

template <bool kBf16, class Row>
__device__ __forceinline__ float vpt_lerp_row(const VptRow<kBf16>& r,
                                              const VptCell<Row>& cell) {
  return vpt_lerp_row_fg<kBf16>(r, cell.fx, 1.0f - cell.fx, cell.fy,
                                1.0f - cell.fy, cell.fz, 1.0f - cell.fz);
}

// The whole fetch, with a 64-bit row index (any table) unless Row says
// otherwise.
template <bool kBf16, class Row = int64_t>
__device__ __forceinline__ float vpt_fetch(const void* table, int d, int h,
                                           int w, float px, float py,
                                           float pz) {
  const VptCell<Row> cell = vpt_cell<Row>(d, h, w, px, py, pz);
  return vpt_lerp_row<kBf16>(vpt_load_row<kBf16>(table, cell.row), cell);
}

// The pixel tiles of the per-pixel frame kernels (march.cu, mcs_frame.cu):
// a block of 128 threads covers 16 x 8 pixels, each warp an 8 x 4 part of
// it, so that a warp's rays are neighbours in both directions: they read
// neighbouring corner rows at a slice and leave their loops at similar
// slices.  Blocks run over the tiles row-major; threads past the image's
// edge have no pixel.  The kernels' info entry points report the shape.
constexpr int kVptTileThreads = 128;
constexpr int kVptTileW = 16;
constexpr int kVptTileH = kVptTileThreads / kVptTileW;
constexpr int kVptWarpW = 8;
constexpr int kVptWarpH = 32 / kVptWarpW;
static_assert(kVptTileW % kVptWarpW == 0 && kVptTileH % kVptWarpH == 0,
              "a block tile is a whole number of warp tiles");

__host__ __device__ __forceinline__ long long vpt_tile_blocks(int width,
                                                              int height) {
  return (long long)((width + kVptTileW - 1) / kVptTileW)
         * ((height + kVptTileH - 1) / kVptTileH);
}

// (x, y) of this thread's pixel; false past the image's edge.
__device__ __forceinline__ bool vpt_tile_pixel(int width, int height, int* x,
                                               int* y) {
  const int tiles_x = (width + kVptTileW - 1) / kVptTileW;
  const int by = blockIdx.x / tiles_x, bx = blockIdx.x - by * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarpsX = kVptTileW / kVptWarpW;
  *x = bx * kVptTileW + (warp % kWarpsX) * kVptWarpW + lane % kVptWarpW;
  *y = by * kVptTileH + (warp / kWarpsX) * kVptWarpH + lane / kVptWarpW;
  return *x < width && *y < height;
}

// The color of a fetched value v: the TF row's lookup (Scene.sample_color),
// or, from a cheb-skip tracking table (Scene.sample_color_tracking), the
// lookup at max(v, 0) with alpha 0 in empty cells (v < -0.5).
__device__ __forceinline__ float4 vpt_color(const float4* tf, int tw,
                                            int tf_mode, float v,
                                            bool tracking) {
  if (!tracking) return vpt_tf1d_lookup(tf, tw, v, tf_mode);
  float4 c = vpt_tf1d_lookup(tf, tw, vpt_nmax(v, 0.0f), tf_mode);
  if (v < -0.5f) c.w = 0.0f;
  return c;
}

// The 2D bilinear lookup of sampling.sample_texture2d_packed at uv = (u, v)
// from one (16,) row of 2 x 2 texel corners (x minor), four channels each,
// of the packed (TH*TW, 16) TF table, read through the read-only cache.
template <bool kTfBf16>
__device__ __forceinline__ float4 vpt_tf2d(const void* table, int tw, int th,
                                           float u, float v) {
  const float ux = vpt_clip(u * (float)tw - 0.5f, 0.0f, (float)(tw - 1));
  const float uy = vpt_clip(v * (float)th - 0.5f, 0.0f, (float)(th - 1));
  const float ix = floorf(ux), iy = floorf(uy);
  const float fx = ux - ix, fy = uy - iy;
  const int64_t row = (int64_t)vpt_index(iy) * tw + vpt_index(ix);
  float c[16];
  if constexpr (kTfBf16) {
    const uint4* p = static_cast<const uint4*>(table) + 2 * row;
    const uint4 q0 = __ldg(p), q1 = __ldg(p + 1);
    const uint32_t words[8] = {q0.x, q0.y, q0.z, q0.w,
                               q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[2 * k] = __uint_as_float(words[k] << 16);
      c[2 * k + 1] = __uint_as_float(words[k] & 0xFFFF0000u);
    }
  } else {
    const float4* p = static_cast<const float4*>(table) + 4 * row;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 q = __ldg(p + k);
      c[4 * k] = q.x; c[4 * k + 1] = q.y; c[4 * k + 2] = q.z;
      c[4 * k + 3] = q.w;
    }
  }
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float out[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float cx0 = c[ch] * gx + c[4 + ch] * fx;
    const float cx1 = c[8 + ch] * gx + c[12 + ch] * fx;
    out[ch] = cx0 * gy + cx1 * fy;
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

// The fetch of a two-channel or filtered scene (make_scene of a
// multi-channel volume, Volume.filter "nearest" or "cubic"): the kernels'
// ext instances, beside the headline's linear single-channel ones, whose
// code stays as it was.  Scene.sample_color there is TF(volume_rg(p)):
//
// - the filter (sampling.FILTERS, a warp-uniform argument): "cubic" warps
//   the position as sampling.cubic_warp does, (floor(u) + (f*f)*(3-2f) -
//   0.5) / N of u = p*N + 0.5, then fetches linearly.  "nearest" takes the
//   linear cell and snaps each fraction to 0 or 1, so the lerp chain
//   returns one corner exactly (c*1 + c'*0): the +1 corner iff f >= 0.5.
//   That is sample_volume_nearest's texel int(clip(x, 0, N - 0.5)) of
//   x = p*N: for 0.5 <= x <= N - 0.5, x - 0.5 is exact in float32 (x <
//   2^23), the cell is floor(x - 0.5) and floor(x) is one more iff the
//   fraction is >= 0.5; below 0.5 both read texel 0 and above N - 0.5
//   both read N - 1 (the linear coordinate clips to N - 1 with f = 0).
//   tests/test_torch_filters.py holds this twin to sampling bit for bit.
// - two channels: a row holds the 8 corners' (value, channel 1) pairs,
//   corner-major, channel minor (pack_corner_volume's (8, C) lanes): 32
//   bytes in bf16, 64 in float32; the lerp chain runs on each channel.
// - the color: one channel looks the value up in the TF row (tf1d.cuh);
//   two look (value, channel 1) up in the packed 2D TF table (vpt_tf2d),
//   which has the corner table's type (make_scene packs both alike).
enum VptFilter { kVptLinear = 0, kVptNearest = 1, kVptCubic = 2 };

// sampling.cubic_warp of one axis of n texels
__device__ __forceinline__ float vpt_cubic_axis(float p, int n) {
  const float fn = (float)n;
  const float u = p * fn + 0.5f;
  const float fl = floorf(u);
  const float f = u - fl;
  return ((fl + f * f * (3.0f - 2.0f * f)) - 0.5f) / fn;
}

template <class Row>
__device__ __forceinline__ VptCell<Row> vpt_cell_filtered(int d, int h,
                                                          int w, float px,
                                                          float py, float pz,
                                                          int filter) {
  if (filter == kVptCubic) {
    px = vpt_cubic_axis(px, w);
    py = vpt_cubic_axis(py, h);
    pz = vpt_cubic_axis(pz, d);
  }
  VptCell<Row> c = vpt_cell<Row>(d, h, w, px, py, pz);
  if (filter == kVptNearest) {
    c.fx = c.fx >= 0.5f ? 1.0f : 0.0f;
    c.fy = c.fy >= 0.5f ? 1.0f : 0.0f;
    c.fz = c.fz >= 0.5f ? 1.0f : 0.0f;
  }
  return c;
}

// A row of two-channel corners as read: 16 bf16 in two uint4, or 16
// float32 in four float4.
template <bool kBf16>
struct VptRow2;
template <>
struct VptRow2<true> {
  uint4 a, b;
};
template <>
struct VptRow2<false> {
  float4 a, b, c, d;
};

// the row of kC = 1 or 2 channels
template <bool kBf16, int kC>
using VptRowOf = std::conditional_t<kC == 2, VptRow2<kBf16>, VptRow<kBf16>>;

// Channel 0 of a two-channel row: vpt_lerp_row_fg's chain on the corners'
// first channel (the low bf16 of each word, or .x and .z of each float4).
template <bool kBf16>
__device__ __forceinline__ float vpt_lerp_row_fg(const VptRow2<kBf16>& r,
                                                 float fx, float gx,
                                                 float fy, float gy,
                                                 float fz, float gz) {
  float c[8];
  if constexpr (kBf16) {
    const uint32_t words[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                               r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = __uint_as_float(words[k] << 16);
  } else {
    const float4 q[4] = {r.a, r.b, r.c, r.d};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] = q[k].x;
      c[2 * k + 1] = q[k].z;
    }
  }
  const float cx0 = c[0] * gx + c[1] * fx;
  const float cx1 = c[2] * gx + c[3] * fx;
  const float cx2 = c[4] * gx + c[5] * fx;
  const float cx3 = c[6] * gx + c[7] * fx;
  const float cy0 = cx0 * gy + cx1 * fy;
  const float cy1 = cx2 * gy + cx3 * fy;
  return cy0 * gz + cy1 * fz;
}

template <bool kBf16, int kC, class Row>
__device__ __forceinline__ VptRowOf<kBf16, kC> vpt_load_rows(
    const void* table, Row row) {
  if constexpr (kC == 2) {
    if constexpr (kBf16) {
      const uint4* p = static_cast<const uint4*>(table) + 2 * (int64_t)row;
      return {__ldg(p), __ldg(p + 1)};
    } else {
      const float4* p = static_cast<const float4*>(table) + 4 * (int64_t)row;
      return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
    }
  } else {
    return vpt_load_row<kBf16>(table, row);
  }
}

// the lerp chain of trilerp_chain over the 8 corners c[0..7]:
// vpt_lerp_row_fg's, kept apart so that the headline's instances keep
// their code
__device__ __forceinline__ float vpt_lerp8(const float c[8], float fx,
                                           float fy, float fz) {
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const float cx0 = c[0] * gx + c[1] * fx;
  const float cx1 = c[2] * gx + c[3] * fx;
  const float cx2 = c[4] * gx + c[5] * fx;
  const float cx3 = c[6] * gx + c[7] * fx;
  const float cy0 = cx0 * gy + cx1 * fy;
  const float cy1 = cx2 * gy + cx3 * fy;
  return cy0 * gz + cy1 * fz;
}

// (value, channel 1) of a row at its cell's fractions; channel 1 reads 0
// for one channel (volume_rg)
template <bool kBf16, int kC, class Row>
__device__ __forceinline__ float2 vpt_lerp_rg(const VptRowOf<kBf16, kC>& r,
                                              const VptCell<Row>& cell) {
  if constexpr (kC == 2) {
    float v[8], g[8];
    if constexpr (kBf16) {
      const uint32_t words[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                                 r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = __uint_as_float(words[k] << 16);
        g[k] = __uint_as_float(words[k] & 0xFFFF0000u);
      }
    } else {
      const float4 q[4] = {r.a, r.b, r.c, r.d};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = q[k].x; g[2 * k] = q[k].y;
        v[2 * k + 1] = q[k].z; g[2 * k + 1] = q[k].w;
      }
    }
    return make_float2(vpt_lerp8(v, cell.fx, cell.fy, cell.fz),
                       vpt_lerp8(g, cell.fx, cell.fy, cell.fz));
  } else {
    return make_float2(vpt_lerp_row<kBf16>(r, cell), 0.0f);
  }
}

// The color of (value, channel 1): the tf1d lookup of the value in the
// (tw, 4) row (in shared memory, or with kGlobal through the read-only
// cache) in lookup mode tf_mode, or for two channels the 2D lookup of the
// packed (th*tw, 16) TF table of the corner table's type.
template <bool kBf16, int kC, bool kGlobal = false>
__device__ __forceinline__ float4 vpt_color_rg(const float4* tf_row, int tw,
                                               int tf_mode,
                                               const void* tf_table, int th,
                                               float2 rg) {
  if constexpr (kC == 2) {
    return vpt_tf2d<kBf16>(tf_table, tw, th, rg.x, rg.y);
  } else {
    return vpt_tf1d_lookup<kGlobal>(tf_row, tw, rg.x, tf_mode);
  }
}

// The whole fetch and color at p, with a 64-bit row index unless Row says
// otherwise.
template <bool kBf16, int kC, bool kGlobal = false, class Row = int64_t>
__device__ __forceinline__ float4 vpt_fetch_color(
    const void* table, int d, int h, int w, int filter, float px, float py,
    float pz, const float4* tf_row, int tw, int tf_mode,
    const void* tf_table, int th) {
  const VptCell<Row> cell = vpt_cell_filtered<Row>(d, h, w, px, py, pz,
                                                   filter);
  return vpt_color_rg<kBf16, kC, kGlobal>(
      tf_row, tw, tf_mode, tf_table, th,
      vpt_lerp_rg<kBf16, kC>(vpt_load_rows<kBf16, kC>(table, cell.row),
                             cell));
}
