// Per-pixel ray pieces shared by the kernels that run one thread a pixel:
// the MCM event kernel (mcm_event.cu), the march kernel (march.cu), the ISO
// shade kernel (iso_shade.cu) and the MCS delta-tracking kernel
// (mcs_frame.cu), the equirect environment lookup of the MC kernels, and
// the pixel tiles of the frame kernels.
//
// Each function runs the float32 operations of its plain PyTorch version
// (vpt_tpu_torch/rng.py, sampling.py) in their order; the kernels are built
// with -fmad=false, so no product-sum contracts into one rounding.
#pragma once

#include <cstdint>
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

// sampling.pixel_ndc: (i + 0.5) / n * 2 - 1, the IEEE quotient
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
