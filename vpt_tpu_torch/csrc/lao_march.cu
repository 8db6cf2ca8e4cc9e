// LAO march kernel (K10): one frame of the LAO renderer, one thread a pixel.
//
// Replaces the XLA lax.scan of vpt_tpu/renderers/lao.py:63-183 (generate:
// the march :97-172, the alpha > 1 normalisation and the misses :177-183),
// with Scene.raw_gradient and sample_transfer of vpt_tpu/renderers/
// base.py:134-152, 238-243.  It has no Pallas original; its corner fetch is
// the device functions of ray.cuh.
//
// Per pixel, over `slices` (64) slices while t < 1 and alpha <= 0.9: the
// value and the six-tap raw gradient at voxel 1/32 (7 corner-row reads),
// the AO taps along the normalised half-vector to the light (20 reads at
// the default step 0.05), one soft-shadow tap, the 2D bilinear TF lookup of
// (value, |grad|) from the packed (TH*TW, 16) TF table (float32 weights,
// never the tf_mxu rounding), two tints and the composite.
//
// Bound on the H100: a hit pixel's active slice reads 28 corner rows (7 +
// 20 + 1) of 16 bytes (bf16) from a table that the 50 MB L2 holds; its
// float32 operations (~7.2e9 a 512^2 headline frame, 0.107 ms at 67
// TFLOP/s) bound it on paper, but built with -fmad=false, with an IEEE
// division sequence for each of an AO tap's three divisions and a square
// root sequence for its norm, the floor that holds is the issue rate of
// its instructions: ~3,600 SASS an active slice times the warp-slices over
// 4 schedulers x 132 SMs a clock, ~0.6 ms a frame (PERF.md §6).
//
// Design: one thread a pixel on the 8 x 4 warp tiles of ray.cuh (a warp's
// rays read neighbouring rows and leave the loop at similar slices: 95% of
// a warp's lane-slices are busy on the headline, counts= shows it).  The
// ray, the random value rx, the AO direction and the shadow offset stay in
// registers; rx comes from an (H, W) tensor that the wrapper prepares once
// with the plain version's own function (no cosf/sinf here), as do rconst,
// the light and the AO taps' (t2, light_radius*t2, (1-t2)^2).  A slice
// computes each axis's clip, floor, fraction and row offset once for
// p - v, p and p + v (9 axis computations, not the 21 of seven separate
// cells), issues its seven reads before folding them, then the AO taps in
// groups of kGroup, each group's reads before its fold.  Rows are indexed
// with 32 bits where the table has fewer than 2^31 rows (the wrapper's
// choice), else with 64.  The packed TF table is read through the
// read-only cache.  The loop breaks once the pixel is inactive: t only
// grows and the state stops changing once alpha exceeds 0.9, so this is
// exact.  A miss writes (0, 0, 0, 1) at once.  A ray pass that lists the
// hits for a persistent grid whose lanes refill (Aila and Laine, HPG 2009)
// was built and measured slower on the float32 scene in four forms
// (PERF.md §6), so it is not here.
//
// Two-channel and filtered volumes run lao_ext_kernel, the same body (lao)
// with ray.cuh's ext fetch: each of a slice's 28 reads goes through the
// filter (a warp-uniform argument; the seven gradient cells keep their 9
// shared axis computations, cubic warping each axis coordinate once and
// nearest snapping the shared fractions) and reads channel 0 of a row of
// the scene's channels (corner-major, channels interleaved: 32 bytes in
// bf16, 64 in float32 for two channels).  With lao.Params.baked_gradient
// (a volume.with_lao_gradient volume) one two-channel row at p gives
// (value, |grad|) in place of the seven gradient reads; the AO and shadow
// taps stay.  Only the instances make_scene's rules reach are built.
//
// A HaloScene's frame (a rank's z slab) runs lao_halo_kernel (below): the
// same fold on the same device functions (lao_ray, lao_light, lao_half,
// lao_ao, lao_soft, lao_composite, lao_finish), split around an all-reduce
// of each chunk of 8 slices' tap values.
//
// Numerics follow renderers/lao.py (setup, march_slice, finish) operation
// by operation: built with -fmad=false, IEEE division and sqrt,
// NaN-propagating min/max, sums of three left to right.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

// What a frame takes of its scene, Params and resolution, filled once by the
// wrapper (kernels/lao_march.py, a ctypes Structure of this layout; fields
// are only appended, so that an older build reads the prefix it knows).
struct VptLaoArgs {
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  const void* tf_table;  // (TH*TW, 16) float32 or bfloat16 packed TF
  const float* mvp;      // 16 floats, row-major inverse MVP
  const float* rx;       // (height, width) per-pixel random value
  const float4* taps;    // (n_taps, 4): t2, light_radius*t2, weight, 0
  int table_bf16, tf_bf16;
  int d, h, w;
  int tw, th;            // the TF texture's width and height
  int width, height;     // the image
  int slices, n_taps, lao_samples;
  int lao_on, soft_on;
  float step, extinction, lao_weight, soft_weight, light_radius;
  float light_coefficient;
  float lx, ly, lz;      // the light, inverse MVP times (light, 1), no /w
  float rconst;
  int device;
  int rows64;            // 1: index corner rows with 64 bits
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, LAO's baked gradient) take besides; only they read it.
struct VptLaoExt : VptLaoArgs {
  int channels;          // 1 or 2: with filter 0, 1 channel and no baked
                         // gradient, no ext
  int filter;            // ray.cuh's VptFilter
  int baked;             // 1: channel 1 is |grad| (lao.Params.baked_gradient)
  int row0, full_height; // the launch's rows of the image: [row0,
                         // row0 + height) of full_height rows; every
                         // instance takes them as its int2 window argument
};

namespace {

// AO taps read ahead of their fold: groups of 1 to 10, and register caps
// for 6 or 8 blocks an SM (which spill), measured in turns at 512^2 on the
// headline and a float32 scene (bench_mcm_event.py --kernel lao, PERF.md
// §6), stay within about 10% of one another; 2 is kept
constexpr int kGroup = 2;
constexpr float kVoxel = 1.0f / 32.0f;
// float32(sqrt(3)), the divisor of the AO direction
constexpr float kSqrt3 = 1.7320508075688772f;

// sqrt(max(x*x + y*y + z*z, 1e-20)), the norm of lao.py's _norm
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(vpt_nmax(x * x + y * y + z * z, 1e-20f));
}

// One axis of the seven gradient and value cells: for p - v, p and p + v
// the clip, floor, fraction f, 1 - f and the row offset index * stride
// (vpt_cell's operations on the same floats).  kC is 0 for the headline's
// linear single-channel fetch, else an ext instance's channels, whose axes
// take the filter as vpt_cell_filtered does: cubic warps each of the three
// coordinates once (not once a cell), nearest snaps the shared fractions.
template <class Row>
struct LaoAxis {
  Row off[3];
  float f[3], g[3];
};

template <class Row, int kC>
__device__ __forceinline__ LaoAxis<Row> lao_axis(float p, int n, Row stride,
                                                 int filter) {
  float v[3] = {p - kVoxel, p, p + kVoxel};
  if constexpr (kC != 0) {
    if (filter == kVptCubic) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = vpt_cubic_axis(v[j], n);
    }
  }
  LaoAxis<Row> out;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float u = vpt_clip(v[j] * (float)n - 0.5f, 0.0f, (float)(n - 1));
    const float i = floorf(u);
    out.f[j] = u - i;
    if constexpr (kC != 0) {
      if (filter == kVptNearest) out.f[j] = out.f[j] >= 0.5f ? 1.0f : 0.0f;
    }
    out.g[j] = 1.0f - out.f[j];
    out.off[j] = (Row)vpt_index(i) * stride;
  }
  return out;
}

// The cell of a tap at p: the headline's linear cell, or the filtered one.
template <class Row, int kC>
__device__ __forceinline__ VptCell<Row> lao_cell(const VptLaoArgs& a,
                                                 int filter, float px,
                                                 float py, float pz) {
  if constexpr (kC == 0) {
    return vpt_cell<Row>(a.d, a.h, a.w, px, py, pz);
  } else {
    return vpt_cell_filtered<Row>(a.d, a.h, a.w, px, py, pz, filter);
  }
}

// Channel 0 at a tap's cell.
template <bool kBf16, int kC, class Row>
__device__ __forceinline__ float lao_tap(const VptRowOf<kBf16, kC>& r,
                                         const VptCell<Row>& c) {
  return vpt_lerp_row_fg<kBf16>(r, c.fx, 1.0f - c.fx, c.fy, 1.0f - c.fy,
                                c.fz, 1.0f - c.fz);
}

// A pixel's ray (_march.rays, the cube alone: LAO clamps to no box):
// unproject, the slab test clamped at 0; the marched segment runs from start
// to start + seg.
struct LaoRay {
  float start[3], seg[3];
  bool miss;
};

__device__ __forceinline__ LaoRay lao_ray(const VptLaoArgs& a, int2 window,
                                          int x, int y) {
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = __ldg(a.mvp + k);
  const float ndcx = vpt_pixel_ndc(x, a.width);
  const float ndcy = vpt_pixel_ndc(window.x + y, window.y);
  float from[3], to[3], dir[3];
  vpt_unproject(m, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  const float tb0 = vpt_nmax(tnear, 0.0f), tb1 = vpt_nmax(tfar, 0.0f);
  LaoRay r;
  r.miss = tb0 >= tb1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.start[k] = from[k] + tb0 * dir[k];
    r.seg[k] = (from[k] + tb1 * dir[k]) - r.start[k];
  }
  return r;
}

// What the pixel's random value rx fixes (lao.setup): the first t, the AO
// direction's scale rdir, the shadow tap's offset and its length.
struct LaoLight {
  float t0, rdir, soff[3], slen;
};

__device__ __forceinline__ LaoLight lao_light(const VptLaoArgs& a, float rx) {
  LaoLight l;
  l.t0 = vpt_clip(rx * a.step * 1.5f, 0.0f, 1.0f);
  const float q = 2.0f * rx - 1.0f;
  const float sign = q > 0.0f ? 1.0f : (q < 0.0f ? -1.0f : q);
  l.rdir = sign * (rx / kSqrt3);
  float sdir[3] = {-1.0f + a.lx * rx, a.ly + rx * a.lz,
                   -1.0f + 2.0f * a.rconst};
  const float snorm = norm3(sdir[0], sdir[1], sdir[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sdir[k] = sdir[k] / snorm * rx;
    l.soff[k] = sdir[k] * a.light_radius;
  }
  l.slen = sqrtf(sdir[0] * sdir[0] + sdir[1] * sdir[1] + sdir[2] * sdir[2]);
  return l;
}

// Whether a pixel's slice at t changes it (lao.slice_active): t < 1 and
// alpha at most 0.9.  Once false it stays false: t only grows and the
// state stops changing.
__device__ __forceinline__ bool lao_live(float t, const float4& acc) {
  return t < 1.0f && acc.w <= 0.9f;
}

// The position of the AO tap (t2, light_radius*t2, weight) of a slice at
// p: along the normalised half-vector to the light.
__device__ __forceinline__ void lao_half(const VptLaoArgs& a, float rdir,
                                         const float p[3], float4 tap,
                                         float half[3]) {
  const float light[3] = {a.lx, a.ly, a.lz};
#pragma unroll
  for (int k = 0; k < 3; ++k) half[k] = light[k] + rdir * tap.y - p[k];
  const float hn = norm3(half[0], half[1], half[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) half[k] = p[k] + half[k] / hn * tap.x;
}

// |grad| of the raw gradient's three differences
__device__ __forceinline__ float lao_grad_mag(float gx, float gy, float gz) {
  return sqrtf(gx * gx + gy * gy + gz * gz);
}

// The AO term of the taps' weighted sum inner: lao_samples folds of the
// carried accumulator.
__device__ __forceinline__ float lao_ao(const VptLaoArgs& a, float inner) {
  float carried = 0.0f, total = 0.0f;
  for (int n = 0; n < a.lao_samples; ++n) {
    carried = vpt_clip((carried + inner) / a.light_coefficient, 0.0f, 1.0f);
    total = total + carried;
  }
  return total / (float)a.lao_samples;
}

// The soft-shadow term of the shadow tap's value vs.
__device__ __forceinline__ float lao_soft(float vs, float slen) {
  float contrib = vs * (vs * 0.2f) * slen;
  contrib = vpt_clip(contrib * 20.0f, 0.0f, 1.0f);
  return vpt_clip((-0.2f + 1.2f * contrib) / 1.3f, 0.0f, 1.0f);
}

// The slice's colour composited into acc: the 2D TF of (value, |grad|),
// the AO and the shadow tints.
template <bool kTfBf16>
__device__ __forceinline__ void lao_composite(const VptLaoArgs& a,
                                              float4& acc, float value,
                                              float grad_mag, float lao,
                                              float soft) {
  float4 c = vpt_tf2d<kTfBf16>(a.tf_table, a.tw, a.th, value, grad_mag);
  const float w1 = lao * a.lao_weight;
  c.x = c.x * (1.0f - w1) + c.x * 0.15f * w1;
  c.y = c.y * (1.0f - w1) + c.y * 0.18f * w1;
  c.z = c.z * (1.0f - w1) + c.z * 0.32f * w1;
  const float w2 = soft * a.soft_weight;
  c.x = c.x * (1.0f - w2) + c.x * 0.15f * w2;
  c.y = c.y * (1.0f - w2) + c.y * 0.18f * w2;
  c.z = c.z * (1.0f - w2) + c.z * 0.22f * w2;

  const float keep = 1.0f - acc.w;
  acc.x = acc.x + keep * c.x * value;
  acc.y = acc.y + keep * c.y * value;
  acc.z = acc.z + keep * c.z * value;
  acc.w = acc.w + keep * value * a.extinction / 100.0f;
}

// The frame's pixel from the march's accumulator (lao.finish): the alpha >
// 1 normalisation, alpha 1.  A miss, whose accumulator stays 0, gives (0,
// 0, 0, 1).
__device__ __forceinline__ float4 lao_finish(float4 acc) {
  if (acc.w > 1.0f) {
    const float den = vpt_nmax(acc.w, 1e-6f);
    acc.x = acc.x / den;
    acc.y = acc.y / den;
    acc.z = acc.z / den;
  }
  return make_float4(acc.x, acc.y, acc.z, 1.0f);
}

// One frame; with kCount, counts gets the pixels' active slices and the
// slices their warps step through (the leader of each group of lanes that
// runs a slice together counts one).  kC as in lao_axis; with kBaked (kC =
// 2) one fetch of the two-channel row at p gives (value, |grad|) in place
// of the seven-cell gradient.
template <bool kBf16, bool kTfBf16, class Row, bool kCount, int kC,
          bool kBaked>
__device__ __forceinline__ void lao_pixel(const VptLaoArgs& a, int filter,
                                    int2 window,
                                    float4* __restrict__ state,
                                    unsigned long long* __restrict__ counts) {
  static_assert(!kBaked || kC == 2, "the baked gradient is channel 1");
  using RowT = VptRowOf<kBf16, kC>;
  int x, y;
  if (!vpt_tile_pixel(a.width, a.height, &x, &y)) return;
  const int i = y * a.width + x;

  const LaoRay r = lao_ray(a, window, x, y);
  if (r.miss) {
    state[i] = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    return;
  }
  const LaoLight l = lao_light(a, __ldg(a.rx + i));

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int s = 0;
  for (; s < a.slices; ++s) {
    const float t = l.t0 + (float)s * a.step;
    if (!lao_live(t, acc)) break;
    if constexpr (kCount) {
      const unsigned group = __activemask();
      if ((threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(counts + 1, 1ull);
    }
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = r.start[k] + t * r.seg[k];

    float value, grad_mag;
    if constexpr (kBaked) {
      // (value, baked |grad|) from one two-channel row at p
      const VptCell<Row> cell = lao_cell<Row, kC>(a, filter, p[0], p[1],
                                                  p[2]);
      const float2 rg = vpt_lerp_rg<kBf16, 2>(
          vpt_load_rows<kBf16, 2>(a.table, cell.row), cell);
      value = rg.x;
      grad_mag = rg.y;
    } else {
      // the raw gradient (p - e_k vs minus p + e_k vs) and the value: the
      // cells ((iz h + iy) w + ix) from the axes' shared offsets
      const LaoAxis<Row> ax = lao_axis<Row, kC>(p[0], a.w, (Row)1, filter);
      const LaoAxis<Row> ay = lao_axis<Row, kC>(p[1], a.h, (Row)a.w,
                                                filter);
      const LaoAxis<Row> az = lao_axis<Row, kC>(p[2], a.d, (Row)a.h * a.w,
                                                filter);
      const Row zy = az.off[1] + ay.off[1];
      const Row rows[7] = {zy + ax.off[0], zy + ax.off[2],
                           az.off[1] + ay.off[0] + ax.off[1],
                           az.off[1] + ay.off[2] + ax.off[1],
                           az.off[0] + ay.off[1] + ax.off[1],
                           az.off[2] + ay.off[1] + ax.off[1],
                           zy + ax.off[1]};
      RowT row[7];
#pragma unroll
      for (int j = 0; j < 7; ++j)
        row[j] = vpt_load_rows<kBf16, kC>(a.table, rows[j]);
      // cell j's coordinate on each axis: 0 (p - v), 1 (p) or 2 (p + v)
      grad_mag = lao_grad_mag(
          vpt_lerp_row_fg<kBf16>(row[0], ax.f[0], ax.g[0], ay.f[1], ay.g[1],
                                 az.f[1], az.g[1])
              - vpt_lerp_row_fg<kBf16>(row[1], ax.f[2], ax.g[2], ay.f[1],
                                       ay.g[1], az.f[1], az.g[1]),
          vpt_lerp_row_fg<kBf16>(row[2], ax.f[1], ax.g[1], ay.f[0], ay.g[0],
                                 az.f[1], az.g[1])
              - vpt_lerp_row_fg<kBf16>(row[3], ax.f[1], ax.g[1], ay.f[2],
                                       ay.g[2], az.f[1], az.g[1]),
          vpt_lerp_row_fg<kBf16>(row[4], ax.f[1], ax.g[1], ay.f[1], ay.g[1],
                                 az.f[0], az.g[0])
              - vpt_lerp_row_fg<kBf16>(row[5], ax.f[1], ax.g[1], ay.f[1],
                                       ay.g[1], az.f[2], az.g[2]));
      value = vpt_lerp_row_fg<kBf16>(row[6], ax.f[1], ax.g[1], ay.f[1],
                                     ay.g[1], az.f[1], az.g[1]);
    }

    // local ambient occlusion: the taps' reads a group at a time, each
    // group folded in order
    float lao = 0.0f;
    if (a.lao_on) {
      float inner = 0.0f;
      for (int j0 = 0; j0 < a.n_taps; j0 += kGroup) {
        VptCell<Row> tc[kGroup];
        RowT tr[kGroup];
        float tw[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j >= a.n_taps) break;
          const float4 tap = __ldg(a.taps + j0 + j);
          float half[3];
          lao_half(a, l.rdir, p, tap, half);
          tc[j] = lao_cell<Row, kC>(a, filter, half[0], half[1], half[2]);
          tr[j] = vpt_load_rows<kBf16, kC>(a.table, tc[j].row);
          tw[j] = tap.z;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j >= a.n_taps) break;
          inner = inner + lao_tap<kBf16, kC>(tr[j], tc[j]) * tw[j];
        }
      }
      lao = lao_ao(a, inner);
    }

    // the soft shadow
    float soft = 0.0f;
    if (a.soft_on) {
      const VptCell<Row> sc = lao_cell<Row, kC>(
          a, filter, p[0] + l.soff[0], p[1] + l.soff[1], p[2] + l.soff[2]);
      soft = lao_soft(lao_tap<kBf16, kC>(
          vpt_load_rows<kBf16, kC>(a.table, sc.row), sc), l.slen);
    }
    lao_composite<kTfBf16>(a, acc, value, grad_mag, lao, soft);
  }
  if constexpr (kCount) atomicAdd(counts, (unsigned long long)s);
  state[i] = lao_finish(acc);
}

template <bool kBf16, bool kTfBf16, class Row, bool kCount>
__global__ void __launch_bounds__(kVptTileThreads)
lao_kernel(const VptLaoArgs a, int2 window, float4* __restrict__ state,
           unsigned long long* __restrict__ counts) {
  lao_pixel<kBf16, kTfBf16, Row, kCount, 0, false>(a, 0, window, state,
                                                   counts);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows; 2: a
// two-channel volume, whose packed TF has the rows' type), the filter a
// warp-uniform argument, rows indexed with 32 bits (the wrapper raises for
// larger tables).
template <bool kBf16, bool kCount, int kC, bool kBaked>
__global__ void __launch_bounds__(kVptTileThreads)
lao_ext_kernel(const VptLaoExt a, int2 window, float4* __restrict__ state,
               unsigned long long* __restrict__ counts) {
  lao_pixel<kBf16, kBf16, int, kCount, kC, kBaked>(a, a.filter, window,
                                                   state, counts);
}

// The halo instance (parallel/halo.py, a HaloScene frame): the volume is z
// slabs over the ranks of a group, each rank holding its slab's corner rows,
// and a sample is the sum over the ranks of their masked slab-local values
// (vpt_tpu/parallel/halo.py:199-272: sample_value, raw_gradient and
// sample_volume_rg, one psum each), an all-reduce between the fetch and
// everything that is not linear in the value.  So a rank sums what is
// linear in its values before the all-reduce, in K10's operations: a
// pixel-slice's lao_halo_values values are the raw gradient's three
// differences (p - e_k/32 minus p + e_k/32) and the value at p (or, baked,
// the (value, |grad|) pair at p), the AO taps' weighted sum and the shadow
// tap, each of channel 0 (a two-channel volume that is not baked sums
// channel 0 only).  A tap's value comes from its cell's one owner and is 0
// on every other rank, so the all-reduced differences, value and shadow
// tap are exactly the plain twin's (x + 0 and a + (-b) round as x and a -
// b); the AO sum is the owners' partial sums added, which rounds as the
// plain twin's tap-by-tap sum only where one rank owns every tap (within
// K10's bound of it otherwise).  A frame of S slices is C = ceil(S /
// kHaloChunk) chunks; launch e = 0 .. C folds chunk e - 1's summed values
// in K10's order (lao_fold_values: |grad|, the AO fold, the soft shadow,
// the 2D TF, the tints and the composite) while the pixel is live, then
// writes chunk e's masked values (lao_slab_fetch), the wrapper
// all-reducing the values between launches; the last launch writes the
// frame (lao_finish).  Between launches the state holds the pixel's
// accumulator (LAO's frame replaces the state), and its ray, rx and tap
// directions come again from the pixel index.  A pixel that is not live at
// a chunk's start reads nothing that chunk and its slots hold zeros: every
// rank holds the same accumulator, so every rank decides alike.  The value
// buffer starts at zero and stays so outside the chunks of live pixels: a
// launch zeroes the slots of a pixel that was live at the previous chunk's
// start and is not now (the last launch those of a pixel live at the last
// chunk's start), so a pixel that stays dark writes nothing.  So on one
// slab a frame equals K10's bit for bit: only the owner's value is
// non-zero, and the fetch and the fold run K10's operations on the same
// values.  A HaloScene has no filter; its volume has one channel (kC = 0)
// or two (kC = 2), its slabs contiguous or interleaved, the fetch masked
// or not (slab.cuh).
//
// Bound on the H100: K10's, plus each fetched pixel-slice's values written
// and read back (48 bytes at 6 values) and each pixel's accumulator across
// each all-reduce (PERF.md §6).  As K10's, its floor is the issue rate of
// its instructions.  Design: one kernel a launch that folds and fetches,
// at K10's register budget; the fetch sums the linear terms, so a
// pixel-slice's values are 6 and not the 28 taps (the 512^2 headline's
// chunk of values 50 MB, not 235, which the 50 MB L2 about holds); a tap's
// slab plane and owner come from the slab's plane map (slab.cuh's
// vpt_slab_plane, staged in shared memory at the block's start: one load a
// tap, no integer division); rows are indexed with 32 bits where the
// slab's table has fewer than 2^31 rows (the wrapper's choice, K10's
// rule).  Measured in turns and not kept (PERF.md §6): a fold kernel and a
// lean fetch kernel a chunk, 6 or 8 blocks an SM, and the seven gradient
// rows or groups of AO taps read before their lerps (which spill).
constexpr int kHaloChunk = 8;
// resident blocks an SM that the register allocation must allow: K10's 7
// (72 registers)
constexpr int kHaloMinBlocks = 7;

// The halo instance's prepared arguments: VptLaoExt and the slab's plane
// map (appended; the other instances read the VptLaoExt prefix).
struct VptLaoHalo : VptLaoExt {
  const int2* planes;  // (d) {slab-local plane, owner} of each global plane
};

// the values a pixel-slice of the halo instance sums: the gradient's three
// differences and the value (or the baked pair), the AO taps' weighted sum
// and the shadow tap
__host__ __device__ __forceinline__ int lao_halo_values(const VptLaoExt& a) {
  return (a.baked ? 2 : 4) + (a.lao_on ? 1 : 0) + (a.soft_on ? 1 : 0);
}

// Channel 0 of the tap at (px, py, pz) from this rank's slab rows, 0 where
// another rank owns its cell: lao_tap's lerp of the slab cell's row.
template <bool kBf16, int kC, class Row>
__device__ __forceinline__ float lao_slab_tap(const VptLaoArgs& a,
                                              VptSlab slab,
                                              const int2* planes, float px,
                                              float py, float pz) {
  bool local;
  const VptCell<Row> c = vpt_slab_plane_cell<Row>(a.d, a.h, a.w, slab,
                                                  planes, px, py, pz, &local);
  if (!local) return 0.0f;
  return lao_tap<kBf16, kC>(vpt_load_rows<kBf16, kC>(a.table, c.row), c);
}

// A live slice's masked values at p into out[m * n], m = 0 ..
// lao_halo_values - 1: the gradient's differences and the value from the
// shared axes' cells (each z coordinate's slab plane and owner from the
// plane map), then the AO taps' weighted sum and the shadow tap, each in
// K10's operations.
template <bool kBf16, int kC, bool kBaked, class Row>
__device__ __forceinline__ void lao_slab_fetch(const VptLaoArgs& a,
                                               VptSlab slab,
                                               const int2* planes,
                                               const LaoLight& l,
                                               const float p[3],
                                               float* __restrict__ out,
                                               int n) {
  int m;
  if constexpr (kBaked) {
    bool local;
    const VptCell<Row> c = vpt_slab_plane_cell<Row>(
        a.d, a.h, a.w, slab, planes, p[0], p[1], p[2], &local);
    float2 rg = make_float2(0.0f, 0.0f);
    if (local) rg = vpt_slab_value<kBf16, 2, Row>(a.table, c);
    out[0] = rg.x;
    out[n] = rg.y;
    m = 2;
  } else {
    const LaoAxis<Row> ax = lao_axis<Row, kC>(p[0], a.w, (Row)1, 0);
    const LaoAxis<Row> ay = lao_axis<Row, kC>(p[1], a.h, (Row)a.w, 0);
    // the z axis's indices (stride 1), placed in the slab below
    const LaoAxis<Row> az = lao_axis<Row, kC>(p[2], a.d, (Row)1, 0);
    Row zoff[3];
    bool local[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      zoff[j] = (Row)vpt_slab_plane(planes, slab, (int)az.off[j], &local[j])
                * ((Row)a.h * a.w);
    }
    // the cell at axis coordinates (xj, yj, zj) (0: p - v, 1: p, 2: p +
    // v), 0 where another rank owns it
    auto cell = [&](int xj, int yj, int zj) {
      if (!local[zj]) return 0.0f;
      return vpt_lerp_row_fg<kBf16>(
          vpt_load_rows<kBf16, kC>(a.table,
                                   zoff[zj] + ay.off[yj] + ax.off[xj]),
          ax.f[xj], ax.g[xj], ay.f[yj], ay.g[yj], az.f[zj], az.g[zj]);
    };
    // K10's raw gradient (x - v minus x + v, y, z) and the value at p
    out[0] = cell(0, 1, 1) - cell(2, 1, 1);
    out[n] = cell(1, 0, 1) - cell(1, 2, 1);
    out[2 * n] = cell(1, 1, 0) - cell(1, 1, 2);
    out[3 * n] = cell(1, 1, 1);
    m = 4;
  }
  if (a.lao_on) {
    // K10's weighted sum of the taps, in order (one tap an iteration:
    // bench_mcm_event.py counts a slice's SASS so)
    float inner = 0.0f;
#pragma unroll 1
    for (int j = 0; j < a.n_taps; ++j) {
      const float4 tap = __ldg(a.taps + j);
      float half[3];
      lao_half(a, l.rdir, p, tap, half);
      inner = inner + lao_slab_tap<kBf16, kC, Row>(a, slab, planes, half[0],
                                                   half[1], half[2])
                          * tap.z;
    }
    out[m * n] = inner;
    ++m;
  }
  if (a.soft_on) {
    out[m * n] = lao_slab_tap<kBf16, kC, Row>(
        a, slab, planes, p[0] + l.soff[0], p[1] + l.soff[1],
        p[2] + l.soff[2]);
  }
}

// One slice folded into acc from its summed values v[m * n] (the layout of
// lao_slab_fetch), K10's operations in K10's order.
template <bool kTfBf16, bool kBaked>
__device__ __forceinline__ void lao_fold_values(const VptLaoArgs& a,
                                                const LaoLight& l,
                                                const float* __restrict__ v,
                                                int n, float4& acc) {
  float value, grad_mag;
  int m;
  if constexpr (kBaked) {
    value = v[0];
    grad_mag = v[n];
    m = 2;
  } else {
    grad_mag = lao_grad_mag(v[0], v[n], v[2 * n]);
    value = v[3 * n];
    m = 4;
  }
  float lao = 0.0f;
  if (a.lao_on) lao = lao_ao(a, v[m++ * n]);
  const float soft = a.soft_on ? lao_soft(v[m * n], l.slen) : 0.0f;
  lao_composite<kTfBf16>(a, acc, value, grad_mag, lao, soft);
}

template <bool kBf16, bool kTfBf16, int kC, bool kBaked, class Row>
__global__ void __launch_bounds__(kVptTileThreads, kHaloMinBlocks)
lao_halo_kernel(const VptLaoHalo a, const VptSlab slab,
                float* __restrict__ value, float4* __restrict__ state,
                int chunk) {
  extern __shared__ int2 s_planes[];
  vpt_stage_planes(s_planes, a.planes, a.d);
  __syncthreads();
  int x, y;
  if (!vpt_tile_pixel(a.width, a.height, &x, &y)) return;
  const int i = y * a.width + x;
  const int n = a.width * a.height;
  const int nv = lao_halo_values(a);
  const LaoRay r = lao_ray(a, make_int2(a.row0, a.full_height), x, y);
  const int slices = r.miss ? 0 : a.slices;
  const LaoLight l = lao_light(a, __ldg(a.rx + i));
  const int chunks = (a.slices + kHaloChunk - 1) / kHaloChunk;
  float4 acc = chunk == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : state[i];
  // live at the previous chunk's start: its slots hold that chunk's values
  bool was_live = false;
  if (chunk > 0) {
    const int j0 = (chunk - 1) * kHaloChunk;
    was_live = j0 < slices && lao_live(l.t0 + (float)j0 * a.step, acc);
    for (int k = 0; was_live && k < kHaloChunk && j0 + k < slices; ++k) {
      if (!lao_live(l.t0 + (float)(j0 + k) * a.step, acc)) break;
      lao_fold_values<kTfBf16, kBaked>(a, l, value + k * nv * n + i, n,
                                       acc);
    }
  }
  const int j0 = chunk * kHaloChunk;
  const bool live = chunk < chunks && j0 < slices
                    && lao_live(l.t0 + (float)j0 * a.step, acc);
  if (live || was_live) {
    for (int k = 0; k < kHaloChunk; ++k) {
      float* out = value + k * nv * n + i;
      const int s = j0 + k;
      const float t = l.t0 + (float)s * a.step;
      if (live && s < slices && t < 1.0f) {
        float p[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) p[q] = r.start[q] + t * r.seg[q];
        lao_slab_fetch<kBf16, kC, kBaked, Row>(a, slab, s_planes, l, p, out,
                                               n);
      } else {
        for (int m = 0; m < nv; ++m) out[m * n] = 0.0f;
      }
    }
  }
  state[i] = chunk < chunks ? acc : lao_finish(acc);
}

// The instantiation for the table types, the row index and counting.
using Kernel = void (*)(const VptLaoArgs, int2, float4*,
                        unsigned long long*);
using KernelExt = void (*)(const VptLaoExt, int2, float4*,
                           unsigned long long*);

template <class Row, bool kCount>
Kernel pick_row(int table_bf16, int tf_bf16) {
  if (table_bf16) {
    return tf_bf16 ? lao_kernel<true, true, Row, kCount>
                   : lao_kernel<true, false, Row, kCount>;
  }
  return tf_bf16 ? lao_kernel<false, true, Row, kCount>
                 : lao_kernel<false, false, Row, kCount>;
}

Kernel pick(int table_bf16, int tf_bf16, int rows64, bool count) {
  if (count) {
    return rows64 ? pick_row<int64_t, true>(table_bf16, tf_bf16)
                  : pick_row<int, true>(table_bf16, tf_bf16);
  }
  return rows64 ? pick_row<int64_t, false>(table_bf16, tf_bf16)
                : pick_row<int, false>(table_bf16, tf_bf16);
}

// The ext instance: one channel (a filtered volume) of float32 rows and a
// float32 TF, or two channels, baked or not, whose TF has the rows' type;
// the instances make_scene's rules can reach, null for anything else.
template <bool kCount>
KernelExt pick_ext_count(int channels, int table_bf16, int tf_bf16,
                         int baked) {
  if (channels == 2 && table_bf16 == tf_bf16) {
    if (table_bf16)
      return baked ? lao_ext_kernel<true, kCount, 2, true>
                   : lao_ext_kernel<true, kCount, 2, false>;
    return baked ? lao_ext_kernel<false, kCount, 2, true>
                 : lao_ext_kernel<false, kCount, 2, false>;
  }
  if (channels == 1 && !table_bf16 && !tf_bf16 && !baked)
    return lao_ext_kernel<false, kCount, 1, false>;
  return nullptr;
}

KernelExt pick_ext(int channels, int table_bf16, int tf_bf16, int baked,
                   bool count) {
  return count ? pick_ext_count<true>(channels, table_bf16, tf_bf16, baked)
               : pick_ext_count<false>(channels, table_bf16, tf_bf16, baked);
}

// The halo instance for a (table, TF, channels, baked, row) type: one
// channel of either table type and TF type, or two channels (baked or
// not) whose TF has the rows' type; null for anything else.
template <class Row>
const void* pick_halo_row(int channels, int table_bf16, int tf_bf16,
                          int baked) {
  if (channels == 2 && table_bf16 == tf_bf16) {
    if (table_bf16)
      return baked ? (const void*)lao_halo_kernel<true, true, 2, true, Row>
                   : (const void*)lao_halo_kernel<true, true, 2, false, Row>;
    return baked ? (const void*)lao_halo_kernel<false, false, 2, true, Row>
                 : (const void*)lao_halo_kernel<false, false, 2, false, Row>;
  }
  if (channels != 1 || baked) return nullptr;
  if (table_bf16)
    return tf_bf16 ? (const void*)lao_halo_kernel<true, true, 0, false, Row>
                   : (const void*)lao_halo_kernel<true, false, 0, false, Row>;
  return tf_bf16 ? (const void*)lao_halo_kernel<false, true, 0, false, Row>
                 : (const void*)lao_halo_kernel<false, false, 0, false, Row>;
}

const void* pick_halo(int channels, int table_bf16, int tf_bf16, int baked,
                      int rows64) {
  return rows64 ? pick_halo_row<int64_t>(channels, table_bf16, tf_bf16, baked)
                : pick_halo_row<int>(channels, table_bf16, tf_bf16, baked);
}

// The launch shape of a kernel on device: vpt_lao_info's values, with last
// the AO taps read ahead (K10) or the slices of a fetch (the halo
// instance).
cudaError_t info(const void* kernel, int last, int device, int* out) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kVptTileThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int values[] = {kVptTileThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        kVptTileW, kVptTileH, kVptWarpW, last};
  for (int k = 0; k < 10; ++k) out[k] = values[k];
  return cudaSuccess;
}

// whether a launch runs an ext instance
bool is_ext(const VptLaoExt& a) {
  return a.channels != 1 || a.filter != 0 || a.baked != 0;
}

int launch(const void* prepared, void* state, void* counts, void* stream) {
  const VptLaoExt& a = *static_cast<const VptLaoExt*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return 0;
  if (a.row0 < 0 || a.full_height < a.row0 + a.height)
    return (int)cudaErrorInvalidValue;
  const int2 window = make_int2(a.row0, a.full_height);
  const unsigned blocks = (unsigned)vpt_tile_blocks(a.width, a.height);
  if (is_ext(a)) {
    const KernelExt kernel = pick_ext(a.channels, a.table_bf16, a.tf_bf16,
                                      a.baked, counts != nullptr);
    if (kernel == nullptr || a.rows64 || a.filter < 0 || a.filter > 2)
      return (int)cudaErrorInvalidValue;
    kernel<<<blocks, kVptTileThreads, 0, (cudaStream_t)stream>>>(
        a, window, static_cast<float4*>(state),
        static_cast<unsigned long long*>(counts));
    return (int)cudaGetLastError();
  }
  // the headline's instances take the VptLaoArgs prefix, as before the ext
  const VptLaoArgs& base = a;
  const Kernel kernel = pick(a.table_bf16, a.tf_bf16, a.rows64,
                             counts != nullptr);
  kernel<<<blocks, kVptTileThreads, 0, (cudaStream_t)stream>>>(
      base, window, static_cast<float4*>(state),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

}  // namespace

// One frame: prepared is the VptLaoExt of the scene, Params and
// resolution; state the (height, width, 4) frame it writes.
extern "C" int vpt_lao_launch(const void* prepared, void* state,
                              void* stream) {
  return launch(prepared, state, nullptr, stream);
}

// One frame that also adds to counts (2 int64) its pixels' active slices
// and the slices their warps step through.
extern "C" int vpt_lao_count(const void* prepared, void* state,
                             void* counts, void* stream) {
  return launch(prepared, state, counts, stream);
}

// The launch shape for `flags` (1 a corner table of bf16 rows, else
// float32; 2 the ext instance of one channel, 4 of two channels, 8 baked),
// a packed TF table of bf16 (or float32) and 64-bit (or 32-bit) row indices
// on `device`: out = threads a block, resident blocks an SM, SMs, registers
// a thread, local (spilled) bytes a thread, static shared bytes a block,
// the block's tile width and height, the warp's tile width in pixels and
// the AO taps read ahead of their fold.  Launches nothing.
extern "C" int vpt_lao_info(int flags, int tf_bf16, int rows64, int device,
                            int* out) {
  VptDeviceGuard guard(device);
  const int bf16 = flags & 1;
  const void* kernel =
      (flags & 14) ? (rows64 ? nullptr
                             : (const void*)pick_ext(
                                   (flags & 4) ? 2 : 1, bf16, tf_bf16,
                                   (flags & 8) ? 1 : 0, false))
                   : (const void*)pick(bf16, tf_bf16, rows64, false);
  return (int)info(kernel, kGroup, device, out);
}

// Call e of the halo instance (see lao_halo_kernel), one launch: prepared
// is the VptLaoHalo of the HaloScene, Params and resolution (table: the
// rank's slab rows, (slab planes * H * W, 8 * channels); d, h, w the whole
// volume's; no filter; rows64: index the slab rows with 64 bits; planes
// the slab's (d) plane map); the slab: its index of num_slabs, the thin
// slabs a rank (interleave) and whether the fetch is masked; value the
// (kHaloChunk, lao_halo_values, width * height) values between the calls,
// zero before a frame's first; state the (height, width, 4) frame, which
// holds the accumulator between the calls; chunk e of 0 .. ceil(slices /
// kHaloChunk), the last writing the frame.
extern "C" int vpt_lao_halo_launch(const void* prepared, int slab_index,
                                   int num_slabs, int interleave, int masked,
                                   void* value, void* state, int chunk,
                                   void* stream) {
  const VptLaoHalo& a = *static_cast<const VptLaoHalo*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return 0;
  const int chunks = (a.slices + kHaloChunk - 1) / kHaloChunk;
  if (a.filter != 0 || a.row0 < 0 || a.full_height < a.row0 + a.height
      || chunk < 0 || chunk > chunks || num_slabs < 1 || interleave < 1
      || slab_index < 0 || slab_index >= num_slabs
      || a.d % (num_slabs * interleave) != 0 || a.planes == nullptr
      || a.d > kVptMaxPlanes)
    return (int)cudaErrorInvalidValue;
  const void* kernel = pick_halo(a.channels, a.table_bf16, a.tf_bf16,
                                 a.baked, a.rows64);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  VptSlab slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
  float* values = static_cast<float*>(value);
  float4* frame = static_cast<float4*>(state);
  void* params[] = {(void*)&a, &slab, &values, &frame, &chunk};
  return (int)cudaLaunchKernel(
      kernel, dim3((unsigned)vpt_tile_blocks(a.width, a.height)),
      dim3(kVptTileThreads), params, (size_t)a.d * sizeof(int2),
      (cudaStream_t)stream);
}

// The launch shape of the halo instance for `flags` (1 a slab table of
// bf16 rows, else float32; 4 two channels, 8 baked, 16 64-bit rows) and a
// packed TF table of bf16 (or float32) on `device`: vpt_lao_info's values
// without the plane map's d * 8 bytes of shared memory a block, the last
// the slices of a fetch (kHaloChunk).  Launches nothing.
extern "C" int vpt_lao_halo_info(int flags, int tf_bf16, int device,
                                 int* out) {
  VptDeviceGuard guard(device);
  return (int)info(
      pick_halo((flags & 4) ? 2 : 1, flags & 1, tf_bf16, (flags & 8) ? 1 : 0,
                (flags & 16) ? 1 : 0),
      kHaloChunk, device, out);
}
