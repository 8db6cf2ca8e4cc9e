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
// Numerics follow renderers/lao.py (setup, march_slice, finish) operation
// by operation: built with -fmad=false, IEEE division and sqrt,
// NaN-propagating min/max, sums of three left to right.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"

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
// (vpt_cell's operations on the same floats).
template <class Row>
struct LaoAxis {
  Row off[3];
  float f[3], g[3];
};

template <class Row>
__device__ __forceinline__ LaoAxis<Row> lao_axis(float p, int n,
                                                 Row stride) {
  const float v[3] = {p - kVoxel, p, p + kVoxel};
  LaoAxis<Row> out;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float u = vpt_clip(v[j] * (float)n - 0.5f, 0.0f, (float)(n - 1));
    const float i = floorf(u);
    out.f[j] = u - i;
    out.g[j] = 1.0f - out.f[j];
    out.off[j] = (Row)vpt_index(i) * stride;
  }
  return out;
}

// One frame; with kCount, counts gets the pixels' active slices and the
// slices their warps step through (the leader of each group of lanes that
// runs a slice together counts one).
template <bool kBf16, bool kTfBf16, class Row, bool kCount>
__global__ void __launch_bounds__(kVptTileThreads)
lao_kernel(const VptLaoArgs a, float4* __restrict__ state,
           unsigned long long* __restrict__ counts) {
  int x, y;
  if (!vpt_tile_pixel(a.width, a.height, &x, &y)) return;
  const int i = y * a.width + x;

  // the pixel's ray (_march.rays): unproject, slab test clamped at 0
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = __ldg(a.mvp + k);
  const float ndcx = vpt_pixel_ndc(x, a.width);
  const float ndcy = vpt_pixel_ndc(y, a.height);
  float from[3], to[3], dir[3];
  vpt_unproject(m, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  const float tb0 = vpt_nmax(tnear, 0.0f), tb1 = vpt_nmax(tfar, 0.0f);
  if (tb0 >= tb1) {
    state[i] = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    return;
  }
  float start[3], seg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    start[k] = from[k] + tb0 * dir[k];
    seg[k] = (from[k] + tb1 * dir[k]) - start[k];
  }

  // what the random value fixes (lao.setup)
  const float rx = __ldg(a.rx + i);
  const float t0 = vpt_clip(rx * a.step * 1.5f, 0.0f, 1.0f);
  const float q = 2.0f * rx - 1.0f;
  const float sign = q > 0.0f ? 1.0f : (q < 0.0f ? -1.0f : q);
  const float rdir = sign * (rx / kSqrt3);
  const float light[3] = {a.lx, a.ly, a.lz};
  float sdir[3] = {-1.0f + a.lx * rx, a.ly + rx * a.lz,
                   -1.0f + 2.0f * a.rconst};
  const float snorm = norm3(sdir[0], sdir[1], sdir[2]);
  float soff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sdir[k] = sdir[k] / snorm * rx;
    soff[k] = sdir[k] * a.light_radius;
  }
  const float slen = sqrtf(sdir[0] * sdir[0] + sdir[1] * sdir[1]
                           + sdir[2] * sdir[2]);

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int s = 0;
  for (; s < a.slices; ++s) {
    const float t = t0 + (float)s * a.step;
    if (!(t < 1.0f && acc.w <= 0.9f)) break;
    if constexpr (kCount) {
      const unsigned group = __activemask();
      if ((threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(counts + 1, 1ull);
    }
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = start[k] + t * seg[k];

    // the raw gradient (p - e_k vs minus p + e_k vs) and the value: the
    // cells ((iz h + iy) w + ix) from the axes' shared offsets
    const LaoAxis<Row> ax = lao_axis<Row>(p[0], a.w, (Row)1);
    const LaoAxis<Row> ay = lao_axis<Row>(p[1], a.h, (Row)a.w);
    const LaoAxis<Row> az = lao_axis<Row>(p[2], a.d, (Row)a.h * a.w);
    const Row zy = az.off[1] + ay.off[1];
    const Row rows[7] = {zy + ax.off[0], zy + ax.off[2],
                         az.off[1] + ay.off[0] + ax.off[1],
                         az.off[1] + ay.off[2] + ax.off[1],
                         az.off[0] + ay.off[1] + ax.off[1],
                         az.off[2] + ay.off[1] + ax.off[1],
                         zy + ax.off[1]};
    VptRow<kBf16> row[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) row[j] = vpt_load_row<kBf16>(a.table, rows[j]);
    // cell j's coordinate on each axis: 0 (p - v), 1 (p) or 2 (p + v)
    const float g[3] = {
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
                                     ay.g[1], az.f[2], az.g[2])};
    const float grad_mag = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float value = vpt_lerp_row_fg<kBf16>(row[6], ax.f[1], ax.g[1],
                                                ay.f[1], ay.g[1], az.f[1],
                                                az.g[1]);

    // local ambient occlusion: the taps' reads a group at a time, each
    // group folded in order
    float lao = 0.0f;
    if (a.lao_on) {
      float inner = 0.0f;
      for (int j0 = 0; j0 < a.n_taps; j0 += kGroup) {
        VptCell<Row> tc[kGroup];
        VptRow<kBf16> tr[kGroup];
        float tw[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j >= a.n_taps) break;
          const float4 tap = __ldg(a.taps + j0 + j);
          float half[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) half[k] = light[k] + rdir * tap.y - p[k];
          const float hn = norm3(half[0], half[1], half[2]);
#pragma unroll
          for (int k = 0; k < 3; ++k) half[k] = p[k] + half[k] / hn * tap.x;
          tc[j] = vpt_cell<Row>(a.d, a.h, a.w, half[0], half[1],
                                half[2]);
          tr[j] = vpt_load_row<kBf16>(a.table, tc[j].row);
          tw[j] = tap.z;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j >= a.n_taps) break;
          inner = inner + vpt_lerp_row<kBf16>(tr[j], tc[j]) * tw[j];
        }
      }
      float carried = 0.0f, total = 0.0f;
      for (int n = 0; n < a.lao_samples; ++n) {
        carried = vpt_clip((carried + inner) / a.light_coefficient, 0.0f,
                           1.0f);
        total = total + carried;
      }
      lao = total / (float)a.lao_samples;
    }

    // the soft shadow
    float soft = 0.0f;
    if (a.soft_on) {
      const float vs = vpt_fetch<kBf16, Row>(a.table, a.d, a.h, a.w,
                                             p[0] + soff[0], p[1] + soff[1],
                                             p[2] + soff[2]);
      float contrib = vs * (vs * 0.2f) * slen;
      contrib = vpt_clip(contrib * 20.0f, 0.0f, 1.0f);
      soft = vpt_clip((-0.2f + 1.2f * contrib) / 1.3f, 0.0f, 1.0f);
    }

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
  if constexpr (kCount) atomicAdd(counts, (unsigned long long)s);
  if (acc.w > 1.0f) {
    const float den = vpt_nmax(acc.w, 1e-6f);
    acc.x = acc.x / den;
    acc.y = acc.y / den;
    acc.z = acc.z / den;
  }
  state[i] = make_float4(acc.x, acc.y, acc.z, 1.0f);
}

// The instantiation for the table types, the row index and counting.
using Kernel = void (*)(const VptLaoArgs, float4*, unsigned long long*);

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

int launch(const void* prepared, void* state, void* counts, void* stream) {
  const VptLaoArgs& a = *static_cast<const VptLaoArgs*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return 0;
  const Kernel kernel = pick(a.table_bf16, a.tf_bf16, a.rows64,
                             counts != nullptr);
  const unsigned blocks = (unsigned)vpt_tile_blocks(a.width, a.height);
  kernel<<<blocks, kVptTileThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<float4*>(state),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

}  // namespace

// One frame: prepared is the VptLaoArgs of the scene, Params and
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

// The launch shape for a corner table of bf16 (or float32) rows, a packed
// TF table of bf16 (or float32) and 64-bit (or 32-bit) row indices on
// `device`: out = threads a block, resident blocks an SM, SMs, registers a
// thread, local (spilled) bytes a thread, static shared bytes a block, the
// block's tile width and height, the warp's tile width in pixels and the
// AO taps read ahead of their fold.  Launches nothing.
extern "C" int vpt_lao_info(int table_bf16, int tf_bf16, int rows64,
                            int device, int* out) {
  VptDeviceGuard guard(device);
  const Kernel kernel = pick(table_bf16, tf_bf16, rows64, false);
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kVptTileThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[] = {kVptTileThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        kVptTileW, kVptTileH, kVptWarpW, kGroup};
  for (int k = 0; k < 10; ++k) out[k] = values[k];
  return 0;
}
