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
// 20 + 1) of 16 bytes (bf16), with ~30 float32 operations a read (cell and
// lerp), ~20 more an AO tap (its half-vector, norm and division) and ~80 a
// slice (gradient norm, AO and shadow terms, the 2D TF lookup, tints,
// composite).  On the 512^2 headline (chip_smoke.py's count from the plain
// frame): 97,344 hit pixels, 5.4 M active pixel-slices, 1.5e8 reads of 2.1 M
// distinct rows (the whole 33.5 MB table, which the 50 MB L2 holds): ~7.2e9
// operations, 0.107 ms at 67 TFLOP/s, against 39 MB (0.012 ms at 3.35
// TB/s): operations bound it.  Measured (PERF.md §6) about 10x that: the
// IEEE divisions and square roots of the 20 normalisations a slice, and one
// warp's chain of dependent reads and folds with 7 (bf16) or 5 (float32)
// blocks an SM, set its time.
//
// Design (right and simple first): one thread a pixel on the 8 x 4 warp
// tiles of ray.cuh (the march kernel measured tiles faster than rows: a
// warp's rays read neighbouring rows and leave the loop at similar slices).
// The ray, the random value rx, the AO direction and the shadow offset stay
// in registers; rx comes from an (H, W) tensor that the wrapper prepares
// once with the plain version's own function (no cosf/sinf here), as do
// rconst, the light and the AO taps' (t2, light_radius*t2, (1-t2)^2).  A
// slice issues its seven gradient and value reads before folding them, then
// the AO taps in groups of kGroup (the taps do not depend on one another),
// each group's reads issued before its fold, which keeps the plain order of
// the sum (see kGroup: neither no grouping, nor larger groups, nor register
// caps for more resident blocks moved it by more than 10%).  The packed TF
// table is read through the read-only cache (the ISO shade kernel measured
// that faster than a shared copy).  The loop breaks once the pixel is
// inactive: t only grows and the state stops changing once alpha exceeds
// 0.9, so this is exact.  A miss writes (0, 0, 0, 1) at once.
//
// Numerics follow renderers/lao.py (setup, march_slice, finish) operation
// by operation: built with -fmad=false, IEEE division and sqrt,
// NaN-propagating min/max, sums of three left to right, rows indexed with
// 64 bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"

// What a frame takes of its scene, Params and resolution, filled once by the
// wrapper (kernels/lao_march.py, a ctypes Structure of this layout).
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
};

namespace {

// AO taps read ahead of their fold: groups of 1 to 10, and register caps
// for 6 or 8 blocks an SM (which spill), measured in turns at 512^2 on the
// headline and a float32 scene (bench_mcm_event.py --kernel lao, PERF.md
// §6), stay within about 10% of one another; 2 is kept (the readings are
// in PERF.md)
constexpr int kGroup = 2;
constexpr float kVoxel = 1.0f / 32.0f;
// float32(sqrt(3)), the divisor of the AO direction
constexpr float kSqrt3 = 1.7320508075688772f;

// The 2D bilinear lookup of sampling.sample_texture2d_packed at uv = (u, v)
// from one (16,) row of 2 x 2 texel corners (x minor), four channels each.
template <bool kTfBf16>
__device__ __forceinline__ float4 tf2d(const void* table, int tw, int th,
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

// sqrt(max(x*x + y*y + z*z, 1e-20)), the norm of lao.py's _norm
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(vpt_nmax(x * x + y * y + z * z, 1e-20f));
}

template <bool kBf16, bool kTfBf16>
__global__ void __launch_bounds__(kVptTileThreads)
lao_kernel(const VptLaoArgs a, float4* __restrict__ state) {
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
  for (int s = 0; s < a.slices; ++s) {
    const float t = t0 + (float)s * a.step;
    if (!(t < 1.0f && acc.w <= 0.9f)) break;
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = start[k] + t * seg[k];

    // the raw gradient (p - e_k vs minus p + e_k vs) and the value
    VptCell<int64_t> cell[7];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float lo[3] = {p[0], p[1], p[2]}, hi[3] = {p[0], p[1], p[2]};
      lo[k] = p[k] - kVoxel;
      hi[k] = p[k] + kVoxel;
      cell[2 * k] = vpt_cell<int64_t>(a.d, a.h, a.w, lo[0], lo[1], lo[2]);
      cell[2 * k + 1] = vpt_cell<int64_t>(a.d, a.h, a.w, hi[0], hi[1], hi[2]);
    }
    cell[6] = vpt_cell<int64_t>(a.d, a.h, a.w, p[0], p[1], p[2]);
    VptRow<kBf16> row[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) row[j] = vpt_load_row<kBf16>(a.table,
                                                             cell[j].row);
    float g[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g[k] = vpt_lerp_row<kBf16>(row[2 * k], cell[2 * k])
             - vpt_lerp_row<kBf16>(row[2 * k + 1], cell[2 * k + 1]);
    }
    const float grad_mag = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float value = vpt_lerp_row<kBf16>(row[6], cell[6]);

    // local ambient occlusion: the taps' reads a group at a time, each
    // group folded in order
    float lao = 0.0f;
    if (a.lao_on) {
      float inner = 0.0f;
      for (int j0 = 0; j0 < a.n_taps; j0 += kGroup) {
        VptCell<int64_t> tc[kGroup];
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
          tc[j] = vpt_cell<int64_t>(a.d, a.h, a.w, half[0], half[1],
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
      const float vs = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, p[0] + soff[0],
                                        p[1] + soff[1], p[2] + soff[2]);
      float contrib = vs * (vs * 0.2f) * slen;
      contrib = vpt_clip(contrib * 20.0f, 0.0f, 1.0f);
      soft = vpt_clip((-0.2f + 1.2f * contrib) / 1.3f, 0.0f, 1.0f);
    }

    float4 c = tf2d<kTfBf16>(a.tf_table, a.tw, a.th, value, grad_mag);
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
  if (acc.w > 1.0f) {
    const float den = vpt_nmax(acc.w, 1e-6f);
    acc.x = acc.x / den;
    acc.y = acc.y / den;
    acc.z = acc.z / den;
  }
  state[i] = make_float4(acc.x, acc.y, acc.z, 1.0f);
}

// The instantiation for the table types.
using Kernel = void (*)(const VptLaoArgs, float4*);

Kernel pick(int table_bf16, int tf_bf16) {
  if (table_bf16) {
    return tf_bf16 ? lao_kernel<true, true> : lao_kernel<true, false>;
  }
  return tf_bf16 ? lao_kernel<false, true> : lao_kernel<false, false>;
}

}  // namespace

// One frame: prepared is the VptLaoArgs of the scene, Params and
// resolution; state the (height, width, 4) frame it writes.
extern "C" int vpt_lao_launch(const void* prepared, void* state,
                              void* stream) {
  const VptLaoArgs& a = *static_cast<const VptLaoArgs*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return 0;
  const Kernel kernel = pick(a.table_bf16, a.tf_bf16);
  const unsigned blocks = (unsigned)vpt_tile_blocks(a.width, a.height);
  kernel<<<blocks, kVptTileThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<float4*>(state));
  return (int)cudaGetLastError();
}

// The launch shape for a corner table of bf16 (or float32) rows and a
// packed TF table of bf16 (or float32) on `device`: out = threads a block,
// resident blocks an SM, SMs, registers a thread, local (spilled) bytes a
// thread, static shared bytes a block, the block's tile width and height,
// the warp's tile width in pixels and the AO taps read ahead of their fold.
// Launches nothing.
extern "C" int vpt_lao_info(int table_bf16, int tf_bf16, int device,
                            int* out) {
  VptDeviceGuard guard(device);
  const Kernel kernel = pick(table_bf16, tf_bf16);
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
