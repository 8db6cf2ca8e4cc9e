// ISO shade kernel: the ISO renderer's display, one thread a pixel.
//
// Replaces the XLA display of vpt_tpu/renderers/iso.py:109-130 (the
// deferred central-difference + Lambert shade; Scene.value_gradient of
// base.py:232-236 through sampling.central_value_gradient, :625-633).  It
// has no Pallas original; its fetches and TF lookups are the device
// functions of ray.cuh and tf1d.cuh.
//
// Bound on the H100: every pixel reads its 16-byte state and writes 16
// bytes, 8.4 MB at 512^2; a hit pixel also fetches seven corner rows (six
// gradient taps at +-h on each axis and the material at the hit) with a
// TF lookup each, ~7 x 35 operations plus ~40 of the normal and the
// Lambert term.  On the 512^2 headline 5.7% of the pixels hit (14 980, from
// 13 123 distinct rows): bytes bound it, 0.0026 ms at 3.35 TB/s, and a
// plain copy of the state into the image takes 0.0024 ms with both in L2
// (0.0046 from HBM).
//
// Design: pixels run in row-major launch order, 32 consecutive pixels a
// warp, so that a warp streams 512 contiguous bytes of state and image and
// the taps of a row of pixels fall on consecutive corner rows of the
// x-minor table.  A thread reads its state first; a pixel without a hit
// writes white and leaves, with no prologue and no barrier to wait for.  A
// hit computes all seven cells, issues the seven row reads, and only then
// folds them in the plain order (lerps, TF lookups, differences,
// divisions).  The TF row is read through the read-only cache: at TW 256
// it is 4 KiB, which L1 keeps once the first warps of an SM have touched
// it, so no block copies it into shared memory.  The TF lookup mode and the
// table type are template parameters.  The launch takes its scene, Params
// and resolution as one pointer to a VptIsoShadeExt that the wrapper
// prepares once.  Two-channel and filtered volumes run
// iso_shade_ext_kernel, the same body (iso_shade) with ray.cuh's ext
// fetch for the seven taps (the filter a warp-uniform argument) and, for
// two channels, the 2D TF lookup.
//
// Tried, in turns on one H100 against the first design (rows of 128
// pixels, the TF row copied into shared memory by every block behind a
// barrier, the TF mode a runtime argument, the fetches as a sequence), on
// the headline at 512^2 (PERF.md §6): this kernel 0.70x its time; each of
// these alone cost more: the TF row in shared memory 1.17x (4.7x with the
// 3072-texel row, whose 48 KiB every block copies), the compiler's order
// of the fetches 1.06x, the TF mode at run time 1.10x, a persistent grid
// that copies the TF row once a block 1.11x, two pixels a thread 1.27x,
// 8 x 4 warp tiles 1.03x (1.06x on a state that hits in every pixel),
// 256-thread blocks 0.95x but 1.03-1.07x on the other scenes, register
// caps for 12 or 16 blocks an SM 1.06-1.35x (spills).  What is left: the
// misses' stream, which a copy of the same bytes takes 0.67x of, and the
// hit warps' chain (state, rows, TF, store) on about 1.5 waves of blocks.
//
// A HaloScene's display runs the halo instance (iso_halo_fetch_kernel and
// iso_halo_shade_kernel below) around one all-reduce of the seven values.
//
// Numerics follow iso.shade (renderers/iso.py) operation by operation:
// built with -fmad=false, the gradient's IEEE division by the float32 2h,
// NaN-propagating max, sums left to right, rows indexed with 64 bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

// What a display takes of its scene, Params and resolution, filled once by
// the wrapper (kernels/iso_shade.py, a ctypes Structure of this layout).
struct VptIsoShadeArgs {
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  const float4* tf_row;  // (tw, 4)
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  int width, height;     // the image
  float step, two_step;  // h and the float32 2h
  float lx, ly, lz;      // the normalised light direction
  int device;
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, ray.cuh) take besides; only they read it.
struct VptIsoShadeExt : VptIsoShadeArgs {
  const void* tf_table;  // (th*tw, 16) packed TF of the table's type
  int th;
  int channels;          // 1 or 2: with filter 0 and 1 channel, no ext
  int filter;            // ray.cuh's VptFilter
};

namespace {

// the fetches of a hit: +h and -h on x, then y, then z, then the hit
constexpr int kTaps = 7;
constexpr int kThreads = 128;

// Fetch j of a hit at p (+h and -h on x, then y, then z, then the hit).
__device__ __forceinline__ void iso_tap(const float p[3], float step, int j,
                                        float q[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = p[k];
  if (j < 6) q[j / 2] = (j % 2 == 0) ? p[j / 2] + step : p[j / 2] - step;
}

// The shade of a hit from color(j), the colour of fetch j: the central
// differences of TF alpha (central_value_gradient), the normal, the Lambert
// term and the material colour at the hit.
template <class A, class Color>
__device__ __forceinline__ float4 iso_lambert(const A& a, Color color) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g[k] = color(2 * k).w - color(2 * k + 1).w;
    g[k] = g[k] / a.two_step;
  }
  const float len = sqrtf(vpt_nmax(g[0] * g[0] + g[1] * g[1] + g[2] * g[2],
                                   1e-12f));
  const float nx = g[0] / len, ny = g[1] / len, nz = g[2] / len;
  const float lambert = vpt_nmax(nx * a.lx + ny * a.ly + nz * a.lz, 0.0f);
  const float4 c = color(6);
  return make_float4(c.x * lambert, c.y * lambert, c.z * lambert, 1.0f);
}

// The colour of a fetched (value, channel 1) through the read-only cache:
// the TF row's lookup in mode kTf, or for two channels the packed 2D TF's.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ float4 iso_color(const A& a, float2 v) {
  if constexpr (kC == 0) {
    return vpt_tf1d_lookup<true>(a.tf_row, a.tw, v.x, kTf);
  } else {
    return vpt_color_rg<kBf16, kC, true>(a.tf_row, a.tw, kTf, a.tf_table,
                                         a.th, v);
  }
}

// kC is 0 for the headline's linear single-channel fetch, else an ext
// instance's channels, whose cells take the filter.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ void iso_shade(const A& a,
                                          const float4* __restrict__ state,
                                          float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.width * a.height) return;
  const float4 s = __ldg(state + i);
  if (!(s.w > 0.0f)) {
    out[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return;
  }
  const float p[3] = {s.x, s.y, s.z};
  VptCell<int64_t> cell[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    float q[3];
    iso_tap(p, a.step, j, q);
    if constexpr (kC == 0) {
      cell[j] = vpt_cell<int64_t>(a.d, a.h, a.w, q[0], q[1], q[2]);
    } else {
      cell[j] = vpt_cell_filtered<int64_t>(a.d, a.h, a.w, q[0], q[1], q[2],
                                           a.filter);
    }
  }
  VptRowOf<kBf16, kC> row[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    row[j] = vpt_load_rows<kBf16, kC>(a.table, cell[j].row);
  }
  out[i] = iso_lambert(a, [&](int j) {
    return iso_color<kBf16, kTf, kC>(a, vpt_lerp_rg<kBf16, kC>(row[j],
                                                              cell[j]));
  });
}

template <bool kBf16, int kTf>
__global__ void __launch_bounds__(kThreads)
iso_shade_kernel(const VptIsoShadeArgs a, const float4* __restrict__ state,
                 float4* __restrict__ out) {
  iso_shade<kBf16, kTf, 0>(a, state, out);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows, the
// TF lookup mode kTf; 2: a two-channel volume and the 2D TF table).
template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
iso_shade_ext_kernel(const VptIsoShadeExt a, const float4* __restrict__ state,
                     float4* __restrict__ out) {
  iso_shade<kBf16, kTf, kC>(a, state, out);
}

// The halo instance (parallel/halo.py, a HaloScene display): a sample is
// the sum over the ranks of their masked slab-local values
// (vpt_tpu/parallel/halo.py:199-250), summed before the TF lookup.
// vpt_tpu's display (iso.py:109-130) samples the seven fetches of a hit
// one sample_color at a time, seven psums; here a display is two launches
// around ONE all-reduce of the (7, n, kC or 1) values, the same sums in
// fewer collectives: iso_halo_fetch_kernel writes the masked values of the
// seven fetches of every hit pixel (slab.cuh's cell; 0 where another rank
// owns it; a pixel without a hit writes nothing, and nothing reads it),
// iso_halo_shade_kernel looks the summed values up and shades as
// iso_shade does (iso_lambert), white where nothing was hit.  So on one
// slab a display equals the whole-scene kernel's bit for bit.  A HaloScene
// has no filter: kC is 0 (one channel, the TF row in mode kTf) or 2 (the
// value pair, the 2D TF).
template <bool kBf16, int kC>
__global__ void __launch_bounds__(kThreads)
iso_halo_fetch_kernel(const VptIsoShadeExt a, const VptSlab slab,
                      const float4* __restrict__ state,
                      float* __restrict__ value) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.width * a.height;
  if (i >= n) return;
  const float4 s = __ldg(state + i);
  if (!(s.w > 0.0f)) return;
  constexpr int kV = kC == 2 ? 2 : 1;
  const float p[3] = {s.x, s.y, s.z};
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    float q[3];
    iso_tap(p, a.step, j, q);
    const VptSlabCell cell = vpt_slab_cell(a.d, a.h, a.w, slab, q[0], q[1],
                                           q[2]);
    float2 v = make_float2(0.0f, 0.0f);
    if (cell.local) v = vpt_slab_value<kBf16, kC>(a.table, cell);
    float* o = value + kV * ((long long)j * n + i);
    o[0] = v.x;
    if (kV == 2) o[1] = v.y;
  }
}

template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
iso_halo_shade_kernel(const VptIsoShadeExt a,
                      const float4* __restrict__ state,
                      const float* __restrict__ value,
                      float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.width * a.height;
  if (i >= n) return;
  const float4 s = __ldg(state + i);
  if (!(s.w > 0.0f)) {
    out[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return;
  }
  constexpr int kV = kC == 2 ? 2 : 1;
  out[i] = iso_lambert(a, [&](int j) {
    const float* v = value + kV * ((long long)j * n + i);
    return iso_color<kBf16, kTf, kC>(
        a, make_float2(v[0], kV == 2 ? v[1] : 0.0f));
  });
}

using KernelHaloFetch = void (*)(const VptIsoShadeExt, const VptSlab,
                                 const float4*, float*);
using KernelHaloShade = void (*)(const VptIsoShadeExt, const float4*,
                                 const float*, float4*);

KernelHaloFetch pick_halo_fetch(int channels, int table_bf16) {
  if (channels == 2)
    return table_bf16 ? iso_halo_fetch_kernel<true, 2>
                      : iso_halo_fetch_kernel<false, 2>;
  if (channels != 1) return nullptr;
  return table_bf16 ? iso_halo_fetch_kernel<true, 0>
                    : iso_halo_fetch_kernel<false, 0>;
}

KernelHaloShade pick_halo_shade(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? iso_halo_shade_kernel<true, 0, 2>
                      : iso_halo_shade_kernel<false, 0, 2>;
  if (channels != 1) return nullptr;
  switch (tf_mode + 3 * table_bf16) {
    case 0: return iso_halo_shade_kernel<false, 0, 0>;
    case 1: return iso_halo_shade_kernel<false, 1, 0>;
    case 2: return iso_halo_shade_kernel<false, 2, 0>;
    case 3: return iso_halo_shade_kernel<true, 0, 0>;
    case 4: return iso_halo_shade_kernel<true, 1, 0>;
    case 5: return iso_halo_shade_kernel<true, 2, 0>;
    default: return nullptr;
  }
}

// The instantiation for a table type and TF lookup mode (tf1d.cuh's: a
// compile-time constant, so the lookup carries no branch).
using Kernel = void (*)(const VptIsoShadeArgs, const float4*, float4*);
using KernelExt = void (*)(const VptIsoShadeExt, const float4*, float4*);

template <bool kBf16>
Kernel pick_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return iso_shade_kernel<kBf16, 0>;
    case 1: return iso_shade_kernel<kBf16, 1>;
    case 2: return iso_shade_kernel<kBf16, 2>;
    default: return nullptr;
  }
}

Kernel pick(int table_bf16, int tf_mode) {
  return table_bf16 ? pick_tf<true>(tf_mode) : pick_tf<false>(tf_mode);
}

// The ext instance: one channel (a filtered volume) in float32 rows with
// each TF lookup mode, or two channels in either row type; null for
// anything else.
KernelExt pick_ext(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? iso_shade_ext_kernel<true, 0, 2>
                      : iso_shade_ext_kernel<false, 0, 2>;
  if (channels != 1 || table_bf16) return nullptr;
  switch (tf_mode) {
    case 0: return iso_shade_ext_kernel<false, 0, 1>;
    case 1: return iso_shade_ext_kernel<false, 1, 1>;
    case 2: return iso_shade_ext_kernel<false, 2, 1>;
    default: return nullptr;
  }
}

template <class K, class A>
cudaError_t launch_kernel(K kernel, const A& a, const void* state, void* out,
                          void* stream) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(
      ((long long)a.width * a.height + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, (const float4*)state, (float4*)out);
  return cudaGetLastError();
}

cudaError_t launch(const VptIsoShadeExt& a, const void* state, void* out,
                   void* stream) {
  if (a.width <= 0 || a.height <= 0) return cudaSuccess;
  if (a.channels != 1 || a.filter != 0) {
    if (a.filter < 0 || a.filter > 2) return cudaErrorInvalidValue;
    return launch_kernel(pick_ext(a.channels, a.table_bf16, a.tf_mode), a,
                         state, out, stream);
  }
  const VptIsoShadeArgs& base = a;
  return launch_kernel(pick(a.table_bf16, a.tf_mode), base, state, out,
                       stream);
}

template <class K>
cudaError_t info(K kernel, int device, int* out) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
  for (int k = 0; k < 6; ++k) out[k] = values[k];
  return cudaSuccess;
}

}  // namespace

// One display: prepared is the VptIsoShadeExt of the scene, Params and
// resolution; state the (height, width, 4) hits, out the image.
extern "C" int vpt_iso_shade_launch(const void* prepared, const void* state,
                                    void* out, void* stream) {
  const VptIsoShadeExt& a = *static_cast<const VptIsoShadeExt*>(prepared);
  VptDeviceGuard guard(a.device);
  return (int)launch(a, state, out, stream);
}

// The same display through the argument list the shade kernel has taken
// since it was ported (every build of it exports this), on the current
// device.
extern "C" int vpt_iso_shade(
    const void* state, void* out, const void* table, int table_bf16, int d,
    int h, int w, const void* tf_row, int tw, int tf_mode, int width,
    int height, float step, float two_step, float lx, float ly, float lz,
    void* stream) {
  VptIsoShadeExt a;
  a.table = table;
  a.tf_row = (const float4*)tf_row;
  a.table_bf16 = table_bf16;
  a.d = d; a.h = h; a.w = w;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.width = width; a.height = height;
  a.step = step; a.two_step = two_step;
  a.lx = lx; a.ly = ly; a.lz = lz;
  a.device = 0;
  a.tf_table = nullptr;
  a.th = 0;
  a.channels = 1;
  a.filter = 0;
  return (int)launch(a, state, out, stream);
}

// The launch shape of the instance `flags` (1: a table of bf16 rows, else
// float32; 2: an ext instance of one channel, 4: of two) for the TF lookup
// mode `tf_mode` on `device`: out = threads a block, resident blocks an
// SM, SMs, registers a thread, local (spilled) bytes a thread, static
// shared bytes a block.  Launches nothing.
extern "C" int vpt_iso_shade_info(int flags, int tf_mode, int device,
                                  int* out) {
  VptDeviceGuard guard(device);
  const int bf16 = flags & 1;
  if (flags & 6)
    return (int)info(pick_ext((flags & 4) ? 2 : 1, bf16, tf_mode), device,
                     out);
  return (int)info(pick(bf16, tf_mode), device, out);
}

// One launch of the halo instance (see iso_halo_fetch_kernel): prepared is
// the VptIsoShadeExt of the HaloScene, Params and resolution (table: the
// rank's slab rows; d, h, w the whole volume's; no filter); the slab: its
// index of num_slabs, the thin slabs a rank (interleave) and whether the
// fetch is masked; value the (7, width * height, channels) values; stage 0
// writes this rank's masked values, stage 1 shades the summed values into
// out.
extern "C" int vpt_iso_halo_launch(const void* prepared, int slab_index,
                                   int num_slabs, int interleave, int masked,
                                   void* value, const void* state, void* out,
                                   int stage, void* stream) {
  const VptIsoShadeExt& a = *static_cast<const VptIsoShadeExt*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return cudaSuccess;
  if (a.filter != 0 || num_slabs < 1 || interleave < 1 || slab_index < 0
      || slab_index >= num_slabs || a.d % (num_slabs * interleave) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(
      ((long long)a.width * a.height + kThreads - 1) / kThreads);
  if (stage == 0) {
    const KernelHaloFetch kernel = pick_halo_fetch(a.channels, a.table_bf16);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const VptSlab slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, slab, (const float4*)state, (float*)value);
  } else if (stage == 1) {
    const KernelHaloShade kernel = pick_halo_shade(a.channels, a.table_bf16,
                                                   a.tf_mode);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, (const float4*)state, (const float*)value, (float4*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The launch shape of the halo instance's stage (0 the fetch, 1 the shade)
// for flags (1 bf16 rows, 4 two channels) and the TF lookup mode on
// `device`: vpt_iso_shade_info's values.  Launches nothing.
extern "C" int vpt_iso_halo_info(int stage, int flags, int tf_mode,
                                 int device, int* out) {
  VptDeviceGuard guard(device);
  const int channels = (flags & 4) ? 2 : 1;
  if (stage == 0) return (int)info(pick_halo_fetch(channels, flags & 1),
                                   device, out);
  return (int)info(pick_halo_shade(channels, flags & 1, tf_mode), device,
                   out);
}
