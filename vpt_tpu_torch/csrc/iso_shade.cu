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
// Numerics follow iso.shade (renderers/iso.py) operation by operation:
// built with -fmad=false, the gradient's IEEE division by the float32 2h,
// NaN-propagating max, sums left to right, rows indexed with 64 bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"

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
  for (int k = 0; k < 3; ++k) {
    float q[3] = {p[0], p[1], p[2]}, r[3] = {p[0], p[1], p[2]};
    q[k] = p[k] + a.step;
    r[k] = p[k] - a.step;
    if constexpr (kC == 0) {
      cell[2 * k] = vpt_cell<int64_t>(a.d, a.h, a.w, q[0], q[1], q[2]);
      cell[2 * k + 1] = vpt_cell<int64_t>(a.d, a.h, a.w, r[0], r[1], r[2]);
    } else {
      cell[2 * k] = vpt_cell_filtered<int64_t>(a.d, a.h, a.w, q[0], q[1],
                                               q[2], a.filter);
      cell[2 * k + 1] = vpt_cell_filtered<int64_t>(a.d, a.h, a.w, r[0],
                                                   r[1], r[2], a.filter);
    }
  }
  if constexpr (kC == 0) {
    cell[6] = vpt_cell<int64_t>(a.d, a.h, a.w, p[0], p[1], p[2]);
  } else {
    cell[6] = vpt_cell_filtered<int64_t>(a.d, a.h, a.w, p[0], p[1], p[2],
                                         a.filter);
  }
  VptRowOf<kBf16, kC> row[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    row[j] = vpt_load_rows<kBf16, kC>(a.table, cell[j].row);
  }
  const auto color = [&](int j) {
    if constexpr (kC == 0) {
      return vpt_tf1d_lookup<true>(a.tf_row, a.tw,
                                   vpt_lerp_row<kBf16>(row[j], cell[j]),
                                   kTf);
    } else {
      return vpt_color_rg<kBf16, kC, true>(
          a.tf_row, a.tw, kTf, a.tf_table, a.th,
          vpt_lerp_rg<kBf16, kC>(row[j], cell[j]));
    }
  };
  // central differences of TF alpha (central_value_gradient)
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
  out[i] = make_float4(c.x * lambert, c.y * lambert, c.z * lambert, 1.0f);
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
