// DOS slice kernel (K9): one slice of DOS's front-to-back sweep, one thread
// a pixel; one C call launches a frame's slices in order.
//
// Replaces the XLA lax.scan of vpt_tpu/renderers/dos.py:126-212 (chunk_step
// :157-203) with the gather-free disk taps of _shifted_occlusion_taps
// (:43-86).  It has no Pallas original; its corner fetch and TF lookup are
// the device functions of ray.cuh and tf1d.cuh.
//
// Per pixel and slice: unproject (ndc, ndc_depth_k, 1) through the inverse
// MVP and divide by w; where the slice is active (depth_k <= max_depth) and
// the point lies in the unit cube, one colour fetch (the corner row and the
// 1D TF in the scene's mode), alpha = 1 - exp(-a*sigma*ds) composited front
// to back into the colour state (alpha min-clamped at 1), and the new
// occlusion: the mean of N bilinear taps of the PREVIOUS occlusion buffer at
// shifts that are the same for every pixel, times exp(-a*sigma*ds).  Pixels
// that write nothing carry their previous occlusion into the new buffer.
//
// Bound on the H100: an active slice reads and writes the 16-byte colour of
// every pixel it writes (those whose point lies in the cube), reads the
// previous occlusion buffer and writes the new one (4 + 4 bytes a pixel),
// and reads the distinct corner rows (16 bytes, bf16) of its written
// pixels and the TF row; the taps' 4N reads a pixel fall on neighbouring
// texels of a 1 MB buffer (at 512^2) and hit L1/L2.  A written pixel costs
// ~160 float32 operations (unproject, fetch, TF, exp, composite, 8 taps):
// bytes bound it.  On the 512^2 headline (chip_smoke.py's count from the
// sweep's own slice tables) a sweep is 5 frames of 50 launches, 201 active
// slices writing 11.8 M pixels: 955 MB, 0.285 ms at 3.35 TB/s.  Measured
// (PERF.md §6): ~6 us of device time a slice, ~5x the bound over a sweep,
// but ~1 ms of host a frame (the slice table's ~45 small PyTorch ops about
// half of it, the 50 launches of the one C call most of the rest): the
// host sets the sweep's time.
//
// Design (right and simple first): pixels in row-major order, 128 a block,
// so that a warp streams 512 contiguous bytes of colour and the taps of a
// warp's pixels fall on neighbouring texels.  The per-slice constants (NDC
// depth, the active flag, the slice distance, each tap's integer shift and
// fraction) come from one row of a table that the wrapper builds on the
// card with the same PyTorch function as the plain version
// (renderers/dos.slice_table), so both hold the same bits and no
// transcendental of the schedule is evaluated here.  Each slice is one
// launch (a slice reads its neighbours' previous occlusion, so it is a step
// across the whole image), two occlusion buffers ping-pong, and the C entry
// point issues all of a frame's launches in one call, checking
// cudaGetLastError() after each.  The TF row is read through the read-only
// cache; the tap rows are 16-byte reads of the table.
//
// Numerics follow renderers/dos.composite_slices and occlusion_taps
// operation by operation: built with -fmad=false, IEEE division, expf
// (PyTorch's exp on the card), NaN-propagating min, the taps summed in order
// k = 0..N-1 then divided by N, reads clamped at the edges, a tap's x
// fraction zeroed unless 0 <= x + bx <= W-2 (y likewise with H).
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"

// What a frame takes of its scene, Params and resolution, filled once by the
// wrapper (kernels/dos_sweep.py, a ctypes Structure of this layout).
struct VptDosArgs {
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  const float4* tf_row;  // (tw, 4)
  const float* mvp;      // 16 floats, row-major inverse MVP
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  int width, height;     // the image
  int samples;           // N, the disk taps
  float extinction;
  int device;
};

namespace {

constexpr int kThreads = 128;
// the leading floats of a slice's row (dos.TABLE_HEAD): NDC depth, active,
// slice distance, 0; then (bx, by, fx, fy) a tap
constexpr int kHead = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <bool kBf16, int kTf>
__global__ void __launch_bounds__(kThreads)
dos_slice_kernel(const VptDosArgs a, const float* __restrict__ row,
                 float4* __restrict__ color, const float* __restrict__ src,
                 float* __restrict__ dst) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int width = a.width, height = a.height;
  if (i >= width * height) return;
  const float prev = __ldg(src + i);
  bool write = false;
  float p[3];
  if (__ldg(row + 1) > 0.0f) {
    const int x = i % width, y = i / width;
    const float nx = vpt_pixel_ndc(x, width), ny = vpt_pixel_ndc(y, height);
    const float nz = __ldg(row);
    float h4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      h4[r] = nx * __ldg(a.mvp + 4 * r) + ny * __ldg(a.mvp + 4 * r + 1)
              + nz * __ldg(a.mvp + 4 * r + 2)
              + 1.0f * __ldg(a.mvp + 4 * r + 3);
    }
    bool outside = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = h4[k] / h4[3];
      outside = outside || p[k] > 1.0f || p[k] < 0.0f;
    }
    write = !outside;
  }
  if (!write) {
    dst[i] = prev;
    return;
  }
  const int x = i % width, y = i / width;
  const float sd = __ldg(row + 2);
  const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, p[0], p[1], p[2]);
  const float4 c = vpt_tf1d_lookup<true>(a.tf_row, a.tw, v, kTf);
  const float e = c.w * a.extinction;
  const float transmittance = expf(-e * sd);
  const float alpha = 1.0f - transmittance;
  float4 col = color[i];
  const float keep = 1.0f - col.w;
  col.x = col.x + c.x * prev * alpha * keep;
  col.y = col.y + c.y * prev * alpha * keep;
  col.z = col.z + c.z * prev * alpha * keep;
  col.w = vpt_nmin(col.w + alpha, 1.0f);

  // the disk taps of the previous buffer
  const float4* taps = reinterpret_cast<const float4*>(row + kHead);
  float total = 0.0f;
  for (int k = 0; k < a.samples; ++k) {
    const float4 t = __ldg(taps + k);
    const int xs = x + (int)t.x, ys = y + (int)t.y;
    const int x0 = clampi(xs, 0, width - 1), x1 = clampi(xs + 1, 0, width - 1);
    const int y0 = clampi(ys, 0, height - 1);
    const int y1 = clampi(ys + 1, 0, height - 1);
    const float fx = (xs >= 0 && xs <= width - 2) ? t.z : 0.0f;
    const float fy = (ys >= 0 && ys <= height - 2) ? t.w : 0.0f;
    const float a00 = __ldg(src + y0 * width + x0);
    const float a10 = __ldg(src + y0 * width + x1);
    const float a01 = __ldg(src + y1 * width + x0);
    const float a11 = __ldg(src + y1 * width + x1);
    const float c0 = a00 * (1.0f - fx) + a10 * fx;
    const float c1 = a01 * (1.0f - fx) + a11 * fx;
    const float tap = c0 * (1.0f - fy) + c1 * fy;
    total = (k == 0) ? tap : total + tap;
  }
  dst[i] = total / (float)a.samples * transmittance;
  color[i] = col;
}

// The instantiation for a table type and TF lookup mode (tf1d.cuh's: a
// compile-time constant, so the lookup carries no branch).
using Kernel = void (*)(const VptDosArgs, const float*, float4*, const float*,
                        float*);

template <bool kBf16>
Kernel pick_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return dos_slice_kernel<kBf16, 0>;
    case 1: return dos_slice_kernel<kBf16, 1>;
    case 2: return dos_slice_kernel<kBf16, 2>;
    default: return nullptr;
  }
}

Kernel pick(int table_bf16, int tf_mode) {
  return table_bf16 ? pick_tf<true>(tf_mode) : pick_tf<false>(tf_mode);
}

}  // namespace

// One frame: prepared is the VptDosArgs of the scene, Params and
// resolution; color the (height, width, 4) colour state (updated in place),
// occlusion the state's (height, width) occlusion buffer and scratch another
// of its shape; slices the (steps, 4 + 4N) float32 rows of dos.slice_table.
// Slice k reads the buffer slice k-1 wrote (occlusion for k = 0) and writes
// the other, so the last slice's is scratch when steps is odd.
extern "C" int vpt_dos_sweep_launch(const void* prepared, void* color,
                                    void* occlusion, void* scratch,
                                    const void* slices, int steps,
                                    void* stream) {
  const VptDosArgs& a = *static_cast<const VptDosArgs*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.width <= 0 || a.height <= 0) return 0;
  const Kernel kernel = pick(a.table_bf16, a.tf_mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(
      ((long long)a.width * a.height + kThreads - 1) / kThreads);
  const int row_floats = kHead + 4 * a.samples;
  const float* src = static_cast<const float*>(occlusion);
  float* dst = static_cast<float*>(scratch);
  for (int k = 0; k < steps; ++k) {
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, static_cast<const float*>(slices) + (long long)k * row_floats,
        static_cast<float4*>(color), src, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* written = dst;
    dst = const_cast<float*>(src);
    src = written;
  }
  return 0;
}

// The launch shape for a table of bf16 (or float32) rows and the TF lookup
// mode `tf_mode` on `device`: out = threads a block, resident blocks an SM,
// SMs, registers a thread, local (spilled) bytes a thread, static shared
// bytes a block.  Launches nothing.
extern "C" int vpt_dos_sweep_info(int table_bf16, int tf_mode, int device,
                                  int* out) {
  VptDeviceGuard guard(device);
  const Kernel kernel = pick(table_bf16, tf_mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
  for (int k = 0; k < 6; ++k) out[k] = values[k];
  return 0;
}
