// ISO shade kernel: the ISO renderer's display, one thread a pixel.
//
// Replaces the XLA display of vpt_tpu/renderers/iso.py:109-130 (the
// deferred central-difference + Lambert shade; Scene.value_gradient of
// base.py:232-236 through sampling.central_value_gradient, :625-633).  It
// has no Pallas original; its fetches and TF lookups are the device
// functions of ray.cuh and tf1d.cuh.
//
// Bound on the H100: a hit pixel fetches seven corner rows (six gradient
// taps at +-h on each axis and the material at the hit) with a TF lookup
// each, ~7 x 35 operations plus ~40 of the normal and the Lambert term; it
// reads its 16-byte state and writes 16 bytes.  At 512^2 that is ~74 M
// operations (1.1 us at 67 TFLOP/s) against 8.4 MB of state and image plus
// the distinct rows (a few us at 3.35 TB/s): bytes bound it.
//
// Design: one thread a pixel; a pixel without a hit writes white and
// fetches nothing.  The TF row sits in shared memory; the light direction,
// the step h and the float32 2h come from the host, computed once.
//
// Numerics follow iso.shade (renderers/iso.py) operation by operation:
// built with -fmad=false, the gradient's IEEE division by 2h, NaN-
// propagating max, sums left to right.
#include <cstdint>
#include <cuda_runtime.h>

#include "ray.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const float4* state;   // (n, 4): the nearest hit (position, t)
  float4* out;           // (n, 4): the shaded image
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  int d, h, w;
  const float4* tf_row;  // (tw, 4)
  int tw, tf_mode;
  int n;                 // pixels
  float step, two_step;  // h and the float32 2h
  float lx, ly, lz;      // the normalised light direction
};

template <bool kBf16>
__device__ __forceinline__ float4 color_at(const Args& a, const float4* tf,
                                           float x, float y, float z) {
  return vpt_tf1d_lookup(tf, a.tw,
                         vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, x, y, z),
                         a.tf_mode);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
iso_shade_kernel(Args a) {
  extern __shared__ float4 s_tf[];
  for (int i = threadIdx.x; i < a.tw; i += blockDim.x) s_tf[i] = a.tf_row[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float4 s = a.state[i];
  if (!(s.w > 0.0f)) {
    a.out[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return;
  }
  const float p[3] = {s.x, s.y, s.z};
  // central differences of TF alpha (central_value_gradient)
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float q[3] = {p[0], p[1], p[2]}, r[3] = {p[0], p[1], p[2]};
    q[k] = p[k] + a.step;
    r[k] = p[k] - a.step;
    g[k] = color_at<kBf16>(a, s_tf, q[0], q[1], q[2]).w
           - color_at<kBf16>(a, s_tf, r[0], r[1], r[2]).w;
    g[k] = g[k] / a.two_step;
  }
  const float len = sqrtf(vpt_nmax(g[0] * g[0] + g[1] * g[1] + g[2] * g[2],
                                   1e-12f));
  const float nx = g[0] / len, ny = g[1] / len, nz = g[2] / len;
  const float lambert = vpt_nmax(nx * a.lx + ny * a.ly + nz * a.lz, 0.0f);
  const float4 c = color_at<kBf16>(a, s_tf, p[0], p[1], p[2]);
  a.out[i] = make_float4(c.x * lambert, c.y * lambert, c.z * lambert, 1.0f);
}

template <bool kBf16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a.tw * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        iso_shade_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  iso_shade_kernel<kBf16><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vpt_iso_shade(
    const void* state, void* out, const void* table, int table_bf16, int d,
    int h, int w, const void* tf_row, int tw, int tf_mode, int width,
    int height, float step, float two_step, float lx, float ly, float lz,
    void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Args a;
  a.state = (const float4*)state;
  a.out = (float4*)out;
  a.table = table;
  a.d = d; a.h = h; a.w = w;
  a.tf_row = (const float4*)tf_row;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.n = width * height;
  a.step = step; a.two_step = two_step;
  a.lx = lx; a.ly = ly; a.lz = lz;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(table_bf16 ? launch<true>(a, st) : launch<false>(a, st));
}
