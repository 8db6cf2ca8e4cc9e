// Display pass: tone curve, exposure, gamma and alpha fill over an (H, W, 4)
// float32 image.
//
// Replaces vpt_tpu/pallas/tonemap_kernel.py:34-61 (tonemap; _kernel :25-31):
// out = pow(max(curve(x * exposure), 0), inv_gamma) per channel, alpha = 1,
// for the eight RAW_CURVES of tonemap.py.
// Bound on the H100: device memory, 16 bytes read and 16 written per pixel
// with a few dozen flops between them.  Design: one thread per pixel, one
// float4 load and one float4 store, so a warp moves 512 contiguous bytes
// each way; the curve is picked by an integer id that is uniform across the
// launch, so the switch never diverges.
//
// Constants are the float32 values the JAX package and the plain PyTorch
// version use: Python-double expressions rounded once to float32.  Lottes's
// b and c (powers of doubles) and Uncharted2's white scale (evaluated in
// float32) come from the host as k0 and k1.  Build with -fmad=false.
#include <cuda_runtime.h>

#include "nan_minmax.cuh"

namespace {

enum Curve {
  REINHARD = 0, REINHARD2, UNCHARTED2, FILMIC, UNREAL, ACES, LOTTES, UCHIMURA
};

__device__ __forceinline__ float uncharted2_curve(float x) {
  const float a = 0.15f, b = 0.50f;
  const float cb = (float)(0.10 * 0.50), de = (float)(0.20 * 0.02);
  const float df = (float)(0.20 * 0.30), ef = (float)(0.02 / 0.30);
  return ((x * (a * x + cb) + de) / (x * (a * x + b) + df)) - ef;
}

__device__ __forceinline__ float curve(int id, float x, float k0, float k1) {
  switch (id) {
    case REINHARD:
      return x / (1.0f + x);
    case REINHARD2:
      return (x * (1.0f + x / 16.0f)) / (1.0f + x);
    case UNCHARTED2:
      return uncharted2_curve(2.0f * x) / k0;
    case FILMIC: {
      x = vpt_nmax(0.0f, x - 0.004f);
      float r = (x * (6.2f * x + 0.5f)) / (x * (6.2f * x + 1.7f) + 0.06f);
      return powf(r, 2.2f);
    }
    case UNREAL:
      return x / (x + 0.155f) * 1.019f;
    case ACES: {
      float r = (x * (2.51f * x + 0.03f)) / (x * (2.43f * x + 0.59f) + 0.14f);
      return vpt_nmin(vpt_nmax(r, 0.0f), 1.0f);
    }
    case LOTTES:
      x = vpt_nmax(x, 0.0f);
      return powf(x, 1.6f) / (powf(x, (float)(1.6 * 0.977)) * k0 + k1);
    default: {  // UCHIMURA: P=1, a=1, m=0.22, l=0.4, c=1.33, b=0
      const double p = 1.0, a = 1.0, m = 0.22, l = 0.4;
      const double l0 = ((p - m) * l) / a;
      const double s0 = m + l0, s1 = m + a * l0;
      const double c2 = (a * p) / (p - s1), cp = -c2 / p;
      x = vpt_nmax(x, 0.0f);
      float t = vpt_nmin(vpt_nmax((x - 0.0f) / (float)m, 0.0f), 1.0f);
      float w0 = 1.0f - t * t * (3.0f - 2.0f * t);
      float w2 = (x >= (float)(m + l0)) ? 1.0f : 0.0f;
      float w1 = 1.0f - w0 - w2;
      float tt = (float)m * powf(x / (float)m, 1.33f) + 0.0f;
      float s = 1.0f - (float)(p - s1) * expf((float)cp * (x - (float)s0));
      float lin = (float)m + 1.0f * (x - (float)m);
      return tt * w0 + lin * w1 + s * w2;
    }
  }
}

__global__ void tonemap_kernel(const float4* __restrict__ in,
                               float4* __restrict__ out, long long n, int id,
                               float exposure, float inv_gamma, float k0,
                               float k1) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 v = in[i];
  float4 r;
  r.x = powf(vpt_nmax(curve(id, v.x * exposure, k0, k1), 0.0f), inv_gamma);
  r.y = powf(vpt_nmax(curve(id, v.y * exposure, k0, k1), 0.0f), inv_gamma);
  r.z = powf(vpt_nmax(curve(id, v.z * exposure, k0, k1), 0.0f), inv_gamma);
  r.w = 1.0f;
  out[i] = r;
}

}  // namespace

extern "C" int vpt_tonemap(const void* in, void* out, long long n_pixels,
                           int curve_id, float exposure, float inv_gamma,
                           float k0, float k1, void* stream) {
  if (n_pixels <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_pixels + threads - 1) / threads;
  tonemap_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)in, (float4*)out, n_pixels, curve_id, exposure,
      inv_gamma, k0, k1);
  return (int)cudaGetLastError();
}
