// Piecewise-linear 1D transfer-function lookup, shared by the standalone
// kernel (tf1d.cu) and the MCM event kernel (mcm_event.cu).
//
// Replaces vpt_tpu/pallas/tf1d.py:74-100 (lookup_1d; body _kernel :47-57,
// _lookup :28-44) and, in the tf_mxu modes, the one-hot matmul of
// vpt_tpu/sampling.py:529-562 (sample_transfer_1d_mxu).  On the TPU the
// table sat in 128-lane register banks and every tap was a lane shuffle per
// bank.  Here the (TW, 4) row lives in shared memory (4 KiB at TW = 256), or
// in L1 behind the read-only cache (the ISO shade kernel, iso_shade.cu), and
// a tap is one float4 load; the lookup is bound by the loads of its value
// and its output, not by the table.
//
// Numerics follow the plain PyTorch version (kernels/tf1d.py) operation by
// operation: u = clip(v*W - 0.5, 0, W-1), i0 = floor(u), i1 = min(i0+1, W-1);
// mode 0 (bilinear): f = u - i0, c0*(1-f) + c1*f; modes 1 and 2 (tf_mxu):
// w_i = clip(1 - |u - i|, 0, 1) for i = i0, i0+1, rounded to bfloat16 in
// mode 2 (round to nearest even, as the cast before JAX's matmul), then
// w0*c0 + w1*c1.  Build with -fmad=false so no product-sum contracts into
// one rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nan_minmax.cuh"

__device__ __forceinline__ float vpt_clip(float x, float lo, float hi) {
  return vpt_nmin(vpt_nmax(x, lo), hi);
}

// Index of the floor of a filter coordinate clipped to [0, hi]: it lies in
// [0, hi] already, and NaN converts to 0 (cvt.rzi), like the plain
// version's int64 conversion followed by a clamp.
__device__ __forceinline__ int vpt_index(float i0f) {
  return __float2int_rz(i0f);
}

// table: (width, 4) float32 rows in shared memory, or with kGlobal in
// global memory, read through the read-only cache; mode as above.
template <bool kGlobal = false>
__device__ __forceinline__ float4 vpt_tf1d_lookup(const float4* table,
                                                 int width, float v,
                                                 int mode) {
  float u = vpt_clip(v * (float)width - 0.5f, 0.0f, (float)(width - 1));
  float i0f = floorf(u);
  int i0 = vpt_index(i0f);
  int i1 = min(i0 + 1, width - 1);
  float4 c0, c1;
  if constexpr (kGlobal) {
    c0 = __ldg(table + i0);
    c1 = __ldg(table + i1);
  } else {
    c0 = table[i0];
    c1 = table[i1];
  }
  if (mode == 0) {
    float f = u - i0f;
    float g = 1.0f - f;
    return make_float4(c0.x * g + c1.x * f, c0.y * g + c1.y * f,
                       c0.z * g + c1.z * f, c0.w * g + c1.w * f);
  }
  float w0 = vpt_clip(1.0f - fabsf(u - i0f), 0.0f, 1.0f);
  float w1 = vpt_clip(1.0f - fabsf(u - (i0f + 1.0f)), 0.0f, 1.0f);
  if (mode == 2) {
    w0 = __bfloat162float(__float2bfloat16_rn(w0));
    w1 = __bfloat162float(__float2bfloat16_rn(w1));
  }
  return make_float4(w0 * c0.x + w1 * c1.x, w0 * c0.y + w1 * c1.y,
                     w0 * c0.z + w1 * c1.z, w0 * c0.w + w1 * c1.w);
}
