// Piecewise-linear 1D transfer-function lookup, shared by the standalone
// kernel (tf1d.cu) and the MCM event kernel (mcm_event.cu).
//
// Replaces vpt_tpu/pallas/tf1d.py:74-100 (lookup_1d; body _kernel :47-57,
// _lookup :28-44).  On the TPU the table sat in 128-lane register banks and
// every tap was a lane shuffle per bank.  Here the (TW, 4) row lives in
// shared memory (4 KiB at TW = 256) and a tap is one float4 load; the lookup
// is bound by the loads of its value and its output, not by the table.
//
// Numerics follow the plain PyTorch version (kernels/tf1d.py) operation by
// operation: u = clip(v*W - 0.5, 0, W-1), i0 = floor(u), f = u - i0,
// i1 = min(i0+1, W-1), c0*(1-f) + c1*f.  Build with -fmad=false so no
// product-sum contracts into one rounding.
#pragma once

#include <cuda_runtime.h>

#include "nan_minmax.cuh"

__device__ __forceinline__ float vpt_clip(float x, float lo, float hi) {
  return vpt_nmin(vpt_nmax(x, lo), hi);
}

// Index of a clipped filter coordinate, clamped to [0, hi]; NaN maps to 0
// like the plain version's int64 conversion followed by a clamp.
__device__ __forceinline__ int vpt_index(float i0f, int hi) {
  int i = (i0f == i0f) ? (int)i0f : 0;
  return min(max(i, 0), hi);
}

// table: (width, 4) float32 rows in shared memory.
__device__ __forceinline__ float4 vpt_tf1d_lookup(const float4* table,
                                                 int width, float v) {
  float u = vpt_clip(v * (float)width - 0.5f, 0.0f, (float)(width - 1));
  float i0f = floorf(u);
  float f = u - i0f;
  int i0 = vpt_index(i0f, width - 1);
  int i1 = min(i0 + 1, width - 1);
  float4 c0 = table[i0];
  float4 c1 = table[i1];
  float g = 1.0f - f;
  return make_float4(c0.x * g + c1.x * f, c0.y * g + c1.y * f,
                     c0.z * g + c1.z * f, c0.w * g + c1.w * f);
}
