// min/max that return NaN when either operand is NaN, as jnp.minimum and
// torch.minimum do (CUDA's fminf/fmaxf return the other operand).  Shared
// by every kernel in this directory.
//
// One instruction each: PTX min/max with .NaN (sm_80 and later) return the
// canonical NaN 0x7fffffff when an operand is NaN, and are otherwise the
// same instruction as fminf/fmaxf.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float vpt_nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float vpt_nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
