// min/max that return NaN when either operand is NaN, as jnp.minimum and
// torch.minimum do (CUDA's fminf/fmaxf return the other operand).  Shared
// by every kernel in this directory.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float vpt_nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float vpt_nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
