// Standalone 1D transfer-function lookup: values (n,) -> RGBA (n, 4).
//
// Replaces vpt_tpu/pallas/tf1d.py:74-100 (lookup_1d).
// Bound on the H100: device-memory traffic, 4 bytes read and 16 written per
// value; the table itself is read once per block into shared memory.
// Design: one thread per value, the (TW, 4) row staged in dynamic shared
// memory (TW * 16 bytes; the wrapper refuses rows above the 48 KiB default
// cap), the output written as one float4 per thread so that a warp stores
// 512 contiguous bytes.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf1d.cuh"

namespace {

__global__ void tf1d_kernel(const float4* __restrict__ table, int width,
                            const float* __restrict__ values,
                            float4* __restrict__ out, long long n) {
  extern __shared__ float4 s_table[];
  for (int i = threadIdx.x; i < width; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = vpt_tf1d_lookup(s_table, width, values[i]);
}

}  // namespace

extern "C" int vpt_tf1d_lookup(const void* table, int width,
                               const void* values, void* out, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  size_t smem = (size_t)width * sizeof(float4);
  tf1d_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float4*)table, width, (const float*)values, (float4*)out, n);
  return (int)cudaGetLastError();
}
