// Standalone 1D transfer-function lookup: values (n,) -> RGBA (n, 4).
//
// Replaces vpt_tpu/pallas/tf1d.py:74-100 (lookup_1d).
// Bound on the H100: device-memory bytes, 4 read and 16 written per value
// (at 512^2 values 5.24 MB, 1.6 us at 3.35 TB/s); the (TW, 4) row is read
// once per block from L2.
// Design: a grid of at most as many blocks as the card holds at once (SMs x
// resident blocks, from vpt_tf1d_info, in the table's prepared launch
// arguments), so each block stages the row into shared memory once, with
// float4 copies, and then walks the values in a grid-stride loop.  A warp
// takes 128 values a step: one float4 load a lane (512 contiguous bytes),
// parked in the warp's slice of shared memory, then four lookups a lane at
// values lane, lane + 32, ..., so that each of the warp's four float4
// stores writes 512 contiguous bytes of the output.  Values before the first 16-byte boundary (an unaligned
// view) and after the last whole 128 are looked up one a thread.  The
// arithmetic is vpt_tf1d_lookup (tf1d.cuh), unchanged, in all three modes.
// At 512^2 the card takes less time than the host's launch, so what comes
// from the table is prepared once per table and passed as one pointer.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "tf1d.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;                        // values a warp step
constexpr int kStaticSmem = kWarps * kChunk * 4;   // the warps' value slices
constexpr int kDefaultSmem = 48 * 1024;            // without an opt-in

__global__ void __launch_bounds__(kThreads)
tf1d_kernel(const float4* __restrict__ table, int width, int mode,
            const float* __restrict__ values, float4* __restrict__ out,
            long long n, long long head, long long chunks) {
  extern __shared__ float4 s_table[];
  __shared__ __align__(16) float s_values[kWarps][kChunk];
  for (int i = threadIdx.x; i < width; i += kThreads) s_table[i] = table[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* slice = s_values[threadIdx.x >> 5];
  const float4* body = reinterpret_cast<const float4*>(values + head);
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       k < chunks; k += warps) {
    reinterpret_cast<float4*>(slice)[lane] = __ldg(body + k * 32 + lane);
    __syncwarp();
    float4* dst = out + head + k * kChunk + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[32 * j] = vpt_tf1d_lookup(s_table, width, slice[32 * j + lane],
                                    mode);
    __syncwarp();
  }

  // the head before the 16-byte boundary, then the tail after the chunks
  const long long tail = head + chunks * kChunk;
  const long long rest = head + (n - tail);
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < rest; r += (long long)gridDim.x * kThreads) {
    long long i = r < head ? r : tail + (r - head);
    out[i] = vpt_tf1d_lookup(s_table, width, __ldg(values + i), mode);
  }
}

size_t dynamic_smem(int width) { return (size_t)width * sizeof(float4); }

// Rows above 44 KiB need the opt-in beside the static value slices.
cudaError_t opt_in(int width) {
  size_t smem = dynamic_smem(width);
  if (smem + kStaticSmem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(tf1d_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// What a launch needs of the table, filled once per table by the wrapper
// (kernels/tf1d.py, a ctypes Structure of this layout), so that a call
// passes one pointer for it.
struct VptTf1dTable {
  const float4* table;  // (width, 4) float32, 16-byte aligned
  int width;
  int mode;             // tf1d.cuh
  int max_blocks;       // SMs x resident blocks: the grid's cap
  int device;
};

// out: threads a block, resident blocks an SM, SMs, static and dynamic
// shared bytes a block, for a row of `width` texels on `device`.
extern "C" int vpt_tf1d_info(int width, int device, int* out) {
  VptDeviceGuard guard(device);
  cudaError_t err = opt_in(width);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tf1d_kernel, kThreads, dynamic_smem(width));
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = blocks;
  out[2] = sms;
  out[3] = kStaticSmem;
  out[4] = (int)dynamic_smem(width);
  return 0;
}

// prepared: a VptTf1dTable; values (n,) float32; out (n, 4) float32.
extern "C" int vpt_tf1d_lookup(const void* prepared, const void* values,
                               void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const VptTf1dTable& t = *static_cast<const VptTf1dTable*>(prepared);
  VptDeviceGuard guard(t.device);
  cudaError_t err = opt_in(t.width);
  if (err != cudaSuccess) return (int)err;
  // values before the first 16-byte boundary of the view
  long long head = (long long)((16 - (uintptr_t)values % 16) % 16) / 4;
  if (head > n) head = n;
  const long long chunks = (n - head) / kChunk;
  long long want = (chunks + kWarps - 1) / kWarps;
  if (want < 1) want = 1;
  const unsigned blocks =
      (unsigned)(want < t.max_blocks ? want : t.max_blocks);
  tf1d_kernel<<<blocks, kThreads, dynamic_smem(t.width),
                (cudaStream_t)stream>>>(
      t.table, t.width, t.mode, (const float*)values, (float4*)out, n, head,
      chunks);
  return (int)cudaGetLastError();
}
