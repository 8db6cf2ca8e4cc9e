// Corner-row gather (K3): rows of a table by index, alone or fused with the
// trilinear lerp of the fit's forward volume fetch.
//
// Replaces benchmarks/pallas_gather.py:26-69 (make_dma_gather, pallas_call
// at :62), one async DMA per gathered row on the TPU, and inside the fit it
// is the forward of the packed volume fetch of vpt_tpu/sampling.py:480-510
// (sample_volume_packed: the row gather of _take_corner_rows :370-371, then
// _trilerp_chain :424-432).
//
// Bound on the H100: device-memory latency and bytes.  gather_rows moves
// 2 * lanes * 4 bytes per row (2^17 rows of 128 lanes: 128 MiB, ~40 us at
// 3.35 TB/s); corner_fetch reads 52 bytes (index, fractions, a 32-byte row
// at C = 1) and writes 4 per sample, one dependent random row read each.
// Design: gather_rows gives each thread one 16-byte piece of an output row,
// so a warp copies 512 contiguous bytes of a 128-lane row; corner_fetch
// gives each sample one thread that reads its row as float4s and runs the
// lerp chain of the plain version (kernels/corner_gather.py) operation by
// operation, built with -fmad=false, so the result is bit for bit the
// plain one.  Indices outside [0, rows) yield NaN rows instead of a fault.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__global__ void gather_rows_vec4(const float4* __restrict__ table,
                                 long long rows, int vecs,
                                 const long long* __restrict__ idx,
                                 long long n, float4* __restrict__ out) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * vecs) return;
  long long j = e / vecs;
  long long r = idx[j];
  if (r < 0 || r >= rows) {
    out[e] = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    return;
  }
  out[e] = __ldg(table + r * vecs + (e - j * vecs));
}

__global__ void gather_rows_scalar(const float* __restrict__ table,
                                   long long rows, int lanes,
                                   const long long* __restrict__ idx,
                                   long long n, float* __restrict__ out) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * lanes) return;
  long long j = e / lanes;
  long long r = idx[j];
  out[e] = (r < 0 || r >= rows) ? nan_f()
                                : __ldg(table + r * lanes + (e - j * lanes));
}

// One thread per sample: its (8, c) corner row, then the 3-level lerp
// cx = r[2m]*(1-fx) + r[2m+1]*fx, cy = cx[2m]*(1-fy) + cx[2m+1]*fy,
// out = cy0*(1-fz) + cy1*fz per channel.
__global__ void corner_fetch_kernel(const float* __restrict__ table,
                                    long long rows, int c,
                                    const long long* __restrict__ idx,
                                    const float* __restrict__ f, long long n,
                                    float* __restrict__ out) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  long long r = idx[j];
  if (r < 0 || r >= rows) {
    for (int ch = 0; ch < c; ++ch) out[j * c + ch] = nan_f();
    return;
  }
  float fx = f[3 * j], fy = f[3 * j + 1], fz = f[3 * j + 2];
  float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const float* row = table + r * 8 * c;
  for (int ch = 0; ch < c; ++ch) {
    float v[8];
    if (c == 1) {
      float4 a = __ldg((const float4*)row);
      float4 b = __ldg((const float4*)row + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(row + k * c + ch);
    }
    float cx0 = v[0] * gx + v[1] * fx;
    float cx1 = v[2] * gx + v[3] * fx;
    float cx2 = v[4] * gx + v[5] * fx;
    float cx3 = v[6] * gx + v[7] * fx;
    float cy0 = cx0 * gy + cx1 * fy;
    float cy1 = cx2 * gy + cx3 * fy;
    out[j * c + ch] = cy0 * gz + cy1 * fz;
  }
}

unsigned blocks_for(long long threads_total, int threads) {
  return (unsigned)((threads_total + threads - 1) / threads);
}

}  // namespace

extern "C" int vpt_gather_rows(const void* table, long long rows, int lanes,
                               const void* idx, long long n, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes % 4 == 0) {
    int vecs = lanes / 4;
    gather_rows_vec4<<<blocks_for(n * vecs, threads), threads, 0, st>>>(
        (const float4*)table, rows, vecs, (const long long*)idx, n,
        (float4*)out);
  } else {
    gather_rows_scalar<<<blocks_for(n * lanes, threads), threads, 0, st>>>(
        (const float*)table, rows, lanes, (const long long*)idx, n,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vpt_corner_fetch(const void* table, long long rows, int c,
                                const void* idx, const void* f, long long n,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  corner_fetch_kernel<<<blocks_for(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)table, rows, c, (const long long*)idx, (const float*)f,
      n, (float*)out);
  return (int)cudaGetLastError();
}
