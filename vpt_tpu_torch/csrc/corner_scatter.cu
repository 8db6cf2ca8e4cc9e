// Corner-row scatter-add (K4): 8-lane rows added into a table by index,
// alone or as the backward of the fit's fused volume fetch.
//
// Replaces benchmarks/pallas_scatter_bwd.py:41-107 (make_fused_scatter,
// pallas_call at :97): on the TPU a serial DMA read-modify-write of a
// fold-16 128-lane row per update, table[idx>>4, 8*(idx&15)+k] += ct[j,k],
// which is the 8-lane scatter-add into row idx of the (rows*16, 8) view.
// Inside the fit it is the backward of the packed volume fetch,
// vpt_tpu/sampling.py:454-474 (_select_trilerp_bwd: the corner cotangent
// w8(f) (x) ct, scattered into the corner table's gradient).
//
// Bound on the H100: atomic throughput at the L2.  Each update is 8 (C = 1)
// float atomics into one 32-byte row; at 256^3 many photons of a frame hit
// the same entry cells, and atomics on one address serialize.
// Design: no fold; one thread per (update, corner lane), so the 8 atomics
// of an update fall on one 32-byte sector and a warp covers 4 updates;
// corner_grad forms the trilinear weight of its lane in registers, in
// _select_trilerp_bwd's product order ((wz*wy)*wx, then * ct), so the
// (N, 8C) cotangent never reaches device memory.  Offsets are int64.
// Indices outside the table are skipped.  Atomics add in a varying order,
// so sums agree with the plain version to rounding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows8_kernel(float* __restrict__ table,
                                         long long rows8,
                                         const long long* __restrict__ idx,
                                         const float* __restrict__ ct,
                                         long long n) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * 8) return;
  long long r = idx[e >> 3];
  if (r < 0 || r >= rows8) return;
  atomicAdd(table + r * 8 + (e & 7), ct[e]);
}

__global__ void corner_grad_kernel(float* __restrict__ grad, long long rows,
                                   int c, const long long* __restrict__ idx,
                                   const float* __restrict__ f,
                                   const float* __restrict__ ct,
                                   long long n) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * 8) return;
  long long j = e >> 3;
  int k = (int)(e & 7);  // corner (z, y, x), x minor
  long long r = idx[j];
  if (r < 0 || r >= rows) return;
  float fx = f[3 * j], fy = f[3 * j + 1], fz = f[3 * j + 2];
  float wx = (k & 1) ? fx : 1.0f - fx;
  float wy = (k & 2) ? fy : 1.0f - fy;
  float wz = (k & 4) ? fz : 1.0f - fz;
  float w = (wz * wy) * wx;
  float* dst = grad + (r * 8 + k) * c;
  for (int ch = 0; ch < c; ++ch) atomicAdd(dst + ch, w * ct[j * c + ch]);
}

unsigned blocks_for(long long threads_total, int threads) {
  return (unsigned)((threads_total + threads - 1) / threads);
}

}  // namespace

extern "C" int vpt_scatter_add_rows8(void* table, long long rows8,
                                     const void* idx, const void* ct,
                                     long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  scatter_add_rows8_kernel<<<blocks_for(n * 8, threads), threads, 0,
                             (cudaStream_t)stream>>>(
      (float*)table, rows8, (const long long*)idx, (const float*)ct, n);
  return (int)cudaGetLastError();
}

extern "C" int vpt_corner_grad(void* grad, long long rows, int c,
                               const void* idx, const void* f, const void* ct,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  corner_grad_kernel<<<blocks_for(n * 8, threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (float*)grad, rows, c, (const long long*)idx, (const float*)f,
      (const float*)ct, n);
  return (int)cudaGetLastError();
}
