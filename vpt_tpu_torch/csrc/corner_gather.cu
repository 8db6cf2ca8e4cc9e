// Corner-row gather (K3): rows of a table by index (the probe), and the
// fit's volume fetch, which takes positions and computes the cells itself.
//
// Replaces benchmarks/pallas_gather.py:26-69 (make_dma_gather, pallas_call
// at :62), one async DMA per gathered row on the TPU, and inside the fit it
// is the packed volume fetch of vpt_tpu/sampling.py:480-510
// (sample_volume_packed: the filter coordinates and cell :493-502, the row
// gather of _take_corner_rows :370-371, then _trilerp_chain :424-432).
//
// Bound on the H100: device-memory bytes and the latency of one random row
// read.  gather_rows moves 2 * lanes * 4 bytes per row (2^17 rows of 128
// lanes: 128 MiB, ~40 us at 3.35 TB/s).  corner_fetch reads 12 bytes of
// position and writes 4 * C of value per sample, plus 20 when it saves the
// cell and fractions, and reads each distinct corner row once (32 bytes at
// C = 1 in float32, 16 in bfloat16).
// Design: gather_rows gives each thread one 16-byte piece of an output row,
// so a warp copies 512 contiguous bytes of a 128-lane row.  corner_fetch
// gives each sample one thread, which computes the filter coordinate, cell
// and fractions in registers with the float32 operations of the plain
// version (kernels/corner_gather.py, sampling._filter_coords and
// _clamp_index) in their order, so the only dependent memory read is the
// row: two float4 in float32, one 16-byte vector of bfloat16 widened
// exactly for C = 1, one value a corner and channel for C > 1.  Then the
// lerp chain of the plain version operation by operation, built with
// -fmad=false, so the value is bit for bit the plain one.  A NaN
// coordinate takes cell index 0 on its axis and a NaN fraction, as the
// plain version does, so the value is NaN.
//
// The slab instance (vpt_slab_fetch) is the masked fetch of a spatially
// sharded volume (vpt_tpu/parallel/halo.py:143-166, _trilinear_packed):
// slab.cuh's slab-local cell (contiguous or interleaved thin slabs), a read
// only where this rank owns the cell, 0 and the saved cell -1 elsewhere;
// unmasked, every position reads its slab-local row.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "slab.cuh"
#include "tf1d.cuh"

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

// bfloat16 bits -> float32, exact
__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ float load(const float* row, int k) {
  return __ldg(row + k);
}

__device__ __forceinline__ float load(const uint16_t* row, int k) {
  return widen(__ldg(row + k));
}

// The 8 corners of a C = 1 row.
__device__ __forceinline__ void load_row1(const float* row, float v[8]) {
  float4 a = __ldg(reinterpret_cast<const float4*>(row));
  float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_row1(const uint16_t* row, float v[8]) {
  uint4 q = __ldg(reinterpret_cast<const uint4*>(row));
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(words[k] << 16);       // the lower address
    v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

// One thread per sample: the filter coordinate u = clip(p * dim - 0.5, 0,
// dim - 1), i0 = floor(u), f = u - i0 and the clamped index on each axis,
// the cell (z * h + y) * w + x, its (8, c) corner row, then the 3-level lerp
// cx = r[2m]*(1-fx) + r[2m+1]*fx, cy = cx[2m]*(1-fy) + cx[2m+1]*fy,
// out = cy0*(1-fz) + cy1*fz per channel.
template <typename T, bool kOneChannel>
__global__ void corner_fetch_kernel(const T* __restrict__ table, int c,
                                    int w, int h, int d,
                                    const float* __restrict__ position,
                                    long long n, float* __restrict__ out,
                                    long long* __restrict__ cells,
                                    float* __restrict__ fractions) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int dims[3] = {w, h, d};
  float f[3];
  int i[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dim = (float)dims[a];
    float u = vpt_clip(__ldg(position + 3 * j + a) * dim - 0.5f, 0.0f,
                       dim - 1.0f);
    float i0f = floorf(u);
    f[a] = u - i0f;
    i[a] = vpt_index(i0f);
  }
  const long long cell = ((long long)i[2] * h + i[1]) * w + i[0];
  if (cells != nullptr) {
    cells[j] = cell;
#pragma unroll
    for (int a = 0; a < 3; ++a) fractions[3 * j + a] = f[a];
  }
  const float fx = f[0], fy = f[1], fz = f[2];
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const T* row = table + cell * 8 * c;
  for (int ch = 0; ch < (kOneChannel ? 1 : c); ++ch) {
    float v[8];
    if (kOneChannel) {
      load_row1(row, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = load(row, k * c + ch);
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

// The slab instance (parallel/halo.py, the sharded gradient's forward):
// the table is this rank's slab of the corner table, (slab rows, 8 * c) for
// a volume of d planes (slab.cuh's VptSlab), and a sample's cell and
// ownership come from vpt_slab_cell.  Masked, a sample whose cell another
// rank owns is 0 (no read) and saves the cell -1, which the corner scatter
// (K4) skips; otherwise the value, cell and fractions are
// corner_fetch_kernel's over the slab's rows, so the sum over the ranks of
// their masked values is the whole table's value bit for bit.  Unmasked
// (slab.masked 0), every sample reads its slab-local row.
template <typename T, bool kOneChannel>
__global__ void slab_fetch_kernel(const T* __restrict__ table, int c, int w,
                                  int h, int d, VptSlab slab,
                                  const float* __restrict__ position,
                                  long long n, float* __restrict__ out,
                                  long long* __restrict__ cells,
                                  float* __restrict__ fractions) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const VptSlabCell sc = vpt_slab_cell(
      d, h, w, slab, __ldg(position + 3 * j), __ldg(position + 3 * j + 1),
      __ldg(position + 3 * j + 2));
  if (cells != nullptr) {
    cells[j] = sc.local ? (long long)sc.row : -1;
    fractions[3 * j] = sc.fx;
    fractions[3 * j + 1] = sc.fy;
    fractions[3 * j + 2] = sc.fz;
  }
  if (!sc.local) {
    for (int ch = 0; ch < c; ++ch) out[j * c + ch] = 0.0f;
    return;
  }
  const float fx = sc.fx, fy = sc.fy, fz = sc.fz;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const T* row = table + sc.row * 8 * c;
  for (int ch = 0; ch < (kOneChannel ? 1 : c); ++ch) {
    float v[8];
    if (kOneChannel) {
      load_row1(row, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = load(row, k * c + ch);
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

template <typename T>
void launch_fetch(const void* table, int c, int w, int h, int d,
                  const void* position, long long n, void* out, void* cells,
                  void* fractions, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = blocks_for(n, threads);
  if (c == 1) {
    corner_fetch_kernel<T, true><<<blocks, threads, 0, stream>>>(
        (const T*)table, c, w, h, d, (const float*)position, n, (float*)out,
        (long long*)cells, (float*)fractions);
  } else {
    corner_fetch_kernel<T, false><<<blocks, threads, 0, stream>>>(
        (const T*)table, c, w, h, d, (const float*)position, n, (float*)out,
        (long long*)cells, (float*)fractions);
  }
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

// What a fetch needs of the corner table, filled once per table by the
// wrapper (kernels/corner_gather.py, a ctypes Structure of this layout), so
// that a call passes one pointer for it.
struct VptCornerTable {
  const void* table;  // (w * h * d, 8 * c), 16-byte aligned
  int bf16;           // 1: bfloat16 rows, 0: float32
  int c, w, h, d;
  int device;
};

// prepared: a VptCornerTable; position (n, 3) float32; out (n, c) float32;
// cells (n,) int64 and fractions (n, 3) float32 are written when cells is
// not null.
extern "C" int vpt_corner_fetch(const void* prepared, const void* position,
                                long long n, void* out, void* cells,
                                void* fractions, void* stream) {
  if (n <= 0) return 0;
  const VptCornerTable& t = *static_cast<const VptCornerTable*>(prepared);
  VptDeviceGuard guard(t.device);
  if (t.bf16) {
    launch_fetch<uint16_t>(t.table, t.c, t.w, t.h, t.d, position, n, out,
                           cells, fractions, (cudaStream_t)stream);
  } else {
    launch_fetch<float>(t.table, t.c, t.w, t.h, t.d, position, n, out, cells,
                        fractions, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// The slab instance: prepared is a VptCornerTable of the slab's table (its
// d the slab's planes), d the whole volume's planes and the slab (index,
// count, thin slabs a rank, masked) as in slab_fetch_kernel; the rest as
// vpt_corner_fetch's.
extern "C" int vpt_slab_fetch(const void* prepared, int d, int slab_index,
                              int num_slabs, int interleave, int masked,
                              const void* position, long long n, void* out,
                              void* cells, void* fractions, void* stream) {
  if (n <= 0) return 0;
  if (num_slabs < 1 || interleave < 1 || slab_index < 0
      || slab_index >= num_slabs || d % (num_slabs * interleave) != 0)
    return (int)cudaErrorInvalidValue;
  const VptCornerTable& t = *static_cast<const VptCornerTable*>(prepared);
  VptDeviceGuard guard(t.device);
  const VptSlab slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
  const int threads = 256;
  const unsigned blocks = blocks_for(n, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const float* pos = (const float*)position;
  float* o = (float*)out;
  long long* cl = (long long*)cells;
  float* fr = (float*)fractions;
  if (t.bf16) {
    const uint16_t* tab = (const uint16_t*)t.table;
    if (t.c == 1)
      slab_fetch_kernel<uint16_t, true><<<blocks, threads, 0, st>>>(
          tab, t.c, t.w, t.h, d, slab, pos, n, o, cl, fr);
    else
      slab_fetch_kernel<uint16_t, false><<<blocks, threads, 0, st>>>(
          tab, t.c, t.w, t.h, d, slab, pos, n, o, cl, fr);
  } else {
    const float* tab = (const float*)t.table;
    if (t.c == 1)
      slab_fetch_kernel<float, true><<<blocks, threads, 0, st>>>(
          tab, t.c, t.w, t.h, d, slab, pos, n, o, cl, fr);
    else
      slab_fetch_kernel<float, false><<<blocks, threads, 0, st>>>(
          tab, t.c, t.w, t.h, d, slab, pos, n, o, cl, fr);
  }
  return (int)cudaGetLastError();
}
