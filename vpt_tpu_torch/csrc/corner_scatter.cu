// Corner-row scatter-add (K4): 8-lane rows added into a table by index,
// alone or as the backward of the fit's fused volume fetch.
//
// Replaces benchmarks/pallas_scatter_bwd.py:41-107 (make_fused_scatter,
// pallas_call at :97): on the TPU a serial DMA read-modify-write of a
// fold-16 128-lane row per update, table[idx>>4, 8*(idx&15)+k] += ct[j,k],
// which is the 8-lane scatter-add into row idx of the (rows*16, 8) view.
// Inside the fit it is the backward of the packed volume fetch,
// vpt_tpu/sampling.py:454-474 (_select_trilerp_bwd: the corner cotangent
// w8(f) (x) ct, scattered into the corner table's gradient), and under the
// bucketed transpose one scatter-add a z bucket
// (vpt_tpu/parallel/overlap.py:40-52, vpt_tpu/parallel/halo_grad.py:17-21).
//
// Bound on the H100: the bytes, every entry's 8-byte cell read once, the
// in-range entries' fractions and cotangents (12 + 4C bytes) once and the
// dense (rows, 8C) gradient filled and written once, at 3.35 TB/s; and the
// L2's atomic rate on a contended row.  A fit's entries crowd: the
// fetches save them in (slice, H, W) order with W minor, about four
// neighbouring pixels of an image row share a cell at 64^3 seen at 256^2,
// and a bucketed EAM step's bucket 0 holds ~100 entries a row.  One
// float atomic a lane and entry (the design before this one) put ~100
// atomics on each word; same-address atomics serialise at the L2, so
// 53.6 M of them took 0.82 ms against 0.07 ms of bytes (PERF.md §6).
// Design: corner_grad sums on the SM before the L2.  A block of 128
// threads owns a chunk of consecutive entries, 4 a thread (512, two image
// rows of one slice at 256^2) or fewer where that leaves resident blocks
// idle (a call of n entries: ceil(n / (resident blocks x 128)) a thread),
// then the next chunk in a grid-stride loop over a grid of the blocks the
// card holds at once.  Each thread reads its entries' cells, then the
// in-range entries' fractions and cotangents, all loads in flight at once
// (a warp whose 32 entries all fall outside [r0, r0 + rows) reads no
// fraction or cotangent).  An in-range entry forms its 8 trilinear
// weights in registers in _select_trilerp_bwd's product order
// ((wz*wy)*wx, then * ct), so the (N, 8C) cotangent never reaches device
// memory.  The warp's entries of one row are summed into the row's lowest
// lane first (__match_any_sync, then log2 shuffle steps): the fits clamp
// positions outside the volume to its edge cells, so a row can take
// 235 295 entries of a bucket and whole warps and chunks hit one row, and
// shared float atomics (a compare-and-swap loop on sm_90) from 32 lanes on
// one word serialise on the SM as the L2's do.  That lane finds its row's
// slot in an open-addressed table of kSlots = 256 rows in shared memory (a
// multiplicative hash, linear probing; an empty slot is claimed with
// atomicCAS on its key) and adds the row's 8C lanes with shared float
// atomics.  A row that finds no slot within kProbes = 8 probes goes
// straight to the gradient, two float4 atomics a row at C = 1 (four at
// C = 2).  At the chunk's end each occupied slot goes to the gradient as
// float4 atomics (red.global.add.v4.f32 on sm_90) and is cleared while the
// next chunk's loads are in flight.  Chunk and table size: the counts
// (chip_smoke.entry_counts) give a bucketed EAM step's heavy buckets 39.5
// distinct rows a 256 entries (p99 93) and 132 a 2048 (p99 493), so 512
// entries fill about a third of 256 slots; timed in turns on the H100
// (PERF.md §6), 2048-entry chunks with 512 slots took 0.26 ms on
// bucket 0 with the warp sum and 0.79 without it, 1024 with 512 0.21, and
// 512 with 256 0.17: smaller chunks and tables keep more blocks on an SM
// (40 / 48 registers and 10 / 18 KB of shared memory at C = 1 / 2: 12 / 10
// blocks of 128) with fewer rows to flush a chunk.  A slot's lanes are
// padded to 8C + 1 floats, so distinct rows of a warp spread over the
// banks.  Partial sums change the order of each sum, which the float32
// reordering bound covers; atomics add in a varying order, so sums agree
// with the plain version to rounding, not bit for bit.  Offsets are int64;
// a cell outside the range (another bucket's, -1 for a masked sample, or
// past the table) adds nothing.
//
// The bucket instance (vpt_corner_grad with r0 > 0 or fewer rows than the
// table) is the same kernel with a row offset: the gradient of rows
// [r0, r0 + rows) of the table, from every saved entry of a bucketed fit
// step (sampling.BucketedTable), launched once a z bucket.  Every entry's
// cell is read once a bucket; the entries of other buckets cost that
// 8-byte read alone.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kSlotBits = 8;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kProbes = 8;
constexpr unsigned kEmpty = 0xffffffffu;

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

// One row's 8C lanes added to the gradient, a float4 atomic each 4 lanes.
template <int C>
__device__ __forceinline__ void add_row(float* grad, long long r,
                                        const float* v) {
  float4* dst = reinterpret_cast<float4*>(grad + r * 8 * C);
#pragma unroll
  for (int q = 0; q < 2 * C; ++q) {
    atomicAdd(dst + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                   v[4 * q + 3]));
  }
}

// The slot of relative row `key` in the block's table, claimed if it was
// empty; -1 when kProbes slots hold other rows.
__device__ __forceinline__ int find_slot(unsigned* keys, unsigned key) {
  const unsigned h = (key * 0x9e3779b9u) >> (32 - kSlotBits);
#pragma unroll 1
  for (int p = 0; p < kProbes; ++p) {
    const unsigned s = (h + p) & (kSlots - 1);
    const unsigned k = *reinterpret_cast<volatile unsigned*>(keys + s);
    if (k == key) return (int)s;
    if (k == kEmpty) {
      const unsigned old = atomicCAS(keys + s, kEmpty, key);
      if (old == kEmpty || old == key) return (int)s;
    }
  }
  return -1;
}

// Sums v over the lanes of the warp that hold the same key (`peers`, from
// __match_any_sync) into the group's lowest lane, in log2 steps: a lane
// adds its next remaining peer's partial sum, then the lanes at an odd rank
// of the remaining ones drop out.  Every lane of the warp takes part.
template <int N>
__device__ __forceinline__ void sum_peers(unsigned peers, float* v) {
  const unsigned lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned up = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, up != 0u)) {
    const int next = __ffs(up);
    const int from = next ? next - 1 : (int)lane;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float t = __shfl_sync(0xffffffffu, v[q], from);
      if (next) v[q] += t;
    }
    up &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
corner_grad_kernel(float* __restrict__ grad, long long r0, long long rows,
                   const long long* __restrict__ idx,
                   const float* __restrict__ f,
                   const float* __restrict__ ct, long long n, int per) {
  constexpr int kStride = 8 * C + 1;
  __shared__ unsigned keys[kSlots];
  __shared__ float vals[kSlots * kStride];
  for (int s = threadIdx.x; s < kSlots; s += kThreads) keys[s] = kEmpty;
  for (int i = threadIdx.x; i < kSlots * kStride; i += kThreads) {
    vals[i] = 0.0f;
  }
  const int chunk = per * kThreads;
  for (long long base = (long long)blockIdx.x * chunk; base < n;
       base += (long long)gridDim.x * chunk) {
    // the chunk's cells, then the in-range entries' fractions and
    // cotangents, all loads in flight at once
    unsigned key[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long j = base + i * kThreads + threadIdx.x;
      const long long r = i < per && j < n ? __ldg(idx + j) - r0 : -1;
      key[i] = r >= 0 && r < rows ? (unsigned)r : kEmpty;
    }
    float fx[kPerThread], fy[kPerThread], fz[kPerThread], c[kPerThread][C];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long j = base + i * kThreads + threadIdx.x;
      const bool in = key[i] != kEmpty;
      fx[i] = in ? __ldg(f + 3 * j) : 0.0f;
      fy[i] = in ? __ldg(f + 3 * j + 1) : 0.0f;
      fz[i] = in ? __ldg(f + 3 * j + 2) : 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        c[i][ch] = in ? __ldg(ct + j * C + ch) : 0.0f;
      }
    }
    // the table is clear (its init, or the last chunk's flush) before the
    // first insert; the loads above are in flight meanwhile
    __syncthreads();
    int held = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (!__any_sync(0xffffffffu, key[i] != kEmpty)) continue;
      held = 1;
      // an entry outside the range adds zeros to its own group, untouched
      float v[8 * C];
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // corner (z, y, x), x minor
        const float wx = (k & 1) ? fx[i] : 1.0f - fx[i];
        const float wy = (k & 2) ? fy[i] : 1.0f - fy[i];
        const float wz = (k & 4) ? fz[i] : 1.0f - fz[i];
        const float w = (wz * wy) * wx;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[k * C + ch] = w * c[i][ch];
      }
      // the warp's entries of one row summed into its lowest lane first
      const unsigned peers = __match_any_sync(0xffffffffu, key[i]);
      sum_peers<8 * C>(peers, v);
      if (key[i] == kEmpty
          || (threadIdx.x & 31) != (unsigned)(__ffs(peers) - 1)) {
        continue;
      }
      const int s = find_slot(keys, key[i]);
      if (s < 0) {
        add_row<C>(grad, (long long)key[i], v);
        continue;
      }
      float* dst = vals + s * kStride;
#pragma unroll
      for (int q = 0; q < 8 * C; ++q) atomicAdd(dst + q, v[q]);
    }
    if (!__syncthreads_or(held)) continue;
    // the chunk's rows, each in one vector add a 4 lanes
    for (int s = threadIdx.x; s < kSlots; s += kThreads) {
      const unsigned row = keys[s];
      if (row == kEmpty) continue;
      float* src = vals + s * kStride;
      float v[8 * C];
#pragma unroll
      for (int q = 0; q < 8 * C; ++q) {
        v[q] = src[q];
        src[q] = 0.0f;
      }
      add_row<C>(grad, (long long)row, v);
      keys[s] = kEmpty;
    }
  }
}

template <int C>
int corner_grad_launch(float* grad, long long r0, long long rows,
                       const long long* idx, const float* f, const float* ct,
                       long long n, cudaStream_t stream) {
  // the blocks the card holds at once (the same on every call)
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, corner_grad_kernel<C>, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  // entries a thread holds a chunk: as many as fill every resident block
  // once, at most kPerThread
  const long long spread = (n + (long long)resident * kThreads - 1)
                           / ((long long)resident * kThreads);
  const int per = (int)(spread < kPerThread ? spread : kPerThread);
  const long long chunks = (n + per * kThreads - 1) / (per * kThreads);
  const unsigned blocks =
      (unsigned)(chunks < resident ? chunks : (long long)resident);
  corner_grad_kernel<C><<<blocks, kThreads, 0, stream>>>(grad, r0, rows, idx,
                                                         f, ct, n, per);
  return (int)cudaGetLastError();
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

// The gradient of rows [r0, r0 + rows) of the table (r0 = 0 and the
// table's rows: the whole gradient) into the zeroed (rows, 8c) float32
// grad; c is 1 or 2, rows below 2^32 - 1.
extern "C" int vpt_corner_grad(void* grad, long long r0, long long rows,
                               int c, const void* idx, const void* f,
                               const void* ct, long long n, void* stream) {
  if (c < 1 || c > 2 || rows < 0 || rows >= (long long)kEmpty) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || rows == 0) return 0;
  if (c == 1) {
    return corner_grad_launch<1>((float*)grad, r0, rows,
                                 (const long long*)idx, (const float*)f,
                                 (const float*)ct, n, (cudaStream_t)stream);
  }
  return corner_grad_launch<2>((float*)grad, r0, rows, (const long long*)idx,
                               (const float*)f, (const float*)ct, n,
                               (cudaStream_t)stream);
}

// corner_grad's launch shape for c channels on CUDA device `device`:
// threads a block, resident blocks an SM, SMs, registers and local (spill)
// bytes a thread, static shared bytes a block, entries a chunk and slots a
// table.  Launches nothing.
extern "C" int vpt_corner_grad_info(int c, int device, int* out) {
  if (c < 1 || c > 2) return (int)cudaErrorInvalidValue;
  VptDeviceGuard guard(device);
  const void* kernel = c == 1 ? (const void*)corner_grad_kernel<1>
                              : (const void*)corner_grad_kernel<2>;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        kChunk, kSlots};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}
