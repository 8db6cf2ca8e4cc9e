// DOS slice kernel (K9): one frame of DOS's front-to-back sweep, the
// frame's slices in one cooperative launch.
//
// Replaces the XLA lax.scan of vpt_tpu/renderers/dos.py:126-212 (chunk_step
// :157-203) with the gather-free disk taps of _shifted_occlusion_taps
// (:43-86).  It has no Pallas original; its corner fetch and TF lookup are
// the device functions of ray.cuh and tf1d.cuh.
//
// Per slice, its constants (renderers/dos.slice_table): depth_k = depth +
// k*sd, the NDC depth and occlusion scale from the projection of (1, 1,
// -depth_k), active = depth_k <= max_depth, and each disk tap's integer
// shift and fraction.  Per pixel and active slice: unproject (ndc,
// ndc_depth_k, 1) through the inverse MVP and divide by w; where the point
// lies in the unit cube, one colour fetch (the corner row and the 1D TF in
// the scene's mode), alpha = 1 - exp(-a*sigma*ds) composited front to back
// into the colour state (alpha min-clamped at 1), and the new occlusion:
// the mean of N bilinear taps of the PREVIOUS occlusion buffer at shifts
// that are the same for every pixel, times exp(-a*sigma*ds).  Pixels that
// write nothing carry their previous occlusion into the new buffer.  Then
// the depth advances by n_active*sd (dos.advance_depth).
//
// Bound on the H100: an active slice reads and writes the 16-byte colour of
// every pixel it writes (those whose point lies in the cube), reads the
// previous occlusion buffer and writes the new one (4 + 4 bytes a pixel),
// and reads the distinct corner rows (16 bytes, bf16) of its written
// pixels and the TF row; the taps' 4N reads a pixel fall on neighbouring
// texels of a 1 MB buffer (at 512^2) and hit L1/L2.  A written pixel costs
// ~160 float32 operations: bytes bound it, ~1.1 us an active slice on
// average over the 512^2 headline's sweep.  Measured (PERF.md §6): ~5.7 us
// an active slice, of which ~3 us is the design's floor a slice (the grid
// barrier and one pixel's dependent chain: a 1-pixel image takes it).
//
// Design: a slice reads its neighbours' previous occlusion, so it is a step
// across the whole image.  One cooperative launch runs all of a frame's
// slices: a persistent grid (the SMs times the blocks an SM holds, which
// cudaLaunchCooperativeKernel refuses to exceed) strides over the pixels in
// row-major order, and a grid-wide barrier separates slice k's taps from
// slice k+1's.  A thread's first pixel fetches slice k+1's colour (the
// unproject, the inside test, the corner row, the TF and the
// transmittance, which read no occlusion) before that barrier, so the
// barrier's wait hides the fetch's latency; only the composite and the taps
// wait for it.  Every block builds the frame's rows itself at its start,
// all at once where they fit in 32 KB of shared memory (in chunks
// otherwise), a warp a row, with the operations of dos.slice_table in
// PyTorch's order (the tangent of the aperture comes in from the wrapper,
// computed once with torch.tan), so no table is built on the host and the
// frame reads nothing back.  Active
// slices are a prefix of the frame's (depth_k only grows): the loop stops at
// the first inactive one, so slices past the far depth cost nothing.  The
// two occlusion buffers ping-pong from the state's; when an odd number of
// slices ran, the last one's buffer is copied back after one more barrier,
// so the state's occlusion tensor always holds the result.  The depth is
// advanced in place by one thread after the last barrier; given a table
// buffer, the grid also writes the frame's rows there, one a warp.
// Two-channel and filtered volumes run dos_sweep_ext_kernel, the same body
// (dos_sweep) with ray.cuh's ext fetch (vpt_fetch_color: the filter a
// warp-uniform argument, the row of the scene's channels, the 1D TF of one
// channel or the packed 2D TF of two); only the instances make_scene's
// rules reach are built.  Each instance holds its own number of blocks an
// SM, and the wrapper sizes the cooperative grid from the instance that
// will run (vpt_dos_sweep_info's flags).
//
// Numerics follow renderers/dos.slice_table, composite_slices and
// occlusion_taps operation by operation: built with -fmad=false, IEEE
// division, expf (PyTorch's exp on the card), NaN-propagating min and
// clamp, the taps summed in order k = 0..N-1 then divided by N, reads
// clamped at the edges, a tap's x fraction zeroed unless 0 <= x + bx <=
// W-2 (y likewise with H), both tap shifts clamped by the width.
//
// The halo instance (dos_halo_band_fetch_kernel, dos_halo_fold_kernel
// below) runs a HaloScene's frame: dos_slices with the fetch split around
// one all-reduce of every slice's values.
//
// The band instance (dos_band_kernel, VptDosBand below) runs one slice over a
// band of rows for the row-sharded sweeps (parallel/dos_halo.py,
// shard.shard_render_frame): dos_row, dos_fetch and dos_composite shared with
// the cooperative kernel, vpt_tpu's sharded taps on a halo-extended buffer.
// Its halo instance (dos_halo_band_fetch_kernel over the band's rows a chunk
// of 8 slices, an all-reduce, then dos_halo_band_kernel a slice) runs a
// HaloScene's band (halo.sharded_render_frame with data > 1).  A band's frame
// is prepared once (VptDosBandFrame, checked by vpt_dos_band_check), and a
// slice passes only what changes: the slice and the previous occlusion
// (vpt_dos_band_slice; vpt_dos_band_fetch at a halo chunk's first slice).  The
// host time a slice was its bound (~28 us a slice through the argument lists
// this replaced; PERF.md §6).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

namespace cg = cooperative_groups;

// What a frame takes of its scene, Params and resolution, filled once by the
// wrapper (kernels/dos_sweep.py, a ctypes Structure of this layout).
struct VptDosArgs {
  const void* table;       // (D*H*W, 8) float32 or bfloat16 corner rows
  const float4* tf_row;    // (tw, 4)
  const float* mvp;        // 16 floats, row-major inverse MVP
  const float* projection; // 16 floats, row-major projection
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;         // tf_mode: tf1d.cuh's lookup mode
  int width, height;       // the image
  int samples;             // N, the disk taps
  int steps;               // slices a frame
  float extinction;
  float tan_aperture;      // float32 tan(aperture * pi / 180), torch.tan
  int blocks;              // the cooperative grid
  int device;
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, ray.cuh's fetch) take besides; only they read it.
struct VptDosExt : VptDosArgs {
  const void* tf_table;    // (th*tw, 16) packed TF of the table's type
  int th;
  int channels;            // 1 or 2: with filter 0 and 1 channel, no ext
  int filter;              // ray.cuh's VptFilter
};

// What a frame call passes: the state's tensors and the optional table.
struct VptDosFrame {
  float4* color;                // (height, width, 4), in place
  float* occlusion;             // (height, width), in place
  float* scratch;               // (height, width), the other buffer
  float* depth;                 // 0-d, advanced in place
  const float* max_depth;       // 0-d
  const float* slice_distance;  // 0-d
  const float* offsets;         // (N, 2) disk offsets
  float* rows;                  // null, or (steps, 4 + 4N): the table
};

namespace {

constexpr int kThreads = 512;
// blocks an SM that the register allocation must allow: 2 (64 registers)
// measured fastest over a sweep, against 1 (106 registers), 3 and 4 (which
// spill) and one block of 1024 threads (PERF.md §6)
constexpr int kMinBlocks = 2;
// the leading floats of a slice's row (dos.TABLE_HEAD): NDC depth, active,
// slice distance, 0; then (bx, by, fx, fy) a tap
constexpr int kHead = 4;
// the shared memory a block's rows may take
constexpr int kRowBytes = 32 * 1024;

// The slices whose rows a block holds at once: all of the frame's where
// they fit in kRowBytes.
__host__ __device__ __forceinline__ int dos_chunk(int steps, int samples) {
  const int fit = kRowBytes / (int)((kHead + 4 * samples) * sizeof(float));
  return max(1, min(steps, fit));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Slice k's depth dk = depth + k*sd and its projection corr of (1, 1,
// -dk), divided by w (dos.slice_table's transform_point).
__device__ __forceinline__ float dos_project(const VptDosArgs& a,
                                             float depth, float sd, int k,
                                             float corr[3]) {
  const float dk = depth + (float)k * sd;
  const float* m = a.projection;
  float out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // math3d.apply_mat4 of (1, 1, -dk, 1), left to right
    out[r] = 1.0f * __ldg(m + 4 * r) + 1.0f * __ldg(m + 4 * r + 1)
             + -dk * __ldg(m + 4 * r + 2) + 1.0f * __ldg(m + 4 * r + 3);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) corr[j] = out[j] / out[3];
  return dk;
}

// Row k of dos.slice_table into row[0 .. 4 + 4N), by the 32 lanes of a
// warp: every lane projects the slice, lane 0 writes the head and the
// lanes write the taps in turn.
__device__ __forceinline__ void dos_row(const VptDosArgs& a, float depth,
                                        float sd, float max_depth,
                                        const float* offsets, int k,
                                        float* row, int lane) {
  float corr[3];
  const float dk = dos_project(a, depth, sd, k, corr);
  const float extent = sd * a.tan_aperture;
  const float scale[2] = {corr[0] * extent, corr[1] * extent};
  const float dims[2] = {(float)a.width, (float)a.height};
  const float lim = (float)(a.width + 1);
  if (lane == 0) {
    row[0] = corr[2];
    row[1] = dk <= max_depth ? 1.0f : 0.0f;
    row[2] = sd;
    row[3] = 0.0f;
  }
  for (int j = lane; j < a.samples; j += 32) {
    float* tap = row + kHead + 4 * j;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float dd = __ldg(offsets + 2 * j + c) * scale[c] * dims[c];
      const float base = vpt_clip(floorf(dd), -lim, lim);
      tap[c] = base;
      tap[2 + c] = dd - base;
    }
  }
}

// The colour a pixel takes at a slice, before the occlusion is known.
struct DosFetch {
  bool write;
  float r, g, b, alpha, transmittance;
};

// The NDC of pixel i (sampling.pixel_ndc).
__device__ __forceinline__ float2 dos_ndc(const VptDosArgs& a, int i) {
  const int x = i % a.width, y = i / a.width;
  return make_float2(vpt_pixel_ndc(x, a.width), vpt_pixel_ndc(y, a.height));
}

// The point of a pixel at NDC ndc on a slice of NDC depth nz: unprojected
// through the inverse MVP and divided by w; false outside the unit cube.
template <class A>
__device__ __forceinline__ bool dos_point(const A& a, float2 ndc, float nz,
                                          float p[3]) {
  float h4[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    h4[r] = ndc.x * __ldg(a.mvp + 4 * r) + ndc.y * __ldg(a.mvp + 4 * r + 1)
            + nz * __ldg(a.mvp + 4 * r + 2) + 1.0f * __ldg(a.mvp + 4 * r + 3);
  }
  bool outside = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = h4[k] / h4[3];
    outside = outside || p[k] > 1.0f || p[k] < 0.0f;
  }
  return !outside;
}

// A written pixel's fetch from its colour c on a slice of slice distance
// row[2]: alpha = 1 - exp(-a*sigma*ds).
template <class A>
__device__ __forceinline__ DosFetch dos_shade(const A& a, float4 c,
                                              const float* row) {
  DosFetch f;
  f.write = true;
  const float e = c.w * a.extinction;
  f.transmittance = expf(-e * row[2]);
  f.alpha = 1.0f - f.transmittance;
  f.r = c.x;
  f.g = c.y;
  f.b = c.z;
  return f;
}

// The colour of a fetched (value, channel 1) through the read-only cache:
// the TF row's lookup in mode kTf, or for two channels the packed 2D TF's
// (kC as in dos_fetch).
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ float4 dos_color(const A& a, float2 v) {
  if constexpr (kC == 0) {
    return vpt_tf1d_lookup<true>(a.tf_row, a.tw, v.x, kTf);
  } else {
    return vpt_color_rg<kBf16, kC, true>(a.tf_row, a.tw, kTf, a.tf_table,
                                         a.th, v);
  }
}

// kC is 0 for the headline's linear single-channel fetch (A is
// VptDosArgs), else an ext instance's channels (A is VptDosExt): the
// filtered cell, the row of kC channels and vpt_color_rg's colour.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ DosFetch dos_fetch(const A& a, float2 ndc,
                                              const float* row) {
  float p[3];
  DosFetch f;
  f.write = dos_point(a, ndc, row[0], p);
  if (!f.write) return f;
  float4 c;
  if constexpr (kC == 0) {
    const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, p[0], p[1],
                                     p[2]);
    c = vpt_tf1d_lookup<true>(a.tf_row, a.tw, v, kTf);
  } else {
    c = vpt_fetch_color<kBf16, kC, true>(a.table, a.d, a.h, a.w, a.filter,
                                         p[0], p[1], p[2], a.tf_row, a.tw,
                                         kTf, a.tf_table, a.th);
  }
  return dos_shade(a, c, row);
}

// The front-to-back composite of a written pixel's fetch into its colour,
// under the previous occlusion prev.
__device__ __forceinline__ float4 dos_composite(float4 col, const DosFetch& f,
                                                float prev) {
  const float keep = 1.0f - col.w;
  col.x = col.x + f.r * prev * f.alpha * keep;
  col.y = col.y + f.g * prev * f.alpha * keep;
  col.z = col.z + f.b * prev * f.alpha * keep;
  col.w = vpt_nmin(col.w + f.alpha, 1.0f);
  return col;
}

// The slice's composite and new occlusion at pixel i, from the previous
// buffer src into dst.
__device__ __forceinline__ void dos_finish(const VptDosArgs& a,
                                           const float* row,
                                           const DosFetch& f, int i,
                                           float4* color, const float* src,
                                           float* dst) {
  const int width = a.width, height = a.height;
  const float prev = src[i];
  if (!f.write) {
    dst[i] = prev;
    return;
  }
  const float4 col = dos_composite(color[i], f, prev);

  // the disk taps of the previous buffer
  const int x = i % width, y = i / width;
  const float4* taps = reinterpret_cast<const float4*>(row + kHead);
  float total = 0.0f;
#pragma unroll 4
  for (int k = 0; k < a.samples; ++k) {
    const float4 t = taps[k];
    const int xs = x + (int)t.x, ys = y + (int)t.y;
    const int x0 = clampi(xs, 0, width - 1), x1 = clampi(xs + 1, 0, width - 1);
    const int y0 = clampi(ys, 0, height - 1);
    const int y1 = clampi(ys + 1, 0, height - 1);
    const float fx = (xs >= 0 && xs <= width - 2) ? t.z : 0.0f;
    const float fy = (ys >= 0 && ys <= height - 2) ? t.w : 0.0f;
    const float a00 = src[y0 * width + x0];
    const float a10 = src[y0 * width + x1];
    const float a01 = src[y1 * width + x0];
    const float a11 = src[y1 * width + x1];
    const float c0 = a00 * (1.0f - fx) + a10 * fx;
    const float c1 = a01 * (1.0f - fx) + a11 * fx;
    const float tap = c0 * (1.0f - fy) + c1 * fy;
    total = (k == 0) ? tap : total + tap;
  }
  dst[i] = total / (float)a.samples * f.transmittance;
  color[i] = col;
}

// Rows k0 .. k0 + count - 1 into rows[0 ..), a warp a row in turn.
__device__ __forceinline__ void dos_rows(const VptDosArgs& a, float depth,
                                         float sd, float max_depth,
                                         const float* offsets, int k0,
                                         int count, float* rows) {
  const int row_floats = kHead + 4 * a.samples;
  for (int k = threadIdx.x >> 5; k < count; k += kThreads >> 5) {
    dos_row(a, depth, sd, max_depth, offsets, k0 + k, rows + k * row_floats,
            threadIdx.x & 31);
  }
}

// Slices k0 .. k0 + count - 1 of a frame, the first inactive one ending
// the sweep; fetch(ndc, row, i, j) is pixel i's DosFetch at slice k0 + j
// (row: its row of the table).  advance: the last launch of the frame,
// which advances the depth by the frame's active slices (k0 + those it
// ran).  kC and A as in dos_fetch.
template <class A, class Fetch>
__device__ __forceinline__ void dos_slices(const A& a, const VptDosFrame& f,
                                           int k0, int count, bool advance,
                                           Fetch fetch) {
  cg::grid_group grid = cg::this_grid();
  // the rows of slices [k0 + j0, k0 + j0 + chunk) of the frame, built by
  // the block at once (slice k's at (k - k0 - j0) * row_floats)
  extern __shared__ float s_rows[];
  const int row_floats = kHead + 4 * a.samples;
  const int chunk = dos_chunk(count, a.samples);
  const int n = a.width * a.height;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  // read before the first barrier; written after the last
  const float depth = *f.depth, sd = *f.slice_distance;
  const float max_depth = *f.max_depth;

  if (f.rows != nullptr) {
    for (int k = tid >> 5; k < a.steps; k += stride >> 5) {
      dos_row(a, depth, sd, max_depth, f.offsets, k,
              f.rows + (long long)k * row_floats, threadIdx.x & 31);
    }
  }
  dos_rows(a, depth, sd, max_depth, f.offsets, k0, min(chunk, count),
           s_rows);
  __syncthreads();
  bool active = count > 0 && s_rows[1] > 0.0f;

  // the thread's first pixel: its NDC and its fetch of the next slice
  float2 ndc = make_float2(0.0f, 0.0f);
  DosFetch ahead;
  const bool first = tid < n;
  if (first) {
    ndc = dos_ndc(a, tid);
    if (active) ahead = fetch(ndc, s_rows, tid, 0);
  }
  float* src = f.occlusion;
  float* dst = f.scratch;
  int ran = 0;
  while (active) {
    if (ran > 0) grid.sync();
    const float* row = s_rows + (ran % chunk) * row_floats;
    if (first) dos_finish(a, row, ahead, tid, f.color, src, dst);
    for (int i = tid + stride; i < n; i += stride) {
      dos_finish(a, row, fetch(dos_ndc(a, i), row, i, ran), i, f.color, src,
                 dst);
    }
    ran += 1;
    float* written = dst;
    dst = src;
    src = written;
    active = false;
    if (ran < count) {
      if (ran % chunk == 0) {
        // the next chunk of rows, once every thread is done with this one
        __syncthreads();
        dos_rows(a, depth, sd, max_depth, f.offsets, k0 + ran,
                 min(chunk, count - ran), s_rows);
        __syncthreads();
      }
      const float* next = s_rows + (ran % chunk) * row_floats;
      active = next[1] > 0.0f;
      if (active && first) ahead = fetch(ndc, next, tid, ran);
    }
  }
  // the last slice's buffer back into the state's (an odd number ran), and
  // a barrier after every thread's read of the depth
  if (ran % 2 == 1 || ran == 0) grid.sync();
  if (ran % 2 == 1) {
    for (int i = tid; i < n; i += stride) f.occlusion[i] = f.scratch[i];
  }
  if (advance && tid == 0) *f.depth = depth + (float)(k0 + ran) * sd;
}

// One frame; kC and A as in dos_fetch.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ void dos_sweep(const A& a, const VptDosFrame& f) {
  dos_slices(a, f, 0, a.steps, true,
             [&](float2 ndc, const float* row, int, int) {
               return dos_fetch<kBf16, kTf, kC>(a, ndc, row);
             });
}

template <bool kBf16, int kTf>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dos_sweep_kernel(const VptDosArgs a, const VptDosFrame f) {
  dos_sweep<kBf16, kTf, 0>(a, f);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows, the
// TF lookup mode kTf; 2: a two-channel volume and the 2D TF table), the
// filter a warp-uniform argument.
template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dos_sweep_ext_kernel(const VptDosExt a, const VptDosFrame f) {
  dos_sweep<kBf16, kTf, kC>(a, f);
}

// The halo instance (parallel/halo.py, a HaloScene frame): the volume is z
// slabs over the ranks of a group, and a sample is the sum over the ranks
// of their masked slab-local values (vpt_tpu/parallel/halo.py:199-250),
// summed before the TF lookup.  vpt_tpu's sweep (dos.py:126-200) samples
// 8 slices a sample_color, one psum each; but a slice's sample points
// depend only on the frame's depth, never on another slice's fold, so this
// instance samples all of a frame's slices at once: one launch of
// dos_halo_band_fetch_kernel over the whole image writes each pixel's
// masked value at each slice (dos_point's point, the cell placed through
// the slab's plane map; 0 where another rank owns the cell and at slices
// past the far depth, which the kernel decides from the depth, and
// dos_outside() outside the cube; a row of its grid a kHaloChunk of
// slices, the band's one row), one all-reduce sums them, and
// dos_halo_fold_kernel runs the frame's slices as the cooperative sweep
// does (dos_slices: a grid barrier a slice, the composite and the disk taps
// of dos_finish) with the fetch replaced by the summed value's colour
// (dos_color, dos_shade), its write test read from the value.  A frame's
// values past 1 GiB (kernels/dos_sweep.halo_chunk) go in chunks of slices,
// a fetch, an all-reduce and a fold each, the last fold advancing the depth
// by the frame's active slices.  So on one slab a frame equals K9's bit for
// bit, with no read from the card.  A HaloScene has no filter: kC is 0 (one
// channel, the TF row in mode kTf) or 2.  The row band's halo instance (a
// band's fetch, dos_halo_band_kernel below) takes kHaloChunk slices a fetch.
constexpr int kHaloChunk = 8;

// The value a fetch writes where a pixel's point at an active slice lies
// outside the cube: -inf, which every rank writes there and the sum keeps,
// and which no finite volume's value is.  The frame's fold reads it in
// place of a second dos_point.
__device__ __forceinline__ float dos_outside() {
  return __int_as_float(0xff800000);
}

// The fetch's body over the pixels of rows [row0, row0 + band_h): each
// pixel's value at each of slices k0 .. k0 + count - 1, a block's row of
// the grid (blockIdx.y) taking kHaloChunk of them, place(p, &v) setting v
// to the value of point p where this rank owns its cell.
template <int kC, class Place>
__device__ __forceinline__ void dos_halo_fetch(
    const VptDosExt& a, const VptDosFrame& f, float* __restrict__ value,
    int k0, int count, int row0, int band_h, Place place) {
  // the block's slices: NDC depth and active flag (dos_row's row[0, 1])
  __shared__ float s_head[kHaloChunk][2];
  const int c0 = blockIdx.y * kHaloChunk;
  const int m = min(kHaloChunk, count - c0);
  if (threadIdx.x < m) {
    float corr[3];
    const float dk = dos_project(a, *f.depth, *f.slice_distance,
                                 k0 + c0 + threadIdx.x, corr);
    s_head[threadIdx.x][0] = corr[2];
    s_head[threadIdx.x][1] = dk <= *f.max_depth ? 1.0f : 0.0f;
  }
  __syncthreads();
  // the pixels of rows [row0, row0 + band_h) of the image, as dos_band
  // places them
  const int n = a.width * band_h;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr int kV = kC == 2 ? 2 : 1;
  const float2 ndc = make_float2(vpt_pixel_ndc(i % a.width, a.width),
                                 vpt_pixel_ndc(row0 + i / a.width, a.height));
  for (int j = 0; j < m; ++j) {
    float2 v = make_float2(0.0f, 0.0f);
    float p[3];
    if (s_head[j][1] > 0.0f) {
      if (dos_point(a, ndc, s_head[j][0], p))
        place(p, &v);
      else
        v.x = dos_outside();
    }
    float* out = value + kV * ((long long)(c0 + j) * n + i);
    out[0] = v.x;
    if (kV == 2) out[1] = v.y;
  }
}

// The fetch of a frame and of a band: each cell placed through the slab's
// plane map (slab.cuh's vpt_slab_plane, staged in shared memory), not
// through vpt_slab_z's divisions: the same cells.
template <bool kBf16, int kC>
__global__ void __launch_bounds__(kThreads)
dos_halo_band_fetch_kernel(const VptDosExt a, const VptDosFrame f,
                      const VptSlab slab, const int2* __restrict__ planes,
                      float* __restrict__ value, int k0, int count, int row0,
                      int band_h) {
  extern __shared__ int2 s_planes[];
  vpt_stage_planes(s_planes, planes, a.d);
  dos_halo_fetch<kC>(a, f, value, k0, count, row0, band_h,
                     [&](const float* p, float2* v) {
                       bool local;
                       const VptCell<int64_t> cell =
                           vpt_slab_plane_cell<int64_t>(
                               a.d, a.h, a.w, slab, s_planes, p[0], p[1],
                               p[2], &local);
                       if (local)
                         *v = vpt_slab_value<kBf16, kC, int64_t>(a.table,
                                                                 cell);
                     });
}

// The fold of slices k0 .. k0 + count - 1 from their summed values (slot j
// slice k0 + j's).  advance: the frame's last fold, which advances the depth
// by the frame's active slices: dos_slices' own count where the fold
// starts the frame, else counted here (a later chunk whose first slice lies
// past the far depth runs none, and the active slices end before it).
template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dos_halo_fold_kernel(const VptDosExt a, const VptDosFrame f,
                     const float* __restrict__ value, int k0, int count,
                     int advance) {
  constexpr int kV = kC == 2 ? 2 : 1;
  const long long n = (long long)a.width * a.height;
  // read before dos_slices' first barrier, as it reads them
  const float depth = *f.depth, sd = *f.slice_distance;
  const float max_depth = *f.max_depth;
  dos_slices(a, f, k0, count, advance != 0 && k0 == 0,
             [&](float2, const float* row, int i, int j) {
               // written where the fetch found the point inside the cube
               // (dos_point's test, on every rank alike)
               const float* v = value + kV * ((long long)j * n + i);
               DosFetch d;
               d.write = v[0] != dos_outside();
               if (!d.write) return d;
               return dos_shade(a, dos_color<kBf16, kTf, kC>(
                   a, make_float2(v[0], kV == 2 ? v[1] : 0.0f)), row);
             });
  if (advance != 0 && k0 > 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    // dos_row's active test, slice by slice (dos_slices passed a grid
    // barrier after every thread's read of the depth)
    int active = 0;
    while (active < k0 + count
           && depth + (float)active * sd <= max_depth)
      ++active;
    *f.depth = depth + (float)active * sd;
  }
}

// The halo instances for a table type and the TF lookup mode (one channel)
// or two channels: the fetch (of a frame or a band) or the fold; null for
// anything else.
const void* pick_halo_fetch(int channels, int table_bf16) {
  if (channels == 2)
    return table_bf16 ? (const void*)dos_halo_band_fetch_kernel<true, 2>
                      : (const void*)dos_halo_band_fetch_kernel<false, 2>;
  if (channels != 1) return nullptr;
  return table_bf16 ? (const void*)dos_halo_band_fetch_kernel<true, 0>
                    : (const void*)dos_halo_band_fetch_kernel<false, 0>;
}

const void* pick_halo_fold(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? (const void*)dos_halo_fold_kernel<true, 0, 2>
                      : (const void*)dos_halo_fold_kernel<false, 0, 2>;
  if (channels != 1) return nullptr;
  switch (tf_mode + 3 * table_bf16) {
    case 0: return (const void*)dos_halo_fold_kernel<false, 0, 0>;
    case 1: return (const void*)dos_halo_fold_kernel<false, 1, 0>;
    case 2: return (const void*)dos_halo_fold_kernel<false, 2, 0>;
    case 3: return (const void*)dos_halo_fold_kernel<true, 0, 0>;
    case 4: return (const void*)dos_halo_fold_kernel<true, 1, 0>;
    case 5: return (const void*)dos_halo_fold_kernel<true, 2, 0>;
    default: return nullptr;
  }
}

// The band instance (parallel/dos_halo.py, shard.shard_render_frame of
// DOS): one launch a slice over a rank's rows [row0, row0 + band_h) of the
// image (a.height rows).  The previous slice's occlusion comes in ext, a
// buffer of ext_h rows whose first is the image's row ext_row0: the rank's
// rows and K halo rows from its neighbours on each side
// (dos_halo.occlusion_halo_width), or the whole image.  Each block builds
// the slice's row of dos.slice_table (dos_row) and its occlusion scale; a
// pixel takes dos_fetch at its NDC in the whole image, composites into its
// colour, and writes its new occlusion into the band's buffer (a pixel
// that writes nothing keeps the previous value, which the band's buffer
// holds).  The taps are vpt_tpu's sharded taps (dos_halo.py:103-121,
// dos.py:181-188): tap = mapped + offset * scale, its texel clamped in the
// whole image's texel space, then read from ext at its local row (clamped
// to ext's rows), the bilinear lerp of the corner-packed texture, the taps
// summed in order and divided by N.  Built with -fmad=false like the
// plain twin (kernels/dos_sweep.band_slice_plain).
struct VptDosBand {
  float4* color;                // (band_h, width, 4), in place
  float* occlusion;             // (band_h, width): the slice's occlusion
  const float* ext;             // (ext_h, width): the previous slice's
  const float* depth;           // 0-d: the frame's first slice's depth
  const float* max_depth;       // 0-d
  const float* slice_distance;  // 0-d
  const float* offsets;         // (N, 2) disk offsets
  int slice;                    // k, the slice of the frame
  int row0, band_h, ext_row0, ext_h;
};

// The halo instance's prepared arguments: VptDosExt and the slab's plane
// map (appended; the other instances read the VptDosExt prefix).
struct VptDosHalo : VptDosExt {
  const int2* planes;  // (d) {slab-local plane, owner} of each global plane
};

// A band's frame, filled once a frame by the wrapper (kernels/dos_sweep.py,
// a ctypes Structure of this layout) and checked once (vpt_dos_band_check):
// the scene's prepared arguments and what every slice of the frame passes
// but the slice and the previous occlusion (band.ext, band.slice,
// band.ext_row0 and band.ext_h are the call's).  Over a HaloScene (halo)
// also the band's values and the slab.
struct VptDosBandFrame {
  const VptDosHalo* args;  // VptDosExt of the scene (VptDosHalo with halo)
  VptDosBand band;
  float* value;            // halo: (kHaloChunk, width * band_h, channels)
  VptSlab slab;            // halo: this rank's slab
  int halo;                // 1: the band's halo instance
  int n_active;            // the frame's active slices (halo), else steps
};

// fetch(ndc, row, i) is band pixel i's DosFetch at the slice (row: its
// row of the table).
template <class A, class Fetch>
__device__ __forceinline__ void dos_band(const A& a, const VptDosBand& b,
                                         Fetch fetch) {
  extern __shared__ float s_row[];   // the slice's row: 4 + 4N floats
  __shared__ float s_scale[2];
  const float depth = *b.depth, sd = *b.slice_distance;
  if (threadIdx.x < 32) {
    dos_row(a, depth, sd, *b.max_depth, b.offsets, b.slice, s_row,
            threadIdx.x);
  }
  if (threadIdx.x == 0) {
    float corr[3];
    dos_project(a, depth, sd, b.slice, corr);
    const float extent = sd * a.tan_aperture;
    s_scale[0] = corr[0] * extent;
    s_scale[1] = corr[1] * extent;
  }
  __syncthreads();
  const int width = a.width, height = a.height;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (s_row[1] <= 0.0f || i >= width * b.band_h) return;
  const int x = i % width, y = i / width;
  const float2 ndc = make_float2(vpt_pixel_ndc(x, width),
                                 vpt_pixel_ndc(b.row0 + y, height));
  const DosFetch f = fetch(ndc, s_row, i);
  if (!f.write) return;
  const float* ext = b.ext;
  const float prev = ext[(b.row0 + y - b.ext_row0) * width + x];
  b.color[i] = dos_composite(b.color[i], f, prev);
  const float mx = ndc.x * 0.5f + 0.5f, my = ndc.y * 0.5f + 0.5f;
  const float fw = (float)width, fh = (float)height;
  float total = 0.0f;
  for (int k = 0; k < a.samples; ++k) {
    const float tx = mx + __ldg(b.offsets + 2 * k) * s_scale[0];
    const float ty = my + __ldg(b.offsets + 2 * k + 1) * s_scale[1];
    const float ux = vpt_clip(tx * fw - 0.5f, 0.0f, fw - 1.0f);
    const float uy = vpt_clip(ty * fh - 0.5f, 0.0f, fh - 1.0f);
    const float ix = floorf(ux), iy = floorf(uy);
    const float fx = ux - ix, fy = uy - iy;
    const int x0 = vpt_index(ix), x1 = min(x0 + 1, width - 1);
    const int ly = clampi(vpt_index(iy) - b.ext_row0, 0, b.ext_h - 1);
    const int ly1 = min(ly + 1, b.ext_h - 1);
    const float cx0 = ext[ly * width + x0] * (1.0f - fx)
                      + ext[ly * width + x1] * fx;
    const float cx1 = ext[ly1 * width + x0] * (1.0f - fx)
                      + ext[ly1 * width + x1] * fx;
    const float tap = cx0 * (1.0f - fy) + cx1 * fy;
    total = (k == 0) ? tap : total + tap;
  }
  b.occlusion[i] = total / (float)a.samples * f.transmittance;
}

template <bool kBf16, int kTf>
__global__ void __launch_bounds__(kThreads)
dos_band_kernel(const VptDosArgs a, const VptDosBand b) {
  dos_band(a, b, [&](float2 ndc, const float* row, int) {
    return dos_fetch<kBf16, kTf, 0>(a, ndc, row);
  });
}

template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
dos_band_ext_kernel(const VptDosExt a, const VptDosBand b) {
  dos_band(a, b, [&](float2 ndc, const float* row, int) {
    return dos_fetch<kBf16, kTf, kC>(a, ndc, row);
  });
}

// The halo band instance (parallel/halo.py: a HaloScene's frame on a band
// of rows, data > 1): the band instance with the fetch replaced by the
// summed value's colour (dos_color, dos_shade), as dos_halo_fold_kernel
// replaces it in the cooperative sweep.  value holds a chunk of up to
// kHaloChunk slices' summed values over the band's pixels
// (dos_halo_band_fetch_kernel over rows [row0, row0 + band_h), then one
// all-reduce), slot j this slice's.  So on one slab, with the same ext, a
// slice equals the band instance's bit for bit.
template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
dos_halo_band_kernel(const VptDosExt a, const VptDosBand b,
                     const float* __restrict__ value, int j) {
  constexpr int kV = kC == 2 ? 2 : 1;
  const long long n = (long long)a.width * b.band_h;
  dos_band(a, b, [&](float2 ndc, const float* row, int i) {
    // The write test is dos_point's, made again, where dos_halo_fold_kernel
    // reads the fetch's dos_outside(): at an active slice both answer
    // alike.  This instance keeps it so that its code, and with it the
    // device time and SASS it is held to, stays as measured; moving it onto
    // the value's test is ROADMAP 2c item 1's next K9 halo band step.
    float p[3];
    DosFetch d;
    d.write = dos_point(a, ndc, row[0], p);
    if (!d.write) return d;
    const float* v = value + kV * ((long long)j * n + i);
    return dos_shade(a, dos_color<kBf16, kTf, kC>(
        a, make_float2(v[0], kV == 2 ? v[1] : 0.0f)), row);
  });
}

// The band instance for the sweep's flags and TF mode, as pick's.
template <bool kBf16>
const void* pick_band_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return (const void*)dos_band_kernel<kBf16, 0>;
    case 1: return (const void*)dos_band_kernel<kBf16, 1>;
    case 2: return (const void*)dos_band_kernel<kBf16, 2>;
    default: return nullptr;
  }
}

const void* pick_band(int flags, int tf_mode) {
  const int bf16 = flags & 1;
  if (flags & 4)
    return bf16 ? (const void*)dos_band_ext_kernel<true, 0, 2>
                : (const void*)dos_band_ext_kernel<false, 0, 2>;
  if (flags & 2) {
    if (bf16) return nullptr;
    switch (tf_mode) {
      case 0: return (const void*)dos_band_ext_kernel<false, 0, 1>;
      case 1: return (const void*)dos_band_ext_kernel<false, 1, 1>;
      case 2: return (const void*)dos_band_ext_kernel<false, 2, 1>;
      default: return nullptr;
    }
  }
  return bf16 ? pick_band_tf<true>(tf_mode) : pick_band_tf<false>(tf_mode);
}

// The halo band instance for a table type and the TF lookup mode (one
// channel) or two channels; null for anything else.
const void* pick_halo_band(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? (const void*)dos_halo_band_kernel<true, 0, 2>
                      : (const void*)dos_halo_band_kernel<false, 0, 2>;
  if (channels != 1) return nullptr;
  switch (tf_mode + 3 * table_bf16) {
    case 0: return (const void*)dos_halo_band_kernel<false, 0, 0>;
    case 1: return (const void*)dos_halo_band_kernel<false, 1, 0>;
    case 2: return (const void*)dos_halo_band_kernel<false, 2, 0>;
    case 3: return (const void*)dos_halo_band_kernel<true, 0, 0>;
    case 4: return (const void*)dos_halo_band_kernel<true, 1, 0>;
    case 5: return (const void*)dos_halo_band_kernel<true, 2, 0>;
    default: return nullptr;
  }
}

// The instantiation for a table type and TF lookup mode (tf1d.cuh's: a
// compile-time constant, so the lookup carries no branch).
template <bool kBf16>
const void* pick_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return (const void*)dos_sweep_kernel<kBf16, 0>;
    case 1: return (const void*)dos_sweep_kernel<kBf16, 1>;
    case 2: return (const void*)dos_sweep_kernel<kBf16, 2>;
    default: return nullptr;
  }
}

// The ext instance: one channel (a filtered volume) in float32 rows with
// each TF lookup mode, or two channels in either row type (the 2D TF
// lookup has no mode); the instances make_scene's rules can reach, null
// for anything else.
const void* pick_ext(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? (const void*)dos_sweep_ext_kernel<true, 0, 2>
                      : (const void*)dos_sweep_ext_kernel<false, 0, 2>;
  if (channels != 1 || table_bf16) return nullptr;
  switch (tf_mode) {
    case 0: return (const void*)dos_sweep_ext_kernel<false, 0, 1>;
    case 1: return (const void*)dos_sweep_ext_kernel<false, 1, 1>;
    case 2: return (const void*)dos_sweep_ext_kernel<false, 2, 1>;
    default: return nullptr;
  }
}

// flags: 1 bf16 rows, 2 the ext instance of one channel (a filtered
// volume), 4 of two channels
const void* pick(int flags, int tf_mode) {
  const int bf16 = flags & 1;
  if (flags & 4) return pick_ext(2, bf16, tf_mode);
  if (flags & 2) return pick_ext(1, bf16, tf_mode);
  return bf16 ? pick_tf<true>(tf_mode) : pick_tf<false>(tf_mode);
}

// whether a launch runs an ext instance
bool is_ext(const VptDosExt& a) { return a.channels != 1 || a.filter != 0; }

int flags_of(const VptDosExt& a) {
  return a.table_bf16 | (is_ext(a) ? (a.channels == 2 ? 4 : 2) : 0);
}

size_t shared_bytes(int steps, int samples) {
  return (size_t)dos_chunk(steps, samples) * (kHead + 4 * samples)
         * sizeof(float);
}

}  // namespace

// One frame: prepared is the VptDosExt of the scene, Params and
// resolution; color, occlusion and depth the state's, updated in place;
// scratch another buffer of the occlusion's shape; max_depth, the slice
// distance and the (N, 2) offsets the state's; rows null or a (steps, 4 +
// 4N) float32 buffer that receives the frame's table.  One cooperative
// launch; it fails (cudaErrorCooperativeLaunchTooLarge) rather than run a
// grid that the card cannot hold at once.
extern "C" int vpt_dos_frame(const void* prepared, void* color,
                             void* occlusion, void* scratch, void* depth,
                             const void* max_depth,
                             const void* slice_distance, const void* offsets,
                             void* rows, void* stream) {
  const VptDosExt& a = *static_cast<const VptDosExt*>(prepared);
  VptDeviceGuard guard(a.device);
  if (is_ext(a) && (a.filter < 0 || a.filter > 2))
    return (int)cudaErrorInvalidValue;
  const void* kernel = pick(flags_of(a), a.tf_mode);
  if (kernel == nullptr || a.blocks <= 0) return (int)cudaErrorInvalidValue;
  // the headline's instances take the VptDosArgs prefix, as before the ext
  VptDosArgs args = a;
  VptDosExt ext = a;
  VptDosFrame frame = {static_cast<float4*>(color),
                       static_cast<float*>(occlusion),
                       static_cast<float*>(scratch),
                       static_cast<float*>(depth),
                       static_cast<const float*>(max_depth),
                       static_cast<const float*>(slice_distance),
                       static_cast<const float*>(offsets),
                       static_cast<float*>(rows)};
  void* params[] = {is_ext(a) ? (void*)&ext : (void*)&args, &frame};
  return (int)cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)a.blocks),
      dim3(kThreads), params, shared_bytes(a.steps, a.samples),
      (cudaStream_t)stream);
}

// The launch shape of the instance for `flags` (1 bf16 rows, 2 the ext
// instance of one channel, 4 of two channels), the TF lookup mode
// `tf_mode`, `steps` slices a frame and N = samples disk taps on `device`:
// the cooperative grid is that instance's resident blocks times the SMs.
// out = threads a block, resident blocks an SM, SMs, registers a
// thread, local (spilled) bytes a thread, static shared bytes a block,
// dynamic shared bytes a block (the rows it holds), the slices whose rows
// it holds at once.  Launches nothing.
extern "C" int vpt_dos_sweep_info(int flags, int tf_mode, int steps,
                                  int samples, int device, int* out) {
  VptDeviceGuard guard(device);
  const void* kernel = pick(flags, tf_mode);
  if (kernel == nullptr || samples < 1 || steps < 1
      || (kHead + 4 * samples) * sizeof(float) > kRowBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = shared_bytes(steps, samples);
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        (int)smem, dos_chunk(steps, samples)};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}

// One launch of the halo instance (see dos_halo_band_fetch_kernel):
// prepared is the VptDosHalo of the HaloScene, Params and resolution
// (table: the rank's slab rows; d, h, w the whole volume's; no filter;
// blocks the fold's cooperative grid; the slab's plane map); color,
// occlusion, scratch, depth, max_depth, the slice distance and the offsets
// as vpt_dos_frame's; the slab (its index of num_slabs, the thin slabs a
// rank and whether the fetch is masked); value the (count, width * height,
// channels) values; slices k0 .. k0 + count - 1 of the frame (the frame's
// chunk: all of its steps where their values fit); stage 0 writes this
// rank's masked values (0 at a slice past the far depth), stage 1 folds the
// summed ones up to the first inactive slice (advance: the frame's last
// fold, which advances the depth by the frame's active slices).
extern "C" int vpt_dos_halo_launch(
    const void* prepared, void* color, void* occlusion, void* scratch,
    void* depth, const void* max_depth, const void* slice_distance,
    const void* offsets, int slab_index, int num_slabs, int interleave,
    int masked, void* value, int k0, int count, int stage, int advance,
    void* stream) {
  const VptDosHalo& a = *static_cast<const VptDosHalo*>(prepared);
  VptDeviceGuard guard(a.device);
  if (a.filter != 0 || k0 < 0 || count < 1 || k0 + count > a.steps
      || num_slabs < 1 || interleave < 1 || slab_index < 0
      || slab_index >= num_slabs || a.d % (num_slabs * interleave) != 0
      || a.planes == nullptr || a.d > kVptMaxPlanes)
    return (int)cudaErrorInvalidValue;
  VptDosExt args = a;
  VptDosFrame frame = {static_cast<float4*>(color),
                       static_cast<float*>(occlusion),
                       static_cast<float*>(scratch),
                       static_cast<float*>(depth),
                       static_cast<const float*>(max_depth),
                       static_cast<const float*>(slice_distance),
                       static_cast<const float*>(offsets), nullptr};
  float* values = static_cast<float*>(value);
  if (stage == 0) {
    const void* kernel = pick_halo_fetch(a.channels, a.table_bf16);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    VptSlab slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
    const int2* planes = a.planes;
    int row0 = 0, band_h = a.height;
    void* params[] = {&args, &frame, &slab, &planes, &values, &k0, &count,
                      &row0, &band_h};
    const long long n = (long long)a.width * a.height;
    if (n <= 0) return 0;
    return (int)cudaLaunchKernel(
        kernel, dim3((unsigned)((n + kThreads - 1) / kThreads),
                     (unsigned)((count + kHaloChunk - 1) / kHaloChunk)),
        dim3(kThreads), params, (size_t)a.d * sizeof(int2),
        (cudaStream_t)stream);
  }
  if (stage != 1) return (int)cudaErrorInvalidValue;
  const void* kernel = pick_halo_fold(a.channels, a.table_bf16, a.tf_mode);
  if (kernel == nullptr || a.blocks <= 0) return (int)cudaErrorInvalidValue;
  const float* folded = values;
  void* params[] = {&args, &frame, &folded, &k0, &count, &advance};
  return (int)cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)a.blocks), dim3(kThreads), params,
      shared_bytes(count, a.samples), (cudaStream_t)stream);
}

namespace {

// What a band frame fixes, checked once a frame (vpt_dos_band_check): the
// band's rows of the image, the instance that runs it, and over a
// HaloScene the slab, the plane map and the frame's active slices.
int band_frame_check(const VptDosBandFrame& f) {
  const VptDosHalo& a = *f.args;
  const VptDosBand& b = f.band;
  if (is_ext(a) && (a.filter < 0 || a.filter > 2))
    return (int)cudaErrorInvalidValue;
  if (b.row0 < 0 || b.band_h < 0 || b.row0 + b.band_h > a.height)
    return (int)cudaErrorInvalidValue;
  if (!f.halo) {
    if (f.n_active != a.steps || pick_band(flags_of(a), a.tf_mode) == nullptr)
      return (int)cudaErrorInvalidValue;
    return 0;
  }
  const VptSlab& slab = f.slab;
  if (a.filter != 0 || f.n_active < 0 || f.n_active > a.steps
      || slab.count < 1 || slab.interleave < 1 || slab.index < 0
      || slab.index >= slab.count || a.d % (slab.count * slab.interleave)
      || a.planes == nullptr || a.d > kVptMaxPlanes || f.value == nullptr
      || pick_halo_fetch(a.channels, a.table_bf16) == nullptr
      || pick_halo_band(a.channels, a.table_bf16, a.tf_mode) == nullptr)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// 0 where the band frame (see VptDosBandFrame) is one its slices can run,
// else a CUDA error code.  Launches nothing.
extern "C" int vpt_dos_band_check(const void* frame) {
  return band_frame_check(*static_cast<const VptDosBandFrame*>(frame));
}

// The halo instance's fetch at a chunk's first active slice k (k a
// multiple of kHaloChunk below the frame's active slices): this rank's
// masked values of slices k .. k + count - 1 (count = min(kHaloChunk,
// n_active - k)) over the band's pixels into the band's values, each cell
// placed through the plane map.  The caller all-reduces the values before
// the chunk's slices.
extern "C" int vpt_dos_band_fetch(const void* frame, int k, void* stream) {
  const VptDosBandFrame& f = *static_cast<const VptDosBandFrame*>(frame);
  const VptDosHalo& a = *f.args;
  VptDeviceGuard guard(a.device);
  if (!f.halo || k < 0 || k >= f.n_active || k % kHaloChunk)
    return (int)cudaErrorInvalidValue;
  if (f.band.band_h == 0) return 0;
  int k0 = k, count = min(kHaloChunk, f.n_active - k);
  int row0 = f.band.row0, band_h = f.band.band_h;
  VptDosFrame frame_args = {
      nullptr, nullptr, nullptr, const_cast<float*>(f.band.depth),
      f.band.max_depth, f.band.slice_distance, f.band.offsets, nullptr};
  VptSlab slab = f.slab;
  const int2* planes = a.planes;
  float* values = f.value;
  void* params[] = {(void*)&a, &frame_args, &slab, &planes, &values, &k0,
                    &count, &row0, &band_h};
  const long long n = (long long)a.width * band_h;
  return (int)cudaLaunchKernel(
      pick_halo_fetch(a.channels, a.table_bf16),
      dim3((unsigned)((n + kThreads - 1) / kThreads)), dim3(kThreads),
      params, (size_t)a.d * sizeof(int2), (cudaStream_t)stream);
}

// Slice k of the band frame: the band instance (dos_band_kernel), or over
// a HaloScene the halo instance's fold of slice k's summed value
// (dos_halo_band_kernel, after its chunk's fetch and all-reduce); ext the
// (ext_h, width) previous occlusion from the image's row ext_row0, which
// covers the band.  An inactive slice changes nothing.
extern "C" int vpt_dos_band_slice(const void* frame, const void* ext,
                                  int ext_row0, int ext_h, int k,
                                  void* stream) {
  const VptDosBandFrame& f = *static_cast<const VptDosBandFrame*>(frame);
  const VptDosHalo& a = *f.args;
  VptDeviceGuard guard(a.device);
  VptDosBand band = f.band;
  if (k < 0 || k >= f.n_active || ext == nullptr || ext_h <= 0
      || ext_row0 > band.row0 || ext_row0 + ext_h < band.row0 + band.band_h)
    return (int)cudaErrorInvalidValue;
  if (band.band_h == 0) return 0;
  band.ext = static_cast<const float*>(ext);
  band.slice = k;
  band.ext_row0 = ext_row0;
  band.ext_h = ext_h;
  const long long n = (long long)a.width * band.band_h;
  const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads));
  const size_t row_bytes = (size_t)(kHead + 4 * a.samples) * sizeof(float);
  if (!f.halo) {
    // the kernel takes the prefix it knows (VptDosArgs or VptDosExt)
    void* params[] = {(void*)&a, &band};
    return (int)cudaLaunchKernel(pick_band(flags_of(a), a.tf_mode), blocks,
                                 dim3(kThreads), params, row_bytes,
                                 (cudaStream_t)stream);
  }
  const float* folded = f.value;
  int j = k % kHaloChunk;
  void* params[] = {(void*)&a, &band, &folded, &j};
  return (int)cudaLaunchKernel(
      pick_halo_band(a.channels, a.table_bf16, a.tf_mode), blocks,
      dim3(kThreads), params, row_bytes, (cudaStream_t)stream);
}

// The launch shape of the halo instance's stage (0 the fetch of a frame or
// a band, through the plane map, whose d * 8 bytes of shared memory a block
// come on top; 1 the fold) for flags (1 bf16 rows, 4 two channels), the TF
// lookup mode, N = samples disk taps and a fold of `steps` slices on
// `device`: vpt_dos_sweep_info's values (the fold's cooperative grid is its
// resident blocks times the SMs, with the rows of `steps` slices in shared
// memory).  Launches nothing.
extern "C" int vpt_dos_halo_info(int stage, int flags, int tf_mode,
                                 int samples, int steps, int device,
                                 int* out) {
  VptDeviceGuard guard(device);
  const int channels = (flags & 4) ? 2 : 1;
  const void* kernel = stage == 1
                           ? pick_halo_fold(channels, flags & 1, tf_mode)
                           : pick_halo_fetch(channels, flags & 1);
  if (kernel == nullptr || samples < 1 || steps < 1
      || (kHead + 4 * samples) * sizeof(float) > kRowBytes)
    return (int)cudaErrorInvalidValue;
  if (stage < 0 || stage > 1) return (int)cudaErrorInvalidValue;
  const size_t smem = stage == 1 ? shared_bytes(steps, samples) : 0;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        (int)smem,
                        stage == 1 ? dos_chunk(steps, samples) : kHaloChunk};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}
