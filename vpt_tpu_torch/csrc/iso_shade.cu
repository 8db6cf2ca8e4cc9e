// ISO shade kernel: the ISO renderer's display, one thread a pixel.
//
// Replaces the XLA display of vpt_tpu/renderers/iso.py:109-130 (the
// deferred central-difference + Lambert shade; Scene.value_gradient of
// base.py:232-236 through sampling.central_value_gradient, :625-633).  It
// has no Pallas original; its fetches and TF lookups are the device
// functions of ray.cuh and tf1d.cuh.
//
// Bound on the H100: every pixel reads its 16-byte state and writes 16
// bytes, 8.4 MB at 512^2; a hit pixel also fetches seven corner rows (six
// gradient taps at +-h on each axis and the material at the hit) with a
// TF lookup each, ~7 x 35 operations plus ~40 of the normal and the
// Lambert term.  On the 512^2 headline 5.7% of the pixels hit (14 980, from
// 13 123 distinct rows): bytes bound it, 0.0026 ms at 3.35 TB/s, and a
// plain copy of the state into the image takes 0.0024 ms with both in L2
// (0.0046 from HBM).
//
// Design: pixels run in row-major launch order, 32 consecutive pixels a
// warp, so that a warp streams 512 contiguous bytes of state and image and
// the taps of a row of pixels fall on consecutive corner rows of the
// x-minor table.  A thread reads its state first; a pixel without a hit
// writes white and leaves, with no prologue and no barrier to wait for.  A
// hit computes all seven cells, issues the seven row reads, and only then
// folds them in the plain order (lerps, TF lookups, differences,
// divisions).  The TF row is read through the read-only cache: at TW 256
// it is 4 KiB, which L1 keeps once the first warps of an SM have touched
// it, so no block copies it into shared memory.  The TF lookup mode and the
// table type are template parameters.  The launch takes its scene, Params
// and resolution as one pointer to a VptIsoShadeExt that the wrapper
// prepares once.  Two-channel and filtered volumes run
// iso_shade_ext_kernel, the same body (iso_shade) with ray.cuh's ext
// fetch for the seven taps (the filter a warp-uniform argument) and, for
// two channels, the 2D TF lookup.
//
// Tried, in turns on one H100 against the first design (rows of 128
// pixels, the TF row copied into shared memory by every block behind a
// barrier, the TF mode a runtime argument, the fetches as a sequence), on
// the headline at 512^2 (PERF.md §6): this kernel 0.70x its time; each of
// these alone cost more: the TF row in shared memory 1.17x (4.7x with the
// 3072-texel row, whose 48 KiB every block copies), the compiler's order
// of the fetches 1.06x, the TF mode at run time 1.10x, a persistent grid
// that copies the TF row once a block 1.11x, two pixels a thread 1.27x,
// 8 x 4 warp tiles 1.03x (1.06x on a state that hits in every pixel),
// 256-thread blocks 0.95x but 1.03-1.07x on the other scenes, register
// caps for 12 or 16 blocks an SM 1.06-1.35x (spills).  What is left: the
// misses' stream, which a copy of the same bytes takes 0.67x of, and the
// hit warps' chain (state, rows, TF, store) on about 1.5 waves of blocks.
//
// A HaloScene's display runs the halo instance (iso_halo_fetch_kernel and
// iso_halo_shade_kernel below) around one all-reduce of its hits' seven
// values.
//
// Numerics follow iso.shade (renderers/iso.py) operation by operation:
// built with -fmad=false, the gradient's IEEE division by the float32 2h,
// NaN-propagating max, sums left to right, rows indexed with 64 bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

// What a display takes of its scene, Params and resolution, filled once by
// the wrapper (kernels/iso_shade.py, a ctypes Structure of this layout).
struct VptIsoShadeArgs {
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  const float4* tf_row;  // (tw, 4)
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  int width, height;     // the image
  float step, two_step;  // h and the float32 2h
  float lx, ly, lz;      // the normalised light direction
  int device;
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, ray.cuh) take besides; only they read it.
struct VptIsoShadeExt : VptIsoShadeArgs {
  const void* tf_table;  // (th*tw, 16) packed TF of the table's type
  int th;
  int channels;          // 1 or 2: with filter 0 and 1 channel, no ext
  int filter;            // ray.cuh's VptFilter
};

// A HaloScene's display (the halo instance below), prepared and checked
// once (vpt_iso_halo_check): the VptIsoShadeExt of its slab rows and the
// display's scratch.
struct VptIsoHalo : VptIsoShadeExt {
  const int2* planes;    // the slab's plane map, (d, 2) (slab.cuh)
  float* value;          // (width * height, 7, channels): a slot's values
  int* pixel;            // (width * height): a slot's pixel
  uint64_t* status;      // (tiles): the fetch's look-back words
  uint32_t* ticket;      // the fetch's next tile, 0 between displays
  int* count;            // the display's hits
  VptSlab slab;
  int rows64;            // 1: index slab rows with 64 bits
  int shade_blocks;      // the shade's grid where no count was read
};

namespace {

// the fetches of a hit: +h and -h on x, then y, then z, then the hit
constexpr int kTaps = 7;
constexpr int kThreads = 128;

// Fetch j of a hit at p (+h and -h on x, then y, then z, then the hit).
__device__ __forceinline__ void iso_tap(const float p[3], float step, int j,
                                        float q[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = p[k];
  if (j < 6) q[j / 2] = (j % 2 == 0) ? p[j / 2] + step : p[j / 2] - step;
}

// The shade of a hit from color(j), the colour of fetch j: the central
// differences of TF alpha (central_value_gradient), the normal, the Lambert
// term and the material colour at the hit.
template <class A, class Color>
__device__ __forceinline__ float4 iso_lambert(const A& a, Color color) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g[k] = color(2 * k).w - color(2 * k + 1).w;
    g[k] = g[k] / a.two_step;
  }
  const float len = sqrtf(vpt_nmax(g[0] * g[0] + g[1] * g[1] + g[2] * g[2],
                                   1e-12f));
  const float nx = g[0] / len, ny = g[1] / len, nz = g[2] / len;
  const float lambert = vpt_nmax(nx * a.lx + ny * a.ly + nz * a.lz, 0.0f);
  const float4 c = color(6);
  return make_float4(c.x * lambert, c.y * lambert, c.z * lambert, 1.0f);
}

// The colour of a fetched (value, channel 1) through the read-only cache:
// the TF row's lookup in mode kTf, or for two channels the packed 2D TF's.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ float4 iso_color(const A& a, float2 v) {
  if constexpr (kC == 0) {
    return vpt_tf1d_lookup<true>(a.tf_row, a.tw, v.x, kTf);
  } else {
    return vpt_color_rg<kBf16, kC, true>(a.tf_row, a.tw, kTf, a.tf_table,
                                         a.th, v);
  }
}

// kC is 0 for the headline's linear single-channel fetch, else an ext
// instance's channels, whose cells take the filter.
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ void iso_shade(const A& a,
                                          const float4* __restrict__ state,
                                          float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.width * a.height) return;
  const float4 s = __ldg(state + i);
  if (!(s.w > 0.0f)) {
    out[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return;
  }
  const float p[3] = {s.x, s.y, s.z};
  VptCell<int64_t> cell[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    float q[3];
    iso_tap(p, a.step, j, q);
    if constexpr (kC == 0) {
      cell[j] = vpt_cell<int64_t>(a.d, a.h, a.w, q[0], q[1], q[2]);
    } else {
      cell[j] = vpt_cell_filtered<int64_t>(a.d, a.h, a.w, q[0], q[1], q[2],
                                           a.filter);
    }
  }
  VptRowOf<kBf16, kC> row[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    row[j] = vpt_load_rows<kBf16, kC>(a.table, cell[j].row);
  }
  out[i] = iso_lambert(a, [&](int j) {
    return iso_color<kBf16, kTf, kC>(a, vpt_lerp_rg<kBf16, kC>(row[j],
                                                              cell[j]));
  });
}

template <bool kBf16, int kTf>
__global__ void __launch_bounds__(kThreads)
iso_shade_kernel(const VptIsoShadeArgs a, const float4* __restrict__ state,
                 float4* __restrict__ out) {
  iso_shade<kBf16, kTf, 0>(a, state, out);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows, the
// TF lookup mode kTf; 2: a two-channel volume and the 2D TF table).
template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
iso_shade_ext_kernel(const VptIsoShadeExt a, const float4* __restrict__ state,
                     float4* __restrict__ out) {
  iso_shade<kBf16, kTf, kC>(a, state, out);
}

// The halo instance (parallel/halo.py, a HaloScene display): a sample is
// the sum over the ranks of their masked slab-local values
// (vpt_tpu/parallel/halo.py:199-250), summed before the TF lookup.
// vpt_tpu's display (iso.py:109-130) samples the seven fetches of a hit
// one sample_color at a time, seven psums; here a display is two launches
// around ONE all-reduce of the hits' values, the same sums in fewer
// collectives, and only the hits move:
// - iso_halo_fetch_kernel reads every pixel's state once, writes white
//   where nothing was hit and gives each hit a slot by an ordered
//   compaction: a block is a tile of kTileRounds x kThreads pixels (four
//   a thread: fewer tiles take tickets and walk back, and a thread has
//   four states in flight; two a thread took the fetch 1.05x at 512^2
//   and 1.25x at 1024^2 on the H100, PERF.md §6), taken from a ticket
//   (so a tile's predecessors were all taken before it, and the
//   look-back always makes progress); warp ballots
//   count its hits in pixel order, and the tile's offset is the count of
//   the tiles before it by a decoupled look-back in the same launch (its
//   first warp reading 32 predecessors at a time), while the other warps
//   fetch their hits' taps.  So the slots follow pixel order, whatever
//   order the blocks run in, and every rank of a group (the same state)
//   lays out the same slots; an atomic slot counter would not.  A hit
//   writes its pixel index and its seven fetches' masked values (0 where
//   another rank owns the cell) at its slot, slot-major: the first 7 x
//   hits x kV floats are the whole payload of the all-reduce.  The taps
//   are placed through the slab's plane map (read through the cache: a
//   tile holds few hits, so no block stages it) with 32-bit rows below
//   2^31 slab rows, else 64.
// - iso_halo_shade_kernel runs over the slots only, one thread a slot: the
//   summed values' colours (iso_color) and the shade (iso_lambert) into
//   the hit's pixel.
// The last tile writes the hits' count on the card; where the group sums
// them the wrapper reads it (4 bytes), all-reduces the payload alone and
// sizes the shade's grid to the hits, else the shade reads the count on
// the card.  So on one slab a display equals the whole-scene kernel's bit
// for bit.  A HaloScene has no filter: kC is 0 (one channel, the TF row in
// mode kTf) or 2 (the value pair, the 2D TF).

// A tile's look-back word: its count (bits 0-31), its kind (bits 32-33:
// kTileCount its own hits, kTilePrefix the hits of it and every tile
// before it) and the display's epoch (bits 34-63), so that a word left by
// an earlier display reads as not yet written.
constexpr uint64_t kTileCount = 1, kTilePrefix = 2;
// a tile is kTileRounds x kThreads pixels, a thread's pixel a round
constexpr int kTileRounds = 4;

__device__ __forceinline__ uint64_t iso_tile_word(uint32_t epoch,
                                                  uint64_t kind,
                                                  uint32_t count) {
  return ((uint64_t)epoch << 34) | (kind << 32) | count;
}

__device__ __forceinline__ void iso_tile_publish(uint64_t* status, int tile,
                                                 uint64_t word) {
  atomicExch(reinterpret_cast<unsigned long long*>(status) + tile,
             (unsigned long long)word);
}

// The hits of the tiles before tile, by the 32 lanes of its block's first
// warp: the words of 32 predecessors at a time, newest first (lane l reads
// tile t - 1 - l, waiting until the display wrote it), until one of them
// holds its prefix; the counts up to the newest prefix are summed.  Tile
// 0 holds its prefix from the start, so the walk ends.
__device__ __forceinline__ uint32_t iso_tile_lookback(const uint64_t* status,
                                                      int tile,
                                                      uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t before = 0;
  for (int last = tile - 1; last >= 0; last -= 32) {
    const int t = last - lane;
    // past tile 0: a prefix of no hits
    uint64_t word = iso_tile_word(epoch, kTilePrefix, 0u);
    if (t >= 0) {
      do {
        word = *reinterpret_cast<const volatile uint64_t*>(status + t);
      } while ((uint32_t)(word >> 34) != epoch);
    }
    const unsigned prefix =
        __ballot_sync(0xffffffffu, ((word >> 32) & 3) == kTilePrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    uint32_t count = lane <= stop ? (uint32_t)word : 0u;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, step);
    before += count;
    if (prefix) break;
  }
  return before;
}

// The seven masked values of the hit at p (iso_tap's fetches placed
// through the slab's plane map; 0 where another rank owns the cell).
template <bool kBf16, int kC, class Row>
__device__ __forceinline__ void iso_halo_taps(const VptIsoHalo& a,
                                              const float4 s,
                                              float2 (&v)[kTaps]) {
  const float p[3] = {s.x, s.y, s.z};
  VptCell<Row> cell[kTaps];
  bool local[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    float q[3];
    iso_tap(p, a.step, j, q);
    cell[j] = vpt_slab_plane_cell<Row>(a.d, a.h, a.w, a.slab, a.planes, q[0],
                                       q[1], q[2], &local[j]);
  }
  VptRowOf<kBf16, kC> row[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
    if (local[j]) row[j] = vpt_load_rows<kBf16, kC>(a.table, cell[j].row);
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
    v[j] = local[j] ? vpt_lerp_rg<kBf16, kC>(row[j], cell[j])
                    : make_float2(0.0f, 0.0f);
}

template <bool kBf16, int kC, class Row>
__global__ void __launch_bounds__(kThreads)
iso_halo_fetch_kernel(const VptIsoHalo a, const float4* __restrict__ state,
                      float4* __restrict__ out, uint32_t epoch) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kV = kC == 2 ? 2 : 1;
  // each (round, warp)'s count of hits
  __shared__ uint32_t s_count[kTileRounds * kWarps];
  __shared__ int s_tile;
  __shared__ uint32_t s_before;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(a.ticket, 1u);
    // the last ticket: every block has taken its own, so the next display
    // starts from 0
    if (s_tile == (int)gridDim.x - 1) atomicExch(a.ticket, 0u);
  }
  __syncthreads();
  const int tile = s_tile;
  const int n = a.width * a.height;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the thread's pixels of the tile, one a round, their states at once
  int i[kTileRounds];
  float4 st[kTileRounds];
#pragma unroll
  for (int k = 0; k < kTileRounds; ++k) {
    i[k] = (tile * kTileRounds + k) * kThreads + (int)threadIdx.x;
    st[k] = i[k] < n ? __ldg(state + i[k])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // white where nothing was hit; a ballot of the hits a round and warp
  bool hit[kTileRounds];
  unsigned mask[kTileRounds];
#pragma unroll
  for (int k = 0; k < kTileRounds; ++k) {
    hit[k] = i[k] < n && st[k].w > 0.0f;
    if (i[k] < n && !hit[k]) out[i[k]] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    mask[k] = __ballot_sync(0xffffffffu, hit[k]);
    if (lane == 0) s_count[k * kWarps + warp] = __popc(mask[k]);
  }
  __syncthreads();
  // each hit's place in the tile, in pixel order (round-major), and the
  // tile's count
  uint32_t total = 0, offset[kTileRounds];
#pragma unroll
  for (int e = 0; e < kTileRounds * kWarps; ++e) {
#pragma unroll
    for (int k = 0; k < kTileRounds; ++k)
      if (e == k * kWarps + warp) offset[k] = total;
    total += s_count[e];
  }
  // the tile's own count at once, for the tiles after it to look back on;
  // then the first warp walks back and publishes the tile's prefix, which
  // ends the walks of the tiles after it here
  if (warp == 0) {
    if (lane == 0)
      iso_tile_publish(a.status, tile, iso_tile_word(
          epoch, tile == 0 ? kTilePrefix : kTileCount, total));
    const uint32_t before = iso_tile_lookback(a.status, tile, epoch);
    if (lane == 0) {
      if (tile > 0)
        iso_tile_publish(a.status, tile,
                         iso_tile_word(epoch, kTilePrefix, before + total));
      if (tile == (int)gridDim.x - 1) *a.count = (int)(before + total);
      s_before = before;
    }
  }
  // the hits' seven masked values, while the walk runs
  float2 v[kTileRounds][kTaps];
#pragma unroll
  for (int k = 0; k < kTileRounds; ++k)
    if (hit[k]) iso_halo_taps<kBf16, kC, Row>(a, st[k], v[k]);
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kTileRounds; ++k) {
    if (!hit[k]) continue;
    const uint32_t slot = s_before + offset[k] + __popc(mask[k] & below);
    a.pixel[slot] = i[k];
    float* o = a.value + (long long)slot * kTaps * kV;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      o[kV * j] = v[k][j].x;
      if (kV == 2) o[kV * j + 1] = v[k][j].y;
    }
  }
}

template <bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kThreads)
iso_halo_shade_kernel(const VptIsoHalo a, float4* __restrict__ out) {
  constexpr int kV = kC == 2 ? 2 : 1;
  const int hits = *a.count;
  // a slot's entry is read before its test against the count, so that the
  // two loads overlap: the scratch holds a slot for every pixel, and an
  // entry past the hits is left unused
  for (int slot = blockIdx.x * kThreads + threadIdx.x;
       slot < a.width * a.height; slot += gridDim.x * kThreads) {
    const int pixel = a.pixel[slot];
    const float* v = a.value + (long long)slot * kTaps * kV;
    float2 value[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      value[j] = make_float2(v[kV * j], kV == 2 ? v[kV * j + 1] : 0.0f);
    if (slot >= hits) return;
    out[pixel] = iso_lambert(a, [&](int j) {
      return iso_color<kBf16, kTf, kC>(a, value[j]);
    });
  }
}

using KernelHaloFetch = void (*)(const VptIsoHalo, const float4*, float4*,
                                 uint32_t);
using KernelHaloShade = void (*)(const VptIsoHalo, float4*);

template <class Row>
KernelHaloFetch pick_halo_fetch_row(int channels, int table_bf16) {
  if (channels == 2)
    return table_bf16 ? iso_halo_fetch_kernel<true, 2, Row>
                      : iso_halo_fetch_kernel<false, 2, Row>;
  if (channels != 1) return nullptr;
  return table_bf16 ? iso_halo_fetch_kernel<true, 0, Row>
                    : iso_halo_fetch_kernel<false, 0, Row>;
}

KernelHaloFetch pick_halo_fetch(int channels, int table_bf16, int rows64) {
  return rows64 ? pick_halo_fetch_row<int64_t>(channels, table_bf16)
                : pick_halo_fetch_row<int>(channels, table_bf16);
}

KernelHaloShade pick_halo_shade(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? iso_halo_shade_kernel<true, 0, 2>
                      : iso_halo_shade_kernel<false, 0, 2>;
  if (channels != 1) return nullptr;
  switch (tf_mode + 3 * table_bf16) {
    case 0: return iso_halo_shade_kernel<false, 0, 0>;
    case 1: return iso_halo_shade_kernel<false, 1, 0>;
    case 2: return iso_halo_shade_kernel<false, 2, 0>;
    case 3: return iso_halo_shade_kernel<true, 0, 0>;
    case 4: return iso_halo_shade_kernel<true, 1, 0>;
    case 5: return iso_halo_shade_kernel<true, 2, 0>;
    default: return nullptr;
  }
}

// The instantiation for a table type and TF lookup mode (tf1d.cuh's: a
// compile-time constant, so the lookup carries no branch).
using Kernel = void (*)(const VptIsoShadeArgs, const float4*, float4*);
using KernelExt = void (*)(const VptIsoShadeExt, const float4*, float4*);

template <bool kBf16>
Kernel pick_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return iso_shade_kernel<kBf16, 0>;
    case 1: return iso_shade_kernel<kBf16, 1>;
    case 2: return iso_shade_kernel<kBf16, 2>;
    default: return nullptr;
  }
}

Kernel pick(int table_bf16, int tf_mode) {
  return table_bf16 ? pick_tf<true>(tf_mode) : pick_tf<false>(tf_mode);
}

// The ext instance: one channel (a filtered volume) in float32 rows with
// each TF lookup mode, or two channels in either row type; null for
// anything else.
KernelExt pick_ext(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? iso_shade_ext_kernel<true, 0, 2>
                      : iso_shade_ext_kernel<false, 0, 2>;
  if (channels != 1 || table_bf16) return nullptr;
  switch (tf_mode) {
    case 0: return iso_shade_ext_kernel<false, 0, 1>;
    case 1: return iso_shade_ext_kernel<false, 1, 1>;
    case 2: return iso_shade_ext_kernel<false, 2, 1>;
    default: return nullptr;
  }
}

template <class K, class A>
cudaError_t launch_kernel(K kernel, const A& a, const void* state, void* out,
                          void* stream) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(
      ((long long)a.width * a.height + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, (const float4*)state, (float4*)out);
  return cudaGetLastError();
}

cudaError_t launch(const VptIsoShadeExt& a, const void* state, void* out,
                   void* stream) {
  if (a.width <= 0 || a.height <= 0) return cudaSuccess;
  if (a.channels != 1 || a.filter != 0) {
    if (a.filter < 0 || a.filter > 2) return cudaErrorInvalidValue;
    return launch_kernel(pick_ext(a.channels, a.table_bf16, a.tf_mode), a,
                         state, out, stream);
  }
  const VptIsoShadeArgs& base = a;
  return launch_kernel(pick(a.table_bf16, a.tf_mode), base, state, out,
                       stream);
}

template <class K>
cudaError_t info(K kernel, int device, int* out) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int values[] = {kThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
  for (int k = 0; k < 6; ++k) out[k] = values[k];
  return cudaSuccess;
}

}  // namespace

// One display: prepared is the VptIsoShadeExt of the scene, Params and
// resolution; state the (height, width, 4) hits, out the image.
extern "C" int vpt_iso_shade_launch(const void* prepared, const void* state,
                                    void* out, void* stream) {
  const VptIsoShadeExt& a = *static_cast<const VptIsoShadeExt*>(prepared);
  VptDeviceGuard guard(a.device);
  return (int)launch(a, state, out, stream);
}

// The same display through the argument list the shade kernel has taken
// since it was ported (every build of it exports this), on the current
// device.
extern "C" int vpt_iso_shade(
    const void* state, void* out, const void* table, int table_bf16, int d,
    int h, int w, const void* tf_row, int tw, int tf_mode, int width,
    int height, float step, float two_step, float lx, float ly, float lz,
    void* stream) {
  VptIsoShadeExt a;
  a.table = table;
  a.tf_row = (const float4*)tf_row;
  a.table_bf16 = table_bf16;
  a.d = d; a.h = h; a.w = w;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.width = width; a.height = height;
  a.step = step; a.two_step = two_step;
  a.lx = lx; a.ly = ly; a.lz = lz;
  a.device = 0;
  a.tf_table = nullptr;
  a.th = 0;
  a.channels = 1;
  a.filter = 0;
  return (int)launch(a, state, out, stream);
}

// The launch shape of the instance `flags` (1: a table of bf16 rows, else
// float32; 2: an ext instance of one channel, 4: of two) for the TF lookup
// mode `tf_mode` on `device`: out = threads a block, resident blocks an
// SM, SMs, registers a thread, local (spilled) bytes a thread, static
// shared bytes a block.  Launches nothing.
extern "C" int vpt_iso_shade_info(int flags, int tf_mode, int device,
                                  int* out) {
  VptDeviceGuard guard(device);
  const int bf16 = flags & 1;
  if (flags & 6)
    return (int)info(pick_ext((flags & 4) ? 2 : 1, bf16, tf_mode), device,
                     out);
  return (int)info(pick(bf16, tf_mode), device, out);
}

// 0 where the prepared halo display is one its launches can run, else a
// CUDA error code: prepared is the VptIsoHalo of the HaloScene, Params and
// resolution (table: the rank's slab rows; d, h, w the whole volume's; no
// filter; the slab's plane map, the scratch, zeroed where the fetch
// starts from it (the ticket, the look-back words), the slab and the rows'
// index width), so a launch checks nothing of it.  Launches nothing.
extern "C" int vpt_iso_halo_check(const void* prepared) {
  const VptIsoHalo& a = *static_cast<const VptIsoHalo*>(prepared);
  VptDeviceGuard guard(a.device);
  const VptSlab& slab = a.slab;
  if (a.filter != 0 || a.width < 0 || a.height < 0 || slab.count < 1
      || slab.interleave < 1 || slab.index < 0 || slab.index >= slab.count
      || a.d % (slab.count * slab.interleave) != 0 || a.planes == nullptr
      || a.value == nullptr || a.pixel == nullptr || a.status == nullptr
      || a.ticket == nullptr || a.count == nullptr || a.shade_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (pick_halo_fetch(a.channels, a.table_bf16, a.rows64) == nullptr
      || pick_halo_shade(a.channels, a.table_bf16, a.tf_mode) == nullptr)
    return (int)cudaErrorInvalidValue;
  return cudaSuccess;
}

// A stage of a checked halo display: 0 the fetch (white into out where
// state holds no hit, the hits' slots; epoch, 1 to 2^30 - 1, differs from
// the display before's), then with read (pinned host memory) the copy of
// the hits' count into it; 1 the shade of the summed values into out,
// over ceil(hits / 128) blocks where hits >= 0 (the count read), else over
// the prepared grid reading the count on the card.
extern "C" int vpt_iso_halo_launch(const void* prepared, const void* state,
                                   void* out, int epoch, int stage,
                                   int hits, void* read, void* stream) {
  const VptIsoHalo& a = *static_cast<const VptIsoHalo*>(prepared);
  VptDeviceGuard guard(a.device);
  if (epoch < 1 || epoch >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)a.width * a.height;
  if (stage == 0) {
    if (n > 0) {
      const KernelHaloFetch fetch = pick_halo_fetch(a.channels,
                                                    a.table_bf16, a.rows64);
      if (fetch == nullptr) return (int)cudaErrorInvalidValue;
      constexpr int kTile = kTileRounds * kThreads;
      const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
      fetch<<<tiles, kThreads, 0, s>>>(a, (const float4*)state,
                                       (float4*)out, (uint32_t)epoch);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    } else if (read != nullptr) {
      *static_cast<int*>(read) = 0;
      return cudaSuccess;
    }
    if (read == nullptr) return cudaSuccess;
    return (int)cudaMemcpyAsync(read, a.count, sizeof(int),
                                cudaMemcpyDeviceToHost, s);
  }
  if (stage != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const KernelHaloShade shade = pick_halo_shade(a.channels, a.table_bf16,
                                                a.tf_mode);
  if (shade == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = hits > 0
      ? (unsigned)((hits + kThreads - 1) / kThreads)
      : hits == 0 ? 1u : (unsigned)a.shade_blocks;
  shade<<<blocks, kThreads, 0, s>>>(a, (float4*)out);
  return (int)cudaGetLastError();
}

// The launch shape of the halo instance's stage (0 the fetch, 1 the shade)
// for flags (1 bf16 rows, 4 two channels, 16 64-bit rows, the fetch's) and
// the TF lookup mode on `device`: vpt_iso_shade_info's values.  Launches
// nothing.
extern "C" int vpt_iso_halo_info(int stage, int flags, int tf_mode,
                                 int device, int* out) {
  VptDeviceGuard guard(device);
  const int channels = (flags & 4) ? 2 : 1;
  if (stage == 0)
    return (int)info(pick_halo_fetch(channels, flags & 1,
                                     (flags & 16) ? 1 : 0), device, out);
  return (int)info(pick_halo_shade(channels, flags & 1, tf_mode), device,
                   out);
}
