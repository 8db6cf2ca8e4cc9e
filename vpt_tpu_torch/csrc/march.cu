// March kernel: one progressive frame of a fixed-schedule renderer (EAM,
// MIP, Depth, ISO), generate and integrate, one thread a pixel.
//
// Replaces the XLA lax.scan of vpt_tpu/renderers/_march.py:29-55 (march)
// with the composites of eam.py:61-67, mip.py:44-46, depth.py:60-67 and
// iso.py:83-90 and the integrates of their render_frame, and the clamps of
// base.py:460-477 (march_interval) and iso.py:38-66
// (_march_interval_iso).  It has no Pallas
// original; its corner fetch and TF lookup are the device functions of
// ray.cuh and tf1d.cuh (vpt_tpu/pallas/tf1d.py:74-100, and the corner row of
// benchmarks/pallas_gather.py).
//
// Bound on the H100: a slice is one 16-byte (bf16) or 32-byte (f32)
// corner-row read and ~100-125 instructions (SASS of the bf16 slice loop:
// the position and cell ~30, the lerps ~30, the TF lookup ~25-35, the
// composite and the exit test up to ~20); a pixel's ray setup is ~66 float
// operations with 14 IEEE divisions.  On the 512^2 headline a frame takes
// ~5 M samples from ~1 M distinct corner rows, which with the state (16
// bytes a pixel, read and written once) are ~25 MB: 0.0071-0.0077 ms at
// 3.35 TB/s.  Issuing the slices' instructions takes longer, ~0.015-0.021
// ms at 1.98 GHz (the slices the warps step through, over 132 SMs x 4
// warp-instructions a clock).  Measured, the kernel runs at about twice
// that issue floor, and neither fewer instructions (-15-25% a slice), nor
// more rows in flight (3 to 16 a chunk), nor more residency moved it much;
// tiles did (PERF.md §6): what is left is each warp's chain of dependent
// work a slice (exit test, lerps, the TF lookup's shared loads, composite)
// with 5-7 warps a scheduler, and the L1 requests of ~10 sectors a warp
// read.
//
// Design: one thread a pixel keeps its ray and its composite's carry in
// registers and touches the state once a frame, reading it first so that
// its latency overlaps the march.  A slice's position depends on its index
// alone, so the kernel computes the cells of the next kChunk slices and
// issues all their row reads before it folds the first: the reads of a
// chunk overlap one another instead of each waiting for the last.  The
// fold then runs slice by slice in schedule order with the renderer's exit
// test, so a chunk's reads past the pixel's exit are issued and dropped
// (~1% more reads on the headline, as chip_smoke.py models them from the
// plain frame's samples).  Rows are indexed with 32-bit integers, which
// kernels/march.py allows for tables below 2^31 rows.
// Warps cover 8 x 4 pixel tiles of 16 x 8 blocks (ray.cuh), so that a
// warp's rays read neighbouring rows (rows of 128 pixels took 1.3-1.9x the
// time) and leave their loops at similar slices.  The composite and the TF
// lookup mode are template parameters, so a slice carries no branch but
// its exit test; the register allocation allows 6 blocks of 128 an SM.
// The TF row and the inverse MVP sit in shared memory; NDC comes from the
// pixel index.  A scene with an occupied box (march_clamp) or an ISO box
// (iso_clamp_min) launches the clamp instance: the host lists the boxes
// that hold for the frame's Params (ISO's depend on the isovalue), and the
// kernel intersects the cube's interval with each after the slab test.
// Positions still depend on the slice index alone, so the read-ahead
// holds; a launch without a box runs the headline's code as it was.  A pixel whose ray misses the cube samples nothing (its
// frame is fixed); EAM and Depth leave once the pixel goes inactive (the
// carry never changes after that); ISO marches its schedule from the near
// end and stops at the first hit, which is the JAX backward march's last
// write; MIP runs every slice.  The launch takes its scene, Params and
// resolution as one pointer to a VptMarchExt that the wrapper prepares
// once, and the frame's two scalars by value.  Two-channel and filtered
// volumes run march_ext_kernel, the same body (march) with ray.cuh's ext
// fetch (the filter a warp-uniform argument; 64 bytes of rows read ahead,
// so half the rows of two channels) and, for two channels, the 2D TF rows
// through the read-only cache; make_scene builds no clamp box for them.
//
// A HaloScene's frame (a rank's z slab) runs march_halo_kernel (below): the
// same fold, split around an all-reduce of each chunk of 8 slices' values.
//
// Numerics follow the plain PyTorch frame (renderers/eam.py, mip.py,
// depth.py, iso.py) operation by operation: built with -fmad=false, IEEE
// division and sqrt, NaN-propagating min/max.  MIP's fmod(x, 1) of its
// schedule x = offset + s*step, never below +0, is x - floor(x): exact, as
// fmod is, since floor(x) is 0 or lies in [x/2, x] (Sterbenz's lemma).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

// What a launch takes of its scene, Params and resolution, filled once by
// the wrapper (kernels/march.py, a ctypes Structure of this layout).
struct VptMarchArgs {
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  const float4* tf_row;  // (tw, 4)
  const float* mvp;      // 16 floats, row-major inverse MVP
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  int mode;              // kEam, kMip, kDepth, kIso
  int width, height;     // the image; n = width * height
  int slices;
  float step;            // the schedule's step
  float extinction;      // EAM, Depth
  float level;           // Depth: the threshold; ISO: the isovalue
  int device;
  int row0, full_height; // the launch's rows of the image: [row0,
                         // row0 + height) of full_height rows
};

// The prepared arguments with the clamp boxes that hold for the launch's
// Params.  Only the clamp instances take it: the others take the base, so
// their argument, and with it their code, is the one they had before the
// boxes.
struct VptMarchClamp : VptMarchArgs {
  int boxes;             // clamp boxes that apply: 0, 1 or 2
  float box[12];         // box b: lo xyz at 6b, hi xyz at 6b + 3
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, ray.cuh) take besides; only they read it.
struct VptMarchExt : VptMarchClamp {
  const void* tf_table;  // (th*tw, 16) packed TF of the table's type
  int th;
  int channels;          // 1 or 2: with filter 0 and 1 channel, no ext
  int filter;            // ray.cuh's VptFilter
};

namespace {

enum Mode { kEam = 0, kMip = 1, kDepth = 2, kIso = 3 };

// corner rows read ahead of the fold: 4 bf16 rows, or 2 float32 rows (they
// take twice the registers)
template <bool kBf16>
constexpr int kChunk = kBf16 ? 4 : 2;
// the same 64 bytes of rows of kC channels (kC = 0: the headline's)
template <bool kBf16, int kC>
constexpr int kChunkOf = kC == 2 ? kChunk<kBf16> / 2 : kChunk<kBf16>;
// resident blocks an SM that the register allocation must allow
constexpr int kMinBlocks = 6;

// the cell of a slice, its row indexed with 32 bits
using Cell = VptCell<int>;

// MIP's slice: fmod(x, 1) of its schedule value x >= +0 (see the note
// above)
__device__ __forceinline__ float wrap_unit(float x) {
  return x - floorf(x);
}

// The n slices j = 0 .. n-1 at schedule value t_of(j), a chunk of C at a
// time: the chunk's rows are read first, then fold(t, get) runs on each
// slice in order until it returns false (the pixel leaves its loop); get()
// is the slice's color(row, cell), looked up only where the fold asks.
// kC is 0 for the headline's linear single-channel fetch, else an ext
// instance's channels, whose cells take the filter.
template <bool kBf16, int kC, class Schedule, class Color, class Fold>
__device__ __forceinline__ void march_slices(const VptMarchArgs& a,
                                             int filter, int n,
                                             const float start[3],
                                             const float seg[3],
                                             Schedule t_of, Color color,
                                             Fold fold) {
  constexpr int C = kChunkOf<kBf16, kC>;
  for (int j0 = 0; j0 < n; j0 += C) {
    float ts[C];
    Cell cell[C];
    VptRowOf<kBf16, kC> row[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ts[k] = t_of(j0 + k);
      const float px = start[0] + ts[k] * seg[0];
      const float py = start[1] + ts[k] * seg[1];
      const float pz = start[2] + ts[k] * seg[2];
      if constexpr (kC == 0) {
        cell[k] = vpt_cell<int>(a.d, a.h, a.w, px, py, pz);
      } else {
        cell[k] = vpt_cell_filtered<int>(a.d, a.h, a.w, px, py, pz, filter);
      }
      if (j0 + k < n)
        row[k] = vpt_load_rows<kBf16, kC>(a.table, cell[k].row);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (j0 + k >= n
          || !fold(ts[k], [&] { return color(row[k], cell[k]); }))
        return;
    }
  }
}

// the argument a launch of the clamp instance or of the others takes
template <bool kClamp>
using ArgsOf = std::conditional_t<kClamp, VptMarchClamp, VptMarchArgs>;

// A pixel's ray (_march.rays): unproject, the slab test clamped at 0 and,
// with kClamp, the interval intersected with each of the launch's boxes;
// the marched segment runs from start to start + seg.
struct MarchRay {
  float tb0, tb1;
  float start[3], seg[3];
  bool miss;
};

template <bool kClamp, class A>
__device__ __forceinline__ MarchRay march_ray(const A& a, const float* s_mvp,
                                              int x, int y) {
  const float ndcx = vpt_pixel_ndc(x, a.width);
  const float ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
  float from[3], to[3], dir[3];
  vpt_unproject(s_mvp, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  MarchRay r;
  r.tb0 = vpt_nmax(tnear, 0.0f);
  r.tb1 = vpt_nmax(tfar, 0.0f);
  if constexpr (kClamp) {
    // the interval intersected with each box's, clamped at 0, in the
    // order the host lists them (base.march_interval, iso.march_interval)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b < a.boxes) {
        const float lo[3] = {a.box[6 * b], a.box[6 * b + 1],
                             a.box[6 * b + 2]};
        const float hi[3] = {a.box[6 * b + 3], a.box[6 * b + 4],
                             a.box[6 * b + 5]};
        float bn, bf;
        vpt_intersect_box(from, dir, lo, hi, &bn, &bf);
        r.tb0 = vpt_nmax(r.tb0, vpt_nmax(bn, 0.0f));
        r.tb1 = vpt_nmin(r.tb1, vpt_nmax(bf, 0.0f));
      }
    }
  }
  r.miss = r.tb0 >= r.tb1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.start[k] = from[k] + r.tb0 * dir[k];
    r.seg[k] = (from[k] + r.tb1 * dir[k]) - r.start[k];
  }
  return r;
}

// EAM's and Depth's step length along the segment (0 for MIP and ISO)
template <int kMode>
__device__ __forceinline__ float march_step_length(const MarchRay& r,
                                                   float step) {
  if (kMode != kEam && kMode != kDepth) return 0.0f;
  const float len = sqrtf(r.seg[0] * r.seg[0] + r.seg[1] * r.seg[1]
                          + r.seg[2] * r.seg[2]);
  return len * step;
}

// Slice j's schedule value of n: EAM and Depth first + j*step, MIP its
// fmod(., 1), ISO first - (n-1-j)*step (the nearest hit: the schedule from
// its near end, the largest s first).
template <int kMode>
__device__ __forceinline__ float march_t(float first, float step, int j,
                                         int n) {
  if (kMode == kMip) return wrap_unit(first + (float)j * step);
  if (kMode == kIso) return first - (float)(n - 1 - j) * step;
  return first + (float)j * step;
}

// The composite's carry of a pixel: EAM's accumulator; Depth's t and its
// opacity (x, y); MIP's maximum (x); ISO's nearest hit (position, t), -1
// while there is none.
template <int kMode>
__device__ __forceinline__ float4 march_carry(float first) {
  if (kMode == kDepth) return make_float4(first, 0.0f, 0.0f, 0.0f);
  if (kMode == kIso) return make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Whether a pixel still folds at schedule value ts: EAM's and Depth's
// activity, MIP always, ISO until its hit (a hit's t, in the marched
// segment, is never -1).
template <int kMode>
__device__ __forceinline__ bool march_live(const float4& c, float ts,
                                           float level) {
  if (kMode == kEam) return ts < 1.0f && c.w < 0.99f;
  if (kMode == kDepth) return c.x < 1.0f && c.y < level;
  if (kMode == kIso) return c.w == -1.0f;
  return true;
}

// One slice of the renderer's composite at ts: false where the pixel
// leaves its loop, before the slice (EAM, Depth: inactive for good, the
// carry never changes after that) or after it (ISO's hit).  get() is the
// slice's colour, looked up only where the fold reads it (MIP and ISO read
// its alpha).
template <int kMode, class Get>
__device__ __forceinline__ bool march_fold(float4& c, float ts, Get get,
                                           float rsl, const VptMarchArgs& a,
                                           const MarchRay& r) {
  if (kMode == kEam) {
    if (!march_live<kEam>(c, ts, a.level)) return false;
    const float4 col = get();
    const float alpha = col.w * rsl * a.extinction;
    const float k = 1.0f - c.w;
    c.x = c.x + k * (col.x * alpha);
    c.y = c.y + k * (col.y * alpha);
    c.z = c.z + k * (col.z * alpha);
    c.w = c.w + k * alpha;
    return true;
  } else if (kMode == kDepth) {
    if (!march_live<kDepth>(c, ts, a.level)) return false;
    c.y = c.y + (1.0f - c.y) * get().w * rsl * a.extinction;
    c.x = c.x + a.step;
    return true;
  } else if (kMode == kMip) {
    c.x = vpt_nmax(c.x, get().w);
    return true;
  } else {
    if (get().w >= a.level) {
      c = make_float4(r.start[0] + ts * r.seg[0], r.start[1] + ts * r.seg[1],
                      r.start[2] + ts * r.seg[2], ts);
      return false;
    }
    return true;
  }
}

// The frame of a pixel's carry into its state, which held s0 (MIP: m0):
// EAM's normalised colour and Depth's depth through the running mean
// state + (frame - state) * (1/n), MIP's maximum, ISO's nearer hit.
template <int kMode>
__device__ __forceinline__ void march_store(float* __restrict__ state, int i,
                                            float4 c, const MarchRay& r,
                                            float level, float mix, float4 s0,
                                            float m0) {
  float4* st = reinterpret_cast<float4*>(state) + i;
  if (kMode == kEam || kMode == kDepth) {
    float4 frame;
    if (kMode == kEam) {
      if (c.w > 1.0f) {
        const float den = vpt_nmax(c.w, 1e-6f);
        c.x = c.x / den;
        c.y = c.y / den;
        c.z = c.z / den;
      }
      frame = r.miss ? make_float4(0.0f, 0.0f, 0.0f, 1.0f)
                     : make_float4(c.x, c.y, c.z, 1.0f);
    } else {
      float depth = r.tb0 + c.x * (r.tb1 - r.tb0);
      if (c.y < level || r.miss) depth = -1.0f;
      frame = make_float4(depth, 0.0f, 0.0f, 1.0f);
    }
    s0.x = s0.x + (frame.x - s0.x) * mix;
    s0.y = s0.y + (frame.y - s0.y) * mix;
    s0.z = s0.z + (frame.z - s0.z) * mix;
    s0.w = s0.w + (frame.w - s0.w) * mix;
    *st = s0;
  } else if (kMode == kMip) {
    state[i] = vpt_nmax(m0, c.x);
  } else {
    // keep the nearer of the frame's and the accumulated hits
    const bool take = (c.w > 0.0f && s0.w > 0.0f) ? c.w < s0.w : c.w > 0.0f;
    if (take) *st = c;
  }
}

// The colour of a fetched (value, channel 1): the TF row's lookup in mode
// kTf, or for two channels the packed 2D TF's (kC as in march_slices).
template <bool kBf16, int kTf, int kC, class A>
__device__ __forceinline__ float4 march_color(const float4* s_tf, const A& a,
                                              float2 v) {
  if constexpr (kC == 0) {
    return vpt_tf1d_lookup(s_tf, a.tw, v.x, kTf);
  } else {
    return vpt_color_rg<kBf16, kC>(s_tf, a.tw, kTf, a.tf_table, a.th, v);
  }
}

// One frame of mode kMode; kC as in march_slices.
template <int kMode, bool kBf16, int kTf, bool kClamp, int kC, class A>
__device__ __forceinline__ void march(const A& a, float* __restrict__ state,
                                      float first, float mix) {
  // dynamic: the TF row (tw float4); a two-channel scene reads the 2D TF
  // table instead
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  if (kC != 2)
    for (int i = threadIdx.x; i < a.tw; i += blockDim.x)
      s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  __syncthreads();
  int x, y;
  if (!vpt_tile_pixel(a.width, a.height, &x, &y)) return;
  const int i = y * a.width + x;
  // the state, read first, so that its latency overlaps the march's
  float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m0 = 0.0f;
  if (kMode == kMip) m0 = state[i];
  else s0 = reinterpret_cast<const float4*>(state)[i];

  const MarchRay r = march_ray<kClamp>(a, s_mvp, x, y);
  const int n = r.miss ? 0 : a.slices;
  const float step = a.step;
  const float rsl = march_step_length<kMode>(r, step);
  using Row = VptRowOf<kBf16, kC>;
  int filter = 0;
  if constexpr (kC != 0) filter = a.filter;
  float4 c = march_carry<kMode>(first);
  march_slices<kBf16, kC>(
      a, filter, n, r.start, r.seg,
      [&](int j) { return march_t<kMode>(first, step, j, n); },
      // the slice's color: the headline's lookup, or an ext instance's
      [&](const Row& row, const Cell& cell) {
        return march_color<kBf16, kTf, kC>(
            s_tf, a, vpt_lerp_rg<kBf16, kC>(row, cell));
      },
      [&](float ts, auto get) {
        return march_fold<kMode>(c, ts, get, rsl, a, r);
      });
  march_store<kMode>(state, i, c, r, a.level, mix, s0, m0);
}

template <int kMode, bool kBf16, int kTf, bool kClamp>
__global__ void __launch_bounds__(kVptTileThreads, kMinBlocks)
march_kernel(const ArgsOf<kClamp> a, float* __restrict__ state, float first,
             float mix) {
  march<kMode, kBf16, kTf, kClamp, 0>(a, state, first, mix);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows, the
// TF lookup mode kTf; 2: a two-channel volume and the 2D TF table), no
// boxes (make_scene builds none for these scenes).
template <int kMode, bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kVptTileThreads, kMinBlocks)
march_ext_kernel(const VptMarchExt a, float* __restrict__ state,
                 float first, float mix) {
  march<kMode, kBf16, kTf, false, kC>(a, state, first, mix);
}

// The halo instance (parallel/halo.py, a HaloScene frame): the volume is z
// slabs over the ranks of a group, each rank holding its slab's corner rows,
// and a sample is the sum over the ranks of their masked slab-local values
// (vpt_tpu/parallel/halo.py:143-166, 199-250), an all-reduce between the
// fetch and the TF lookup: the TF is not linear, so the ranks sum values,
// never colours, and the masked zeros make the sum exact.  vpt_tpu's march
// (_march.py:29-55) samples kHaloChunk slices a sample_color, one psum
// each; so does this instance.  A frame of S slices is C = ceil(S /
// kHaloChunk) + 1 launches on the state, the wrapper all-reducing the
// values between them: launch e folds chunk e - 1's summed values in order
// (march_fold, the TF lookup of march_color; launch 0 starts the carry),
// then writes chunk e's masked values (slab.cuh's cell; 0 where another
// rank owns it, and for every slice of a pixel that has left its loop:
// every rank holds the same carry, so every rank skips it alike); the last
// launch stores the frame (march_store).  Between launches a pixel keeps
// its composite's carry (a float4, exact) in carry; its ray comes again
// from the pixel index.  So on one slab a frame equals the whole-scene
// kernel's bit for bit.  A HaloScene has no clamp box and no filter; its
// volume has one channel (kC = 0, the TF row in mode kTf) or two (kC = 2:
// the value pair summed, then the 2D TF), its slabs contiguous or
// interleaved, the fetch masked or not (slab.cuh).
constexpr int kHaloChunk = 8;

template <int kMode, bool kBf16, int kTf, int kC>
__global__ void __launch_bounds__(kVptTileThreads, kMinBlocks)
march_halo_kernel(const VptMarchExt a, const VptSlab slab,
                  float* __restrict__ value, float4* __restrict__ carry,
                  float* __restrict__ state, float first, float mix,
                  int chunk) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  if (kC != 2 && chunk > 0)
    for (int i = threadIdx.x; i < a.tw; i += blockDim.x)
      s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  __syncthreads();
  int x, y;
  if (!vpt_tile_pixel(a.width, a.height, &x, &y)) return;
  constexpr int kV = kC == 2 ? 2 : 1;  // values a sample
  const int i = y * a.width + x;
  const long long pixels = (long long)a.width * a.height;
  const MarchRay r = march_ray<false>(a, s_mvp, x, y);
  const int n = r.miss ? 0 : a.slices;
  const float step = a.step;
  const int chunks = (a.slices + kHaloChunk - 1) / kHaloChunk;
  float4 c = chunk == 0 ? march_carry<kMode>(first) : carry[i];
  if (chunk > 0) {
    const float rsl = march_step_length<kMode>(r, step);
    const int j0 = (chunk - 1) * kHaloChunk;
    for (int k = 0; k < kHaloChunk && j0 + k < n; ++k) {
      const float ts = march_t<kMode>(first, step, j0 + k, n);
      if (!march_live<kMode>(c, ts, a.level)) break;
      const float* v = value + kV * ((long long)k * pixels + i);
      if (!march_fold<kMode>(c, ts, [&] {
            return march_color<kBf16, kTf, kC>(
                s_tf, a, make_float2(v[0], kV == 2 ? v[1] : 0.0f));
          }, rsl, a, r))
        break;
    }
  }
  if (chunk < chunks) {
    const int j0 = chunk * kHaloChunk;
    const bool live =
        j0 < n && march_live<kMode>(c, march_t<kMode>(first, step, j0, n),
                                    a.level);
#pragma unroll
    for (int k = 0; k < kHaloChunk; ++k) {
      float2 v = make_float2(0.0f, 0.0f);
      if (live && j0 + k < n) {
        const float ts = march_t<kMode>(first, step, j0 + k, n);
        const VptSlabCell cell = vpt_slab_cell(
            a.d, a.h, a.w, slab, r.start[0] + ts * r.seg[0],
            r.start[1] + ts * r.seg[1], r.start[2] + ts * r.seg[2]);
        if (cell.local) v = vpt_slab_value<kBf16, kC>(a.table, cell);
      }
      float* out = value + kV * ((long long)k * pixels + i);
      out[0] = v.x;
      if (kV == 2) out[1] = v.y;
    }
    carry[i] = c;
  } else {
    float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float m0 = 0.0f;
    if (kMode == kMip) m0 = state[i];
    else s0 = reinterpret_cast<const float4*>(state)[i];
    march_store<kMode>(state, i, c, r, a.level, mix, s0, m0);
  }
}

using KernelHalo = void (*)(const VptMarchExt, const VptSlab, float*,
                            float4*, float*, float, float, int);

// The halo instance for a mode, a table type, the TF lookup mode (one
// channel) or two channels; null for anything else.
template <int kMode>
KernelHalo pick_halo_tf(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? march_halo_kernel<kMode, true, 0, 2>
                      : march_halo_kernel<kMode, false, 0, 2>;
  if (channels != 1) return nullptr;
  switch (tf_mode + 3 * table_bf16) {
    case 0: return march_halo_kernel<kMode, false, 0, 0>;
    case 1: return march_halo_kernel<kMode, false, 1, 0>;
    case 2: return march_halo_kernel<kMode, false, 2, 0>;
    case 3: return march_halo_kernel<kMode, true, 0, 0>;
    case 4: return march_halo_kernel<kMode, true, 1, 0>;
    case 5: return march_halo_kernel<kMode, true, 2, 0>;
    default: return nullptr;
  }
}

KernelHalo pick_halo(int mode, int channels, int table_bf16, int tf_mode) {
  if (tf_mode < 0 || tf_mode > 2) return nullptr;
  switch (mode) {
    case kEam: return pick_halo_tf<kEam>(channels, table_bf16, tf_mode);
    case kMip: return pick_halo_tf<kMip>(channels, table_bf16, tf_mode);
    case kDepth: return pick_halo_tf<kDepth>(channels, table_bf16, tf_mode);
    case kIso: return pick_halo_tf<kIso>(channels, table_bf16, tf_mode);
    default: return nullptr;
  }
}

size_t dynamic_smem(int tw) { return (size_t)tw * sizeof(float4); }

// The instantiation for a launch's mode, table type and TF lookup mode
// (tf1d.cuh's: a compile-time constant, so the lookup carries no branch).
// With kClamp the interval is clamped to the launch's boxes; without, the
// headline's code runs as it was.
template <bool kClamp>
using Kernel = void (*)(const ArgsOf<kClamp>, float*, float, float);
using KernelExt = void (*)(const VptMarchExt, float*, float, float);

template <int kMode, bool kBf16, bool kClamp>
Kernel<kClamp> pick_tf(int tf_mode) {
  switch (tf_mode) {
    case 0: return march_kernel<kMode, kBf16, 0, kClamp>;
    case 1: return march_kernel<kMode, kBf16, 1, kClamp>;
    case 2: return march_kernel<kMode, kBf16, 2, kClamp>;
    default: return nullptr;
  }
}

template <bool kBf16, bool kClamp>
Kernel<kClamp> pick_mode(int mode, int tf_mode) {
  switch (mode) {
    case kEam: return pick_tf<kEam, kBf16, kClamp>(tf_mode);
    case kMip: return pick_tf<kMip, kBf16, kClamp>(tf_mode);
    case kDepth: return pick_tf<kDepth, kBf16, kClamp>(tf_mode);
    case kIso: return pick_tf<kIso, kBf16, kClamp>(tf_mode);
    default: return nullptr;
  }
}

template <bool kClamp>
Kernel<kClamp> pick(int mode, int table_bf16, int tf_mode) {
  return table_bf16 ? pick_mode<true, kClamp>(mode, tf_mode)
                    : pick_mode<false, kClamp>(mode, tf_mode);
}

// The ext instance: one channel (a filtered volume) in float32 rows with
// each TF lookup mode, or two channels in either row type (the 2D TF
// lookup has no mode); null for anything else.
template <int kMode>
KernelExt pick_ext_tf(int channels, int table_bf16, int tf_mode) {
  if (channels == 2)
    return table_bf16 ? march_ext_kernel<kMode, true, 0, 2>
                      : march_ext_kernel<kMode, false, 0, 2>;
  if (channels != 1 || table_bf16) return nullptr;
  switch (tf_mode) {
    case 0: return march_ext_kernel<kMode, false, 0, 1>;
    case 1: return march_ext_kernel<kMode, false, 1, 1>;
    case 2: return march_ext_kernel<kMode, false, 2, 1>;
    default: return nullptr;
  }
}

KernelExt pick_ext(int mode, int channels, int table_bf16, int tf_mode) {
  switch (mode) {
    case kEam: return pick_ext_tf<kEam>(channels, table_bf16, tf_mode);
    case kMip: return pick_ext_tf<kMip>(channels, table_bf16, tf_mode);
    case kDepth: return pick_ext_tf<kDepth>(channels, table_bf16, tf_mode);
    case kIso: return pick_ext_tf<kIso>(channels, table_bf16, tf_mode);
    default: return nullptr;
  }
}

// Without opting in, a block gets 48 KiB of shared memory, static and
// dynamic together; a TF row near tf1d.MAX_WIDTH needs more.  The attribute
// belongs to the current device, so it is set on every such launch.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class K, class A>
cudaError_t launch_kernel(K kernel, const A& a, size_t smem, void* state,
                          float first, float mix, void* stream) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)vpt_tile_blocks(a.width, a.height);
  kernel<<<blocks, kVptTileThreads, smem, (cudaStream_t)stream>>>(
      a, (float*)state, first, mix);
  return cudaGetLastError();
}

// whether a launch runs an ext instance
bool is_ext(const VptMarchExt& p) {
  return p.channels != 1 || p.filter != 0;
}

cudaError_t launch(const VptMarchExt& p, void* state, float first,
                   float mix, void* stream) {
  if (p.width <= 0 || p.height <= 0) return cudaSuccess;
  if (p.boxes < 0 || p.boxes > 2 || p.row0 < 0
      || p.full_height < p.row0 + p.height)
    return cudaErrorInvalidValue;
  if (is_ext(p)) {
    if (p.boxes != 0 || p.filter < 0 || p.filter > 2)
      return cudaErrorInvalidValue;
    return launch_kernel(
        pick_ext(p.mode, p.channels, p.table_bf16, p.tf_mode), p,
        p.channels == 2 ? 0 : dynamic_smem(p.tw), state, first, mix, stream);
  }
  if (p.boxes > 0) {
    const VptMarchClamp& a = p;
    return launch_kernel(pick<true>(p.mode, p.table_bf16, p.tf_mode), a,
                         dynamic_smem(p.tw), state, first, mix, stream);
  }
  const VptMarchArgs& a = p;
  return launch_kernel(pick<false>(p.mode, p.table_bf16, p.tf_mode), a,
                       dynamic_smem(p.tw), state, first, mix, stream);
}

// The launch shape of a kernel for smem dynamic bytes on device: the
// values vpt_march_info writes, with chunk the rows it reads ahead.
template <class K>
cudaError_t info(K kernel, size_t smem, int chunk, int device, int* out) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kVptTileThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int values[] = {kVptTileThreads, per_sm, sms, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                        (int)smem, chunk, kVptTileW, kVptTileH, kVptWarpW};
  for (int k = 0; k < 11; ++k) out[k] = values[k];
  return cudaSuccess;
}

}  // namespace

// One frame: prepared is the VptMarchExt of the scene, Params and
// resolution; first is the schedule's first value (EAM, Depth: t0; MIP: the
// offset; ISO: 1 - offset*step), mix the running mean's weight 1/n.
extern "C" int vpt_march_launch(const void* prepared, void* state,
                                float first, float mix, void* stream) {
  const VptMarchExt& p = *static_cast<const VptMarchExt*>(prepared);
  VptDeviceGuard guard(p.device);
  return (int)launch(p, state, first, mix, stream);
}

// The same frame through the argument list the march kernel has taken
// since it was ported (every build of it exports this), on the current
// device.
extern "C" int vpt_march_frame(
    void* state, int mode, const void* table, int table_bf16, int d, int h,
    int w, const void* tf_row, int tw, int tf_mode, const void* mvp,
    int width, int height, int slices, float step, float first,
    float extinction, float level, float mix, void* stream) {
  VptMarchExt a;
  a.table = table;
  a.tf_row = (const float4*)tf_row;
  a.mvp = (const float*)mvp;
  a.table_bf16 = table_bf16;
  a.d = d; a.h = h; a.w = w;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.mode = mode;
  a.width = width; a.height = height;
  a.slices = slices;
  a.step = step;
  a.extinction = extinction;
  a.level = level;
  a.device = 0;
  a.row0 = 0;
  a.full_height = height;
  a.boxes = 0;
  a.tf_table = nullptr;
  a.th = 0;
  a.channels = 1;
  a.filter = 0;
  return (int)launch(a, state, first, mix, stream);
}

// The launch shape of mode `mode` for the instance `flags` (1: a table of
// bf16 rows, else float32; 2: the clamp instance; 4: an ext instance of
// one channel, 8: of two) and a TF row of `tw` texels in lookup mode
// `tf_mode` on `device`: out = threads a block, resident blocks an SM,
// SMs, registers a thread, local (spilled) bytes a thread, static and
// dynamic shared bytes a block, rows read ahead, the block's tile width
// and height and the warp's tile width in pixels.  Launches nothing.
extern "C" int vpt_march_info(int mode, int flags, int tw, int tf_mode,
                              int device, int* out) {
  VptDeviceGuard guard(device);
  const int bf16 = flags & 1;
  const int chunk = bf16 ? kChunk<true> : kChunk<false>;
  if (flags & 12) {
    const int channels = (flags & 8) ? 2 : 1;
    return (int)info(pick_ext(mode, channels, bf16, tf_mode),
                     channels == 2 ? 0 : dynamic_smem(tw),
                     channels == 2 ? chunk / 2 : chunk, device, out);
  }
  return (int)((flags & 2)
                   ? info(pick<true>(mode, bf16, tf_mode), dynamic_smem(tw),
                          chunk, device, out)
                   : info(pick<false>(mode, bf16, tf_mode), dynamic_smem(tw),
                          chunk, device, out));
}

// One launch of the halo instance (see march_halo_kernel): prepared is the
// VptMarchExt of the HaloScene, Params and resolution (table: the rank's
// slab rows, (slab planes * H * W, 8 * channels); d, h, w the whole
// volume's; no boxes, no filter); the slab: its index of num_slabs, the thin
// slabs a rank (interleave) and whether the fetch is masked; value the
// (kHaloChunk, width * height, channels) values between the launches,
// carry the (width * height, 4) carry; chunk e of 0 .. ceil(slices /
// kHaloChunk), the last storing the frame; first and mix as
// vpt_march_launch's.
extern "C" int vpt_march_halo_launch(const void* prepared, int slab_index,
                                     int num_slabs, int interleave,
                                     int masked, void* value, void* carry,
                                     void* state, float first, float mix,
                                     int chunk, void* stream) {
  const VptMarchExt& p = *static_cast<const VptMarchExt*>(prepared);
  VptDeviceGuard guard(p.device);
  if (p.width <= 0 || p.height <= 0) return cudaSuccess;
  const int chunks = (p.slices + kHaloChunk - 1) / kHaloChunk;
  if (p.boxes != 0 || p.filter != 0 || p.row0 < 0
      || p.full_height < p.row0 + p.height || chunk < 0 || chunk > chunks
      || num_slabs < 1 || interleave < 1 || slab_index < 0
      || slab_index >= num_slabs || p.d % (num_slabs * interleave) != 0)
    return (int)cudaErrorInvalidValue;
  const KernelHalo kernel = pick_halo(p.mode, p.channels, p.table_bf16,
                                      p.tf_mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = p.channels == 2 ? 0 : dynamic_smem(p.tw);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const VptSlab slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
  const unsigned blocks = (unsigned)vpt_tile_blocks(p.width, p.height);
  kernel<<<blocks, kVptTileThreads, smem, (cudaStream_t)stream>>>(
      p, slab, (float*)value, (float4*)carry, (float*)state, first, mix,
      chunk);
  return (int)cudaGetLastError();
}

// The launch shape of the halo instance of mode `mode` for flags (1: bf16
// rows, 8: two channels) and a TF row of `tw` texels in lookup mode
// `tf_mode` on `device`: vpt_march_info's values, with chunk the slices of
// a fetch (kHaloChunk).  Launches nothing.
extern "C" int vpt_march_halo_info(int mode, int flags, int tw, int tf_mode,
                                   int device, int* out) {
  VptDeviceGuard guard(device);
  const int channels = (flags & 8) ? 2 : 1;
  return (int)info(pick_halo(mode, channels, flags & 1, tf_mode),
                   channels == 2 ? 0 : dynamic_smem(tw), kHaloChunk, device,
                   out);
}
