// MCS kernel: one progressive frame of Monte-Carlo single scattering by
// delta tracking, generate and integrate, one thread a pixel.
//
// Replaces the XLA lax.while_loops of vpt_tpu/renderers/mcs.py:47-178
// (generate: sample_distance :86-118, sample_transmittance :120-152, the
// equirect Scene.sample_env of :169 and :174) and its integrate
// (:181-185).  It has no Pallas original; its RNG, ray setup,
// corner fetch and TF lookup are the device functions of ray.cuh and
// tf1d.cuh, which the MCM event kernel shares.
//
// Bound on the H100: a tracking step is one exponential draw (a logf), a
// division, one dependent corner-row read and a TF lookup, ~70 operations;
// a pixel runs ~1 + extinction x (path length) of them along its ray and
// as many along its shadow segment, plus ~120 of ray setup with 14 IEEE
// divisions (20 where it scatters).  The state is 16 bytes a pixel, read
// and written once.  With the default extinction (1) on the 512^2 headline
// a frame takes 0.16 M draws and 0.06 M fetches of ~0.06 M distinct rows
// (its own count): ~9.3 MB, 0.0028 ms at 3.35 TB/s, above its ~0.04 G
// operations.  It runs at ~4x that: the ray setup's divisions and the
// state's round trip are each pixel's chain of dependent latencies, and the
// frame is one short wave (~2048 blocks of 128 at 9 an SM).  Tiles,
// residency and reading the state first moved it by a few per cent
// (PERF.md §6); the frame's cost to the host, ~2x the card's, is what the
// launch path below cuts.
//
// Design: one thread a pixel runs both tracking loops in registers, each
// to the pixel's own exit (the JAX loop's done mask, pixel by pixel); a
// pixel whose ray misses the cube or escapes writes the environment texel
// without tracking the shadow segment.  The state is read first, so that
// its latency overlaps the tracking.  Warps cover 8 x 4 pixel tiles
// (ray.cuh), as in the march kernel.  The TF row, the inverse MVP and the
// 1x1 environment texel sit in shared memory; NDC and the stream seed come
// from the pixel index; the frame's scatter direction comes from the host.
// An environment map larger than 1x1 is a template instance beside the
// headline's, which reads the map (ray.cuh's vpt_sample_environment,
// through the read-only cache) for the light along the scatter direction
// where a pixel scatters and along the unit view ray where it misses or
// escapes.
// With a cheb-skip tracking table the free paths extend over empty cells
// and colors come from that table, as in the MCM event kernel.  The launch
// takes its scene, Params and resolution as one pointer to a VptMcsExt
// that the wrapper prepares once, and the frame's five scalars by value.
// Two-channel and filtered volumes run mcs_frame_ext_kernel, the same body
// (mcs_frame) with ray.cuh's ext fetch at its three fetch sites (the
// filter a warp-uniform argument) and, for two channels, the 2D TF
// lookup; they have no tracking table.
// Given a counter, a second instantiation of the kernel adds up its draws
// and corner-row fetches (one atomic a warp); the render path launches the
// one without.
//
// A HaloScene's frame runs mcs_halo_kernel and mcs_halo_tail_kernel
// (below): the same tracking, a launch a fetch around the all-reduce of its
// values, the launches after the first over a device list of the pixels
// that still fetch, the host reading the list's length once a batch.
//
// Numerics follow the plain PyTorch frame (renderers/mcs.py) operation by
// operation: built with -fmad=false, IEEE division and sqrt, NaN-
// propagating min/max, half-to-even rintf for the cheb distance.  logf is
// not bitwise equal to other libraries' results, so a pixel's stream may
// part from the plain version's after a flip in a float comparison.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"
#include "slab.cuh"

// What a launch takes of its scene, Params and resolution, filled once by
// the wrapper (kernels/mcs_frame.py, a ctypes Structure of this layout).
struct VptMcsArgs {
  const void* table;     // (D*H*W, 8) corner rows: tracking or volume
  const float4* tf_row;  // (tw, 4)
  const float* mvp;      // 16 floats, row-major inverse MVP
  const float* env;      // the (env_h, env_w, 4) environment map
  int table_bf16;
  int d, h, w;
  int tw, tf_mode;
  int width, height;
  float extinction, cell;
  int use_skip;
  int device;
  int env_h, env_w;
  int row0, full_height; // the launch's rows of the image: [row0,
                         // row0 + height) of full_height rows
};

// The prepared arguments with what the ext instances (two-channel and
// filtered scenes, ray.cuh) take besides; only they read it.
struct VptMcsExt : VptMcsArgs {
  const void* tf_table;  // (th*tw, 16) packed TF of the table's type
  int th;
  int channels;          // 1 or 2: with filter 0 and 1 channel, no ext
  int filter;            // ray.cuh's VptFilter
};

// The frame's scalars, by value.
struct VptMcsFrame {
  float seed;
  float sx, sy, sz;      // the frame's scatter direction
  float frame_number;    // n of the running mean
};

namespace {

// mcs._MAX_TRACKING_ITERS, the tracking loops' backstop
constexpr int kMaxIters = 100000;

// The color at p: the headline's fetch and lookup (kC = 0, with the
// cheb-skip table's empty cells when skip), or an ext instance's (kC
// channels, the filter; no tracking table).  v: the fetched value, which
// the cheb distance reads.
template <bool kBf16, int kC, class A>
__device__ __forceinline__ float4 color_at(const A& a, const float4* s_tf,
                                           float px, float py, float pz,
                                           bool skip, float* v) {
  if constexpr (kC == 0) {
    *v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, px, py, pz);
    return vpt_color(s_tf, a.tw, a.tf_mode, *v, skip);
  } else {
    *v = 0.0f;
    return vpt_fetch_color<kBf16, kC>(a.table, a.d, a.h, a.w, a.filter, px,
                                      py, pz, s_tf, a.tw, a.tf_mode,
                                      a.tf_table, a.th);
  }
}

// A pixel's view ray: its NDC, direction and cube interval (clamped at 0),
// and where it enters, the segment from start to start + seg, its length
// maxd and that length clamped away from 0 (maxc).
struct McsRay {
  float ndcx, ndcy;
  float dir[3];
  float tb0, tb1;
  float start[3], seg[3];
  float maxd, maxc;
  bool miss;
};

template <class A>
__device__ __forceinline__ McsRay mcs_ray(const A& a, const float* s_mvp,
                                          int x, int y) {
  McsRay r;
  r.ndcx = vpt_pixel_ndc(x, a.width);
  r.ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
  float from[3], to[3];
  vpt_unproject(s_mvp, r.ndcx, r.ndcy, r.ndcx, r.ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) r.dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, r.dir, &tnear, &tfar);
  r.tb0 = vpt_nmax(tnear, 0.0f);
  r.tb1 = vpt_nmax(tfar, 0.0f);
  r.miss = r.tb0 >= r.tb1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.start[k] = from[k] + r.tb0 * r.dir[k];
    r.seg[k] = (from[k] + r.tb1 * r.dir[k]) - r.start[k];
  }
  r.maxd = sqrtf(r.seg[0] * r.seg[0] + r.seg[1] * r.seg[1]
                 + r.seg[2] * r.seg[2]);
  r.maxc = vpt_nmax(r.maxd, 1e-20f);
  return r;
}

// A free path drawn from stream s: the exponential, extended with the
// cheb-skip table through the empty cells around the last landing.
template <class A>
__device__ __forceinline__ float mcs_free_path(uint32_t& s, const A& a,
                                               bool skip, float cheb) {
  float d = vpt_exponential(s, a.extinction);
  if (skip) d = vpt_nmax(d, vpt_nmax(cheb - 1.0f, 0.0f) * a.cell);
  return d;
}

// The scattering point at dist along the ray and its shadow segment to the
// cube along the frame's direction, with its length clamped away from 0.
struct McsShadow {
  float sp[3], sseg[3];
  float sdc;
};

__device__ __forceinline__ McsShadow mcs_shadow(const McsRay& r, float dist,
                                                const VptMcsFrame& f) {
  McsShadow sh;
  const float t = dist / r.maxc;
  const float sdir[3] = {f.sx, f.sy, f.sz};
#pragma unroll
  for (int k = 0; k < 3; ++k) sh.sp[k] = r.start[k] + t * r.seg[k];
  float tn2, tf2;
  vpt_intersect_cube(sh.sp, sdir, &tn2, &tf2);
  tf2 = vpt_nmax(tf2, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sh.sseg[k] = (sh.sp[k] + sdir[k] * tf2) - sh.sp[k];
  const float sd = sqrtf(sh.sseg[0] * sh.sseg[0] + sh.sseg[1] * sh.sseg[1]
                         + sh.sseg[2] * sh.sseg[2]);
  sh.sdc = vpt_nmax(sd, 1e-20f);
  return sh;
}

// The colour of a fetched value v (cheb_new: with skip, the cheb distance
// it gives): the TF row's lookup, with the cheb-skip table's empty cells,
// or for two channels (v, g) the packed 2D TF's.
template <bool kBf16, int kC, class A>
__device__ __forceinline__ float4 mcs_value_color(const A& a,
                                                  const float4* s_tf,
                                                  float2 v, bool skip,
                                                  float* cheb_new) {
  if constexpr (kC == 0) {
    *cheb_new = rintf(vpt_nmax(-v.x, 0.0f));
    return vpt_color(s_tf, a.tw, a.tf_mode, v.x, skip);
  } else {
    *cheb_new = 0.0f;
    return vpt_color_rg<kBf16, kC>(s_tf, a.tw, a.tf_mode, a.tf_table, a.th,
                                   v);
  }
}

// A scattered pixel's frame: the diffuse colour times the light along the
// frame's direction (the 1x1 texel env, or the map) times the
// transmittance.
template <bool kMap, class A>
__device__ __forceinline__ float4 mcs_scattered(const A& a,
                                                const VptMcsFrame& f,
                                                float4 env, float4 diffuse,
                                                float trans) {
  const float4 light =
      kMap ? vpt_sample_environment(reinterpret_cast<const float4*>(a.env),
                                    a.env_h, a.env_w, f.sx, f.sy, f.sz)
           : env;
  return make_float4(diffuse.x * light.x * trans, diffuse.y * light.y * trans,
                     diffuse.z * light.z * trans, diffuse.w * light.w * trans);
}

// What a pixel that misses or escapes sees: the 1x1 texel env, or the map
// along the unit view ray (mcs.py's env_color).
template <bool kMap, class A>
__device__ __forceinline__ float4 mcs_unscattered(const A& a, float4 env,
                                                  const McsRay& r) {
  if (!kMap) return env;
  const float norm = sqrtf(vpt_nmax(
      r.dir[0] * r.dir[0] + r.dir[1] * r.dir[1] + r.dir[2] * r.dir[2],
      1e-20f));
  return vpt_sample_environment(reinterpret_cast<const float4*>(a.env),
                                a.env_h, a.env_w, r.dir[0] / norm,
                                r.dir[1] / norm, r.dir[2] / norm);
}

// The running mean: acc + (frame - acc) / n, the IEEE quotient.
__device__ __forceinline__ float4 mcs_mean(float4 acc, float4 frame,
                                           float n) {
  acc.x = acc.x + (frame.x - acc.x) / n;
  acc.y = acc.y + (frame.y - acc.y) / n;
  acc.z = acc.z + (frame.z - acc.z) / n;
  acc.w = acc.w + (frame.w - acc.w) / n;
  return acc;
}

// kC as in color_at.
template <bool kBf16, bool kCount, bool kMap, int kC, class A>
__device__ __forceinline__ void mcs_frame(
    const A& a, const VptMcsFrame& f, float4* __restrict__ state,
    unsigned long long* __restrict__ counts) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float4 s_env;
  if (kC != 2)
    for (int i = threadIdx.x; i < a.tw; i += blockDim.x)
      s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (!kMap && threadIdx.x == 0)
    s_env = make_float4(__ldg(a.env), __ldg(a.env + 1), __ldg(a.env + 2),
                        __ldg(a.env + 3));
  __syncthreads();
  int x, y;
  const bool inside = vpt_tile_pixel(a.width, a.height, &x, &y);
  // tracking steps (draws) and corner-row fetches of this thread
  unsigned steps = 0, fetches = 0;
  if (inside) {
    const int i = y * a.width + x;
    // the state, read first, so that its latency overlaps the tracking's
    const float4 acc = state[i];
    const bool skip = kC == 0 && a.use_skip != 0;
    const float4 env = kMap ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : s_env;
    const McsRay r = mcs_ray(a, s_mvp, x, y);

    // the 1x1 environment: what a miss or an escaped path sees
    float4 frame = env;
    bool scattered = false;
    if (!r.miss) {
      uint32_t s = vpt_seed_pixel(r.ndcx, r.ndcy, f.seed);

      // sampleDistance: a path that leaves the segment takes 1 draw in
      // that iteration, one that stays takes 2
      float dist = 0.0f, cheb = 0.0f;
      for (int it = 0; it < kMaxIters; ++it) {
        uint32_t s1 = s;
        const float ndist = dist + mcs_free_path(s1, a, skip, cheb);
        dist = ndist;
        if (kCount) ++steps;
        if (ndist > r.maxc) {
          s = s1;
          break;
        }
        const float fr = ndist / r.maxc;
        const float u = vpt_uniform(s1);
        s = s1;
        float v;
        const float alpha = color_at<kBf16, kC>(a, s_tf,
                                                r.start[0] + fr * r.seg[0],
                                                r.start[1] + fr * r.seg[1],
                                                r.start[2] + fr * r.seg[2],
                                                skip, &v).w;
        if (kCount) ++fetches;
        if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
        if (u < alpha) break;                  // a collision
      }

      if (!(dist > r.maxd)) {
        // the scattering point and its shadow segment to the cube
        const McsShadow sh = mcs_shadow(r, dist, f);
        float vd;
        const float4 diffuse = color_at<kBf16, kC>(a, s_tf, sh.sp[0],
                                                   sh.sp[1], sh.sp[2], skip,
                                                   &vd);
        if (kCount) ++fetches;

        // sampleTransmittance: one draw an iteration
        float dist2 = 0.0f, trans = 1.0f;
        cheb = 0.0f;
        for (int it = 0; it < kMaxIters; ++it) {
          const float ndist = dist2 + mcs_free_path(s, a, skip, cheb);
          dist2 = ndist;
          if (kCount) ++steps;
          if (ndist > sh.sdc) break;
          const float fr = ndist / sh.sdc;
          float v;
          const float alpha = color_at<kBf16, kC>(
              a, s_tf, sh.sp[0] + fr * sh.sseg[0],
              sh.sp[1] + fr * sh.sseg[1], sh.sp[2] + fr * sh.sseg[2], skip,
              &v).w;
          if (kCount) ++fetches;
          trans = trans * (1.0f - alpha);
          if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
        }
        frame = mcs_scattered<kMap>(a, f, env, diffuse, trans);
        scattered = true;
      }
    }
    if (kMap && !scattered) frame = mcs_unscattered<kMap>(a, env, r);
    state[i] = mcs_mean(acc, frame, f.frame_number);
  }
  if (kCount) {
    // every lane of the block reaches this: a warp's sums, one atomic each
    steps = __reduce_add_sync(0xFFFFFFFFu, steps);
    fetches = __reduce_add_sync(0xFFFFFFFFu, fetches);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(counts, (unsigned long long)steps);
      atomicAdd(counts + 1, (unsigned long long)fetches);
    }
  }
}

template <bool kBf16, bool kCount, bool kMap>
__global__ void __launch_bounds__(kVptTileThreads)
mcs_frame_kernel(const VptMcsArgs a, const VptMcsFrame f,
                 float4* __restrict__ state,
                 unsigned long long* __restrict__ counts) {
  mcs_frame<kBf16, kCount, kMap, 0>(a, f, state, counts);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows; 2: a
// two-channel volume and the 2D TF table).
template <bool kBf16, bool kCount, bool kMap, int kC>
__global__ void __launch_bounds__(kVptTileThreads)
mcs_frame_ext_kernel(const VptMcsExt a, const VptMcsFrame f,
                     float4* __restrict__ state,
                     unsigned long long* __restrict__ counts) {
  mcs_frame<kBf16, kCount, kMap, kC>(a, f, state, counts);
}

// The halo instance (parallel/halo.py, a HaloScene frame): a sample is the
// sum over the ranks of their masked slab-local values
// (vpt_tpu/parallel/halo.py:199-250), an all-reduce between the fetch and
// its use, so a frame is a launch a fetch: each pixel runs mcs_frame's
// tracking as a machine whose every fetch ends a launch.  vpt_tpu's
// while_loops (mcs.py:86-150) fetch at every pixel in every iteration until
// all are done (the distance loop, the diffuse fetch, the transmittance
// loop: a psum each); here launch e finishes each pixel's pending fetch
// from the summed value (its colour and cheb distance; the collision test,
// the diffuse colour or the transmittance), runs the pixel's tracking on to
// its next fetch and writes that fetch's masked value (slab.cuh's cell; 0
// where another rank owns it), or ends the pixel's frame (the running mean,
// and a zero value from then on, which every later all-reduce sums as 0).
// Each pixel takes mcs_frame's draws and fetches in its order, with its
// kMaxIters cap on each loop, so on one slab a frame equals the
// whole-scene kernel's bit for bit.  Between launches a pixel keeps its
// stream (rng), its phase and iteration (tag), its tracking (track: dist,
// cheb, u or the transmittance, the shadow distance) and, while it tracks
// its shadow, the diffuse colour; its ray and shadow segment come again
// from the pixel index and dist.  A HaloScene has no filter: kC is 0 (one
// channel, the cheb-skip table or not) or 2.
//
// Which pixels a launch visits: launch 0 (mcs_halo_kernel) runs the tile
// grid over every pixel; each pixel that fetches appends its id to the
// launch's list (one atomic a warp: its ballot's count at live[0], then each
// fetching lane at the warp's base plus its rank).  Launch e > 0
// (mcs_halo_tail_kernel) is a persistent grid (the instance's resident
// blocks times the SMs) whose threads walk launch e - 1's list by grid
// stride, its length read from the card, and build launch e's list and
// count: the slowest pixel's tail costs a few blocks, not the tile grid.  A
// block whose share of the list is empty returns before it stages the TF
// row, so a launch after the frame's end changes nothing.  The values stay
// indexed by pixel (the all-reduce sums n x channels floats whatever the
// lists' order, which atomics set).  The host reads a launch's count only at
// the end of a batch of launches (kernels/mcs_frame.halo_schedule): launch
// e's count sits in live[e % kMcsSlots], which launch e + 1 reads and launch
// e + 2 zeroes for its own successor; the read's copy goes on the stream
// right after the batch's last launch, so it lands before that slot is
// zeroed, whatever the batch's length.  The schedule depends on the counts
// alone, which every rank reads alike.
struct VptMcsHalo {
  uint32_t* rng;         // (n,) the stream
  int* tag;              // (n,) McsPhase | iteration << 2
  float4* track;         // (n,) dist, cheb, u or trans, dist2
  float4* diffuse;       // (n,) the diffuse colour
  float* value;          // (n, kC or 1) the pending fetch's value, summed
  int* live;             // (kMcsSlots,) launch e's count of the pixels that
                         // fetch, in slot e % kMcsSlots
  int* list;             // (2, n) their ids: launch e's in half e & 1
  VptSlab slab;
};

// A halo frame, filled once by the wrapper (kernels/mcs_frame.py, a ctypes
// Structure of this layout) and checked once (vpt_mcs_halo_check): the
// scene's prepared arguments, the state, the scratch and the slab, the
// frame's scalars (set each frame) and the tail's persistent grid.
struct VptMcsHaloFrame {
  const VptMcsExt* args;
  float4* state;         // (height, width, 4), in place
  VptMcsHalo halo;
  VptMcsFrame frame;
  int tail_blocks;       // the grid of launches after the first: the
                         // persistent grid, or once the host has read a
                         // count no more blocks than its entries (counts
                         // only fall), set by the wrapper a batch
};

enum McsPhase { kPath = 0, kDiffuse = 1, kShadow = 2, kDone = 3 };

// the count slots of a frame's launches (see VptMcsHalo): the one a launch
// reads, the one it writes and the one it zeroes for the next
constexpr int kMcsSlots = 3;

// Pixel (x, y)'s step of launch e of a halo frame (kFirst: e = 0, which
// starts its tracking; later launches finish its pending fetch first, with
// the TF row in s_tf).  Returns whether it fetches: it then wrote the
// fetch's masked value and its carry; otherwise it ended its frame.
template <bool kBf16, bool kMap, int kC, bool kFirst>
__device__ __forceinline__ bool mcs_halo_pixel(
    const VptMcsExt& a, const VptMcsFrame& f, const VptMcsHalo& h,
    float4* __restrict__ state, const float4* s_tf, const float* s_mvp,
    int x, int y) {
  constexpr int kV = kC == 2 ? 2 : 1;
  bool fetch = false;
  const int i = y * a.width + x;
  // a later launch's carry, read at once: none of these loads waits for
  // another
  int tag = kPath;
  uint32_t s_in = 0u;
  float4 tr_in = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float2 v_in = make_float2(0.0f, 0.0f);
  if (!kFirst) {
    tag = h.tag[i];
    s_in = h.rng[i];
    tr_in = h.track[i];
    const float* pv = h.value + kV * (long long)i;
    v_in = make_float2(pv[0], kV == 2 ? pv[1] : 0.0f);
  }
  if ((tag & 3) == kDone) return false;
  const bool skip = kC == 0 && a.use_skip != 0;
  const float4 env = kMap ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : make_float4(__ldg(a.env), __ldg(a.env + 1),
                                        __ldg(a.env + 2), __ldg(a.env + 3));
  const McsRay r = mcs_ray(a, s_mvp, x, y);
  int phase = tag & 3, it = tag >> 2;
  uint32_t s;
  float4 tr;                 // dist, cheb, u or trans, dist2
  float4 diffuse = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool have_diffuse = false, path_ended = false, finish = false;
  float4 frame = env;
  float q[3] = {0.0f, 0.0f, 0.0f};  // the next fetch's position
  if (kFirst) {
    s = vpt_seed_pixel(r.ndcx, r.ndcy, f.seed);
    tr = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r.miss) {
      frame = mcs_unscattered<kMap>(a, env, r);
      finish = true;
    }
  } else {
    // the pending fetch, from the value summed over the slabs
    s = s_in;
    tr = tr_in;
    float cheb_new;
    const float4 c = mcs_value_color<kBf16, kC>(a, s_tf, v_in, skip,
                                                &cheb_new);
    if (phase == kPath) {
      if (skip) tr.y = cheb_new;
      path_ended = tr.z < c.w;         // a collision
    } else if (phase == kDiffuse) {
      diffuse = c;
      have_diffuse = true;
      phase = kShadow;
      it = 0;
      tr = make_float4(tr.x, 0.0f, 1.0f, 0.0f);
    } else {
      tr.z = tr.z * (1.0f - c.w);
      if (skip) tr.y = cheb_new;
    }
  }
  if (!finish && phase == kPath && !path_ended) {
    // sampleDistance's next iteration: a path that leaves the segment
    // takes 1 draw, one that stays takes 2 and a fetch
    if (it < kMaxIters) {
      uint32_t s1 = s;
      const float ndist = tr.x + mcs_free_path(s1, a, skip, tr.y);
      tr.x = ndist;
      ++it;
      if (ndist > r.maxc) {
        s = s1;
        path_ended = true;
      } else {
        const float fr = ndist / r.maxc;
        tr.z = vpt_uniform(s1);
        s = s1;
#pragma unroll
        for (int k = 0; k < 3; ++k) q[k] = r.start[k] + fr * r.seg[k];
        fetch = true;
      }
    } else {
      path_ended = true;
    }
  }
  if (path_ended) {
    if (!(tr.x > r.maxd)) {
      // the scattering point: the diffuse fetch
      const McsShadow sh = mcs_shadow(r, tr.x, f);
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = sh.sp[k];
      phase = kDiffuse;
      fetch = true;
    } else {
      frame = mcs_unscattered<kMap>(a, env, r);
      finish = true;
    }
  }
  if (!finish && !fetch && phase == kShadow) {
    // sampleTransmittance's next iteration: one draw
    const McsShadow sh = mcs_shadow(r, tr.x, f);
    bool ended = true;
    if (it < kMaxIters) {
      const float ndist = tr.w + mcs_free_path(s, a, skip, tr.y);
      tr.w = ndist;
      ++it;
      if (!(ndist > sh.sdc)) {
        const float fr = ndist / sh.sdc;
#pragma unroll
        for (int k = 0; k < 3; ++k) q[k] = sh.sp[k] + fr * sh.sseg[k];
        fetch = true;
        ended = false;
      }
    }
    if (ended) {
      if (!have_diffuse) diffuse = h.diffuse[i];
      frame = mcs_scattered<kMap>(a, f, env, diffuse, tr.z);
      finish = true;
    }
  }
  float2 v = make_float2(0.0f, 0.0f);
  if (fetch) {
    const VptSlabCell cell = vpt_slab_cell(a.d, a.h, a.w, h.slab, q[0],
                                           q[1], q[2]);
    if (cell.local) v = vpt_slab_value<kBf16, kC>(a.table, cell);
    h.rng[i] = s;
    h.tag[i] = phase | (it << 2);
    h.track[i] = tr;
    if (have_diffuse && phase == kShadow) h.diffuse[i] = diffuse;
  } else {
    state[i] = mcs_mean(state[i], frame, f.frame_number);
    h.tag[i] = kDone;
  }
  float* out = h.value + kV * (long long)i;
  out[0] = v.x;
  if (kV == 2) out[1] = v.y;
  return fetch;
}

// Pixel i onto a launch's list (its count *live) where it fetches: the
// warp's ballot, one atomic a warp, each fetching lane at the warp's base
// plus its rank among them.  Every lane of the warp calls it.
__device__ __forceinline__ void mcs_append(int* live, int* list, bool fetch,
                                           int i) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, fetch);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m != 0) base = atomicAdd(live, __popc(m));
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  if (fetch) list[base + __popc(m & ((1u << lane) - 1u))] = i;
}

// Launch 0 of a halo frame: the tile grid over every pixel (live[0] zeroed
// by the host before it).
template <bool kBf16, bool kMap, int kC>
__global__ void __launch_bounds__(kVptTileThreads)
mcs_halo_kernel(const VptMcsExt a, const VptMcsFrame f, const VptMcsHalo h,
                float4* __restrict__ state) {
  __shared__ float s_mvp[16];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (blockIdx.x == 0 && threadIdx.x == 0) h.live[1] = 0;
  __syncthreads();
  int x, y;
  const bool inside = vpt_tile_pixel(a.width, a.height, &x, &y);
  const bool fetch = inside && mcs_halo_pixel<kBf16, kMap, kC, true>(
      a, f, h, state, nullptr, s_mvp, x, y);
  mcs_append(h.live, h.list, fetch, y * a.width + x);
}

// Launch e > 0: the persistent grid over launch e - 1's list.
template <bool kBf16, bool kMap, int kC>
__global__ void __launch_bounds__(kVptTileThreads)
mcs_halo_tail_kernel(const VptMcsExt a, const VptMcsFrame f,
                     const VptMcsHalo h, float4* __restrict__ state,
                     int launch) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    h.live[(launch + 1) % kMcsSlots] = 0;
  const long long n = (long long)a.width * a.height;
  const int* in = h.list + ((launch - 1) & 1) * n;
  const int first = blockIdx.x * kVptTileThreads;
  // the thread's first entry, read beside the count (an entry past it is
  // a stale id, never used)
  const int head = first + (int)threadIdx.x < n ? in[first + threadIdx.x] : 0;
  const int count = h.live[(launch - 1) % kMcsSlots];
  if (first >= count) return;          // this block's share is empty
  if (kC != 2)
    for (int k = threadIdx.x; k < a.tw; k += blockDim.x) s_tf[k] = a.tf_row[k];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  __syncthreads();
  int* out = h.list + (launch & 1) * n;
  int* live = h.live + launch % kMcsSlots;
  const int stride = gridDim.x * kVptTileThreads;
  // a warp's lanes take neighbouring entries, and every lane of it runs
  // each round (mcs_append's ballot)
  for (int base = first + (threadIdx.x & ~31); base < count; base += stride) {
    const int k = base + (threadIdx.x & 31);
    int i = 0;
    bool fetch = false;
    if (k < count) {
      i = k == first + (int)threadIdx.x ? head : in[k];
      fetch = mcs_halo_pixel<kBf16, kMap, kC, false>(
          a, f, h, state, s_tf, s_mvp, i % a.width, i / a.width);
    }
    mcs_append(live, out, fetch, i);
  }
}

using KernelHalo = void (*)(const VptMcsExt, const VptMcsFrame,
                            const VptMcsHalo, float4*);
using KernelTail = void (*)(const VptMcsExt, const VptMcsFrame,
                            const VptMcsHalo, float4*, int);

// The halo instance for a bf16 table (flags & 1), an environment map
// larger than 1x1 (flags & 4) and two channels (flags & 16): launch 0's
// tile grid, or (kTail) the persistent grid of the launches after it.
template <bool kTail, int kC, bool kBf16, bool kMap>
auto halo_kernel() {
  if constexpr (kTail) return mcs_halo_tail_kernel<kBf16, kMap, kC>;
  else return mcs_halo_kernel<kBf16, kMap, kC>;
}

template <bool kTail, int kC>
auto pick_halo_map(int flags) {
  switch (flags & 5) {
    case 0: return halo_kernel<kTail, kC, false, false>();
    case 1: return halo_kernel<kTail, kC, true, false>();
    case 4: return halo_kernel<kTail, kC, false, true>();
    default: return halo_kernel<kTail, kC, true, true>();
  }
}

KernelHalo pick_halo(int flags) {
  return (flags & 16) ? pick_halo_map<false, 2>(flags)
                      : pick_halo_map<false, 0>(flags);
}

KernelTail pick_halo_tail(int flags) {
  return (flags & 16) ? pick_halo_map<true, 2>(flags)
                      : pick_halo_map<true, 0>(flags);
}

size_t dynamic_smem(int tw) { return (size_t)tw * sizeof(float4); }

using Kernel = void (*)(const VptMcsArgs, const VptMcsFrame, float4*,
                        unsigned long long*);
using KernelExt = void (*)(const VptMcsExt, const VptMcsFrame, float4*,
                           unsigned long long*);

// The instance for a table type (flags & 1), the counter (flags & 2) and
// an environment map larger than 1x1 (flags & 4).
template <bool kBf16, bool kCount>
Kernel pick_map(int flags) {
  return (flags & 4) ? mcs_frame_kernel<kBf16, kCount, true>
                     : mcs_frame_kernel<kBf16, kCount, false>;
}

Kernel pick(int flags) {
  switch (flags & 3) {
    case 0: return pick_map<false, false>(flags);
    case 1: return pick_map<true, false>(flags);
    case 2: return pick_map<false, true>(flags);
    default: return pick_map<true, true>(flags);
  }
}

// The ext instance (flags & 8) for the same bits, of two channels (flags &
// 16) in either row type or of one (a filtered volume) in float32 rows;
// null for a filtered volume in bf16 rows, which make_scene never builds.
template <bool kBf16, int kC>
KernelExt pick_ext_map(int flags) {
  if (flags & 2)
    return (flags & 4) ? mcs_frame_ext_kernel<kBf16, true, true, kC>
                       : mcs_frame_ext_kernel<kBf16, true, false, kC>;
  return (flags & 4) ? mcs_frame_ext_kernel<kBf16, false, true, kC>
                     : mcs_frame_ext_kernel<kBf16, false, false, kC>;
}

KernelExt pick_ext(int flags) {
  if (flags & 16)
    return (flags & 1) ? pick_ext_map<true, 2>(flags)
                       : pick_ext_map<false, 2>(flags);
  return (flags & 1) ? nullptr : pick_ext_map<false, 1>(flags);
}

// the dynamic shared memory of an instance: the TF row, which a
// two-channel instance does not copy
size_t tf_smem(int flags, int tw) {
  return (flags & 16) ? 0 : dynamic_smem(tw);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class K, class A>
cudaError_t launch_kernel(K kernel, const A& a, size_t smem,
                          const VptMcsFrame& f, void* state, void* counts,
                          void* stream) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)vpt_tile_blocks(a.width, a.height);
  kernel<<<blocks, kVptTileThreads, smem, (cudaStream_t)stream>>>(
      a, f, (float4*)state, (unsigned long long*)counts);
  return cudaGetLastError();
}

cudaError_t launch_any(const VptMcsExt& a, const VptMcsFrame& f,
                       void* state, void* counts, void* stream) {
  if (a.width <= 0 || a.height <= 0) return cudaSuccess;
  const bool ext = a.channels != 1 || a.filter != 0;
  if ((a.channels != 1 && a.channels != 2) || a.filter < 0 || a.filter > 2
      || (ext && a.use_skip) || a.row0 < 0
      || a.full_height < a.row0 + a.height)
    return cudaErrorInvalidValue;
  const int flags = (a.table_bf16 ? 1 : 0) | (counts ? 2 : 0)
                    | (a.env_h == 1 && a.env_w == 1 ? 0 : 4)
                    | (ext ? 8 : 0) | (a.channels == 2 ? 16 : 0);
  const size_t smem = tf_smem(flags, a.tw);
  if (ext)
    return launch_kernel(pick_ext(flags), a, smem, f, state, counts, stream);
  const VptMcsArgs& base = a;
  return launch_kernel(pick(flags), base, smem, f, state, counts, stream);
}

// out: threads a block, resident blocks an SM, SMs, registers a thread,
// local (spilled) bytes a thread, static and dynamic shared bytes a block,
// the block's tile width and height and the warp's tile width in pixels
// (the render path's instantiation, without the counter)
template <class K>
cudaError_t info(K kernel, size_t smem, int device, int* out) {
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
                        (int)smem, kVptTileW, kVptTileH, kVptWarpW};
  for (int k = 0; k < 10; ++k) out[k] = values[k];
  return cudaSuccess;
}

}  // namespace

// One frame: prepared is the VptMcsExt of the scene, Params and
// resolution; seed, the scatter direction and n are the frame's; counts is
// null, or two zeroed-or-running unsigned 64-bit sums (tracking steps,
// corner-row fetches) that the frame adds to.
extern "C" int vpt_mcs_launch(const void* prepared, void* state, float seed,
                              float sx, float sy, float sz,
                              float frame_number, void* counts,
                              void* stream) {
  const VptMcsExt& a = *static_cast<const VptMcsExt*>(prepared);
  VptDeviceGuard guard(a.device);
  const VptMcsFrame f = {seed, sx, sy, sz, frame_number};
  return (int)launch_any(a, f, state, counts, stream);
}

// The same frame through the argument list the MCS kernel has taken since
// it was ported (every build of it exports this: env is a 1x1 texel), on
// the current device, without the counter.
extern "C" int vpt_mcs_frame(
    void* state, const void* table, int table_bf16, int d, int h, int w,
    const void* tf_row, int tw, int tf_mode, const void* mvp,
    const void* env, int width, int height, float seed, float extinction,
    float cell, int use_skip, float sx, float sy, float sz,
    float frame_number, void* stream) {
  VptMcsExt a;
  a.table = table;
  a.tf_row = (const float4*)tf_row;
  a.mvp = (const float*)mvp;
  a.env = (const float*)env;
  a.table_bf16 = table_bf16;
  a.d = d; a.h = h; a.w = w;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.width = width; a.height = height;
  a.extinction = extinction;
  a.cell = cell;
  a.use_skip = use_skip;
  a.device = 0;
  a.env_h = a.env_w = 1;
  a.row0 = 0;
  a.full_height = height;
  a.tf_table = nullptr;
  a.th = 0;
  a.channels = 1;
  a.filter = 0;
  const VptMcsFrame f = {seed, sx, sy, sz, frame_number};
  return (int)launch_any(a, f, state, nullptr, stream);
}

// The launch shape of the instance `flags` (1: a bf16 table, 4: an
// environment map larger than 1x1, 8: an ext instance, 16: with two
// channels) for a TF row of `tw` texels on `device`: the ten values of
// info() above.  Launches nothing.
extern "C" int vpt_mcs_info(int flags, int tw, int device, int* out) {
  VptDeviceGuard guard(device);
  const int render = flags & ~2;
  const size_t smem = tf_smem(render, tw);
  return (int)((flags & 8) ? info(pick_ext(render), smem, device, out)
                           : info(pick(render & 5), smem, device, out));
}

namespace {

// the halo instance's flags of a prepared VptMcsExt (pick_halo's)
int halo_flags(const VptMcsExt& a) {
  return (a.table_bf16 ? 1 : 0) | (a.env_h == 1 && a.env_w == 1 ? 0 : 4)
         | (a.channels == 2 ? 16 : 0);
}

}  // namespace

// 0 where the halo frame (see VptMcsHaloFrame: args the VptMcsExt of the
// HaloScene, Params and resolution, table the rank's slab rows of the corner
// or, with use_skip, the cheb-skip table, d, h, w the whole volume's, no
// filter) is one its launches can run, else a CUDA error code; it lets the
// tail's instance take its TF row's shared memory.  Launches nothing.
extern "C" int vpt_mcs_halo_check(const void* frame) {
  const VptMcsHaloFrame& fr = *static_cast<const VptMcsHaloFrame*>(frame);
  const VptMcsExt& a = *fr.args;
  VptDeviceGuard guard(a.device);
  const VptSlab& slab = fr.halo.slab;
  if ((a.channels != 1 && a.channels != 2) || a.filter != 0
      || (a.channels == 2 && a.use_skip) || a.row0 < 0
      || a.full_height < a.row0 + a.height || slab.count < 1
      || slab.interleave < 1 || slab.index < 0 || slab.index >= slab.count
      || a.d % (slab.count * slab.interleave) != 0 || fr.tail_blocks < 1
      || fr.halo.live == nullptr || fr.halo.list == nullptr)
    return (int)cudaErrorInvalidValue;
  const int flags = halo_flags(a);
  return (int)allow_smem(pick_halo_tail(flags), tf_smem(flags, a.tw));
}

// Launches e = launch .. launch + count - 1 of the checked halo frame, back
// to back on the stream (the caller all-reduces the values between two when
// its group sums them); launch 0 zeroes live[0] first.  read: null, or host
// memory (pinned) into which the last launch's count of the pixels that
// fetch is copied after it, on the stream: 0 ends the frame.
extern "C" int vpt_mcs_halo_run(const void* frame, int launch, int count,
                                void* read, void* stream) {
  const VptMcsHaloFrame& fr = *static_cast<const VptMcsHaloFrame*>(frame);
  const VptMcsExt& a = *fr.args;
  VptDeviceGuard guard(a.device);
  if (launch < 0 || count < 1) return (int)cudaErrorInvalidValue;
  if (a.width <= 0 || a.height <= 0) {
    if (read != nullptr) *static_cast<int*>(read) = 0;
    return 0;
  }
  const int flags = halo_flags(a);
  const cudaStream_t s = (cudaStream_t)stream;
  for (int e = launch; e < launch + count; ++e) {
    if (e == 0) {
      const cudaError_t err = cudaMemsetAsync(fr.halo.live, 0, sizeof(int),
                                              s);
      if (err != cudaSuccess) return (int)err;
      pick_halo(flags)<<<(unsigned)vpt_tile_blocks(a.width, a.height),
                         kVptTileThreads, 0, s>>>(a, fr.frame, fr.halo,
                                                  fr.state);
    } else {
      pick_halo_tail(flags)<<<(unsigned)fr.tail_blocks, kVptTileThreads,
                              tf_smem(flags, a.tw), s>>>(
          a, fr.frame, fr.halo, fr.state, e);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (read == nullptr) return 0;
  return (int)cudaMemcpyAsync(
      read, fr.halo.live + (launch + count - 1) % kMcsSlots, sizeof(int),
      cudaMemcpyDeviceToHost, s);
}

// The launch shape of the halo instance for flags (1 a bf16 table, 4 an
// environment map larger than 1x1, 16 two channels, 32 the tail's
// persistent instance, which holds the TF row in shared memory) and a TF
// row of `tw` texels on `device`: vpt_mcs_info's values.  Launches nothing.
extern "C" int vpt_mcs_halo_info(int flags, int tw, int device, int* out) {
  VptDeviceGuard guard(device);
  if (flags & 32)
    return (int)info(pick_halo_tail(flags), tf_smem(flags, tw), device, out);
  return (int)info(pick_halo(flags), 0, device, out);
}
