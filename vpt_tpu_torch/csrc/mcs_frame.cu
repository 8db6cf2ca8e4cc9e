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
// Numerics follow the plain PyTorch frame (renderers/mcs.py) operation by
// operation: built with -fmad=false, IEEE division and sqrt, NaN-
// propagating min/max, half-to-even rintf for the cheb distance.  logf is
// not bitwise equal to other libraries' results, so a pixel's stream may
// part from the plain version's after a flip in a float comparison.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "ray.cuh"

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
    float4 acc = state[i];
    const bool skip = kC == 0 && a.use_skip != 0;
    const float4 env = kMap ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : s_env;

    const float ndcx = vpt_pixel_ndc(x, a.width);
    const float ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
    float from[3], to[3], dir[3];
    vpt_unproject(s_mvp, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
    for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
    float tnear, tfar;
    vpt_intersect_cube(from, dir, &tnear, &tfar);
    const float tb0 = vpt_nmax(tnear, 0.0f), tb1 = vpt_nmax(tfar, 0.0f);

    // the 1x1 environment: what a miss or an escaped path sees
    float4 frame = env;
    bool scattered = false;
    if (!(tb0 >= tb1)) {
      float start[3], seg[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        start[k] = from[k] + tb0 * dir[k];
        seg[k] = (from[k] + tb1 * dir[k]) - start[k];
      }
      const float maxd = sqrtf(seg[0] * seg[0] + seg[1] * seg[1]
                               + seg[2] * seg[2]);
      const float maxc = vpt_nmax(maxd, 1e-20f);
      uint32_t s = vpt_seed_pixel(ndcx, ndcy, f.seed);

      // sampleDistance: a path that leaves the segment takes 1 draw in
      // that iteration, one that stays takes 2
      float dist = 0.0f, cheb = 0.0f;
      for (int it = 0; it < kMaxIters; ++it) {
        uint32_t s1 = s;
        float d = vpt_exponential(s1, a.extinction);
        if (skip) d = vpt_nmax(d, vpt_nmax(cheb - 1.0f, 0.0f) * a.cell);
        const float ndist = dist + d;
        dist = ndist;
        if (kCount) ++steps;
        if (ndist > maxc) {
          s = s1;
          break;
        }
        const float fr = ndist / maxc;
        const float u = vpt_uniform(s1);
        s = s1;
        float v;
        const float alpha = color_at<kBf16, kC>(a, s_tf,
                                                start[0] + fr * seg[0],
                                                start[1] + fr * seg[1],
                                                start[2] + fr * seg[2], skip,
                                                &v).w;
        if (kCount) ++fetches;
        if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
        if (u < alpha) break;                  // a collision
      }

      if (!(dist > maxd)) {
        // the scattering point and its shadow segment to the cube
        const float t = dist / maxc;
        float sp[3], sseg[3];
        const float sdir[3] = {f.sx, f.sy, f.sz};
#pragma unroll
        for (int k = 0; k < 3; ++k) sp[k] = start[k] + t * seg[k];
        float tn2, tf2;
        vpt_intersect_cube(sp, sdir, &tn2, &tf2);
        tf2 = vpt_nmax(tf2, 0.0f);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sseg[k] = (sp[k] + sdir[k] * tf2) - sp[k];
        const float sd = sqrtf(sseg[0] * sseg[0] + sseg[1] * sseg[1]
                               + sseg[2] * sseg[2]);
        const float sdc = vpt_nmax(sd, 1e-20f);
        float vd;
        const float4 diffuse = color_at<kBf16, kC>(a, s_tf, sp[0], sp[1],
                                                   sp[2], skip, &vd);
        if (kCount) ++fetches;

        // sampleTransmittance: one draw an iteration
        float dist2 = 0.0f, trans = 1.0f;
        cheb = 0.0f;
        for (int it = 0; it < kMaxIters; ++it) {
          float d = vpt_exponential(s, a.extinction);
          if (skip) d = vpt_nmax(d, vpt_nmax(cheb - 1.0f, 0.0f) * a.cell);
          const float ndist = dist2 + d;
          dist2 = ndist;
          if (kCount) ++steps;
          if (ndist > sdc) break;
          const float fr = ndist / sdc;
          float v;
          const float alpha = color_at<kBf16, kC>(a, s_tf,
                                                  sp[0] + fr * sseg[0],
                                                  sp[1] + fr * sseg[1],
                                                  sp[2] + fr * sseg[2], skip,
                                                  &v).w;
          if (kCount) ++fetches;
          trans = trans * (1.0f - alpha);
          if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
        }
        // the light along the scatter direction
        const float4 light =
            kMap ? vpt_sample_environment(
                       reinterpret_cast<const float4*>(a.env), a.env_h,
                       a.env_w, f.sx, f.sy, f.sz)
                 : env;
        frame = make_float4(diffuse.x * light.x * trans,
                            diffuse.y * light.y * trans,
                            diffuse.z * light.z * trans,
                            diffuse.w * light.w * trans);
        scattered = true;
      }
    }
    if (kMap && !scattered) {
      // the map along the unit view ray (mcs.py's env_color)
      const float norm = sqrtf(vpt_nmax(
          dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2], 1e-20f));
      frame = vpt_sample_environment(reinterpret_cast<const float4*>(a.env),
                                     a.env_h, a.env_w, dir[0] / norm,
                                     dir[1] / norm, dir[2] / norm);
    }

    // the running mean: acc + (frame - acc) / n, the IEEE quotient
    acc.x = acc.x + (frame.x - acc.x) / f.frame_number;
    acc.y = acc.y + (frame.y - acc.y) / f.frame_number;
    acc.z = acc.z + (frame.z - acc.z) / f.frame_number;
    acc.w = acc.w + (frame.w - acc.w) / f.frame_number;
    state[i] = acc;
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
