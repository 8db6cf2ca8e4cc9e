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
  float4* st = reinterpret_cast<float4*>(state) + i;
  float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m0 = 0.0f;
  if (kMode == kMip) m0 = state[i]; else s0 = *st;

  // the pixel's ray (_march.rays): unproject, slab test clamped at 0
  const float ndcx = vpt_pixel_ndc(x, a.width);
  const float ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
  float from[3], to[3], dir[3];
  vpt_unproject(s_mvp, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  float tb0 = vpt_nmax(tnear, 0.0f), tb1 = vpt_nmax(tfar, 0.0f);
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
        tb0 = vpt_nmax(tb0, vpt_nmax(bn, 0.0f));
        tb1 = vpt_nmin(tb1, vpt_nmax(bf, 0.0f));
      }
    }
  }
  const bool miss = tb0 >= tb1;
  float start[3], seg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    start[k] = from[k] + tb0 * dir[k];
    seg[k] = (from[k] + tb1 * dir[k]) - start[k];
  }
  const int n = miss ? 0 : a.slices;
  const float step = a.step;
  using Row = VptRowOf<kBf16, kC>;
  // the slice's color: the headline's lookup, or an ext instance's
  const auto lookup = [&](const Row& row, const Cell& cell) {
    if constexpr (kC == 0) {
      return vpt_tf1d_lookup(s_tf, a.tw, vpt_lerp_row<kBf16>(row, cell),
                             kTf);
    } else {
      return vpt_color_rg<kBf16, kC>(s_tf, a.tw, kTf, a.tf_table, a.th,
                                     vpt_lerp_rg<kBf16, kC>(row, cell));
    }
  };
  int filter = 0;
  if constexpr (kC != 0) filter = a.filter;

  if (kMode == kEam || kMode == kDepth) {
    const float len = sqrtf(seg[0] * seg[0] + seg[1] * seg[1]
                            + seg[2] * seg[2]);
    const float rsl = len * step;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // EAM's carry
    float t = first, dacc = 0.0f;                      // Depth's carry
    march_slices<kBf16, kC>(
        a, filter, n, start, seg,
        [&](int s) { return first + (float)s * step; }, lookup,
        [&](float ts, auto get) {
          // inactive for good: the carry never changes after this
          if (kMode == kEam && !(ts < 1.0f && acc.w < 0.99f)) return false;
          if (kMode == kDepth && !(t < 1.0f && dacc < a.level)) return false;
          const float4 c = get();
          if (kMode == kEam) {
            const float alpha = c.w * rsl * a.extinction;
            const float k = 1.0f - acc.w;
            acc.x = acc.x + k * (c.x * alpha);
            acc.y = acc.y + k * (c.y * alpha);
            acc.z = acc.z + k * (c.z * alpha);
            acc.w = acc.w + k * alpha;
          } else {
            dacc = dacc + (1.0f - dacc) * c.w * rsl * a.extinction;
            t = t + step;
          }
          return true;
        });
    float4 frame;
    if (kMode == kEam) {
      if (acc.w > 1.0f) {
        const float den = vpt_nmax(acc.w, 1e-6f);
        acc.x = acc.x / den;
        acc.y = acc.y / den;
        acc.z = acc.z / den;
      }
      frame = miss ? make_float4(0.0f, 0.0f, 0.0f, 1.0f)
                   : make_float4(acc.x, acc.y, acc.z, 1.0f);
    } else {
      float depth = tb0 + t * (tb1 - tb0);
      if (dacc < a.level || miss) depth = -1.0f;
      frame = make_float4(depth, 0.0f, 0.0f, 1.0f);
    }
    // the running mean: state + (frame - state) * (1/n)
    s0.x = s0.x + (frame.x - s0.x) * mix;
    s0.y = s0.y + (frame.y - s0.y) * mix;
    s0.z = s0.z + (frame.z - s0.z) * mix;
    s0.w = s0.w + (frame.w - s0.w) * mix;
    *st = s0;
  } else if (kMode == kMip) {
    float val = 0.0f;
    march_slices<kBf16, kC>(
        a, filter, n, start, seg,
        [&](int s) { return wrap_unit(first + (float)s * step); },
        [&](const Row& row, const Cell& cell) {
          return lookup(row, cell).w;
        },
        [&](float, auto get) {
          val = vpt_nmax(val, get());
          return true;
        });
    state[i] = vpt_nmax(m0, val);
  } else {  // kIso
    // the nearest hit: the schedule first - s*step from its near end (the
    // largest s), stopping at the first hit
    float4 hit = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    march_slices<kBf16, kC>(
        a, filter, n, start, seg,
        [&](int j) { return first - (float)(n - 1 - j) * step; },
        [&](const Row& row, const Cell& cell) {
          return lookup(row, cell).w;
        },
        [&](float ts, auto get) {
          if (get() >= a.level) {
            hit = make_float4(start[0] + ts * seg[0], start[1] + ts * seg[1],
                              start[2] + ts * seg[2], ts);
            return false;
          }
          return true;
        });
    // keep the nearer of the frame's and the accumulated hits
    const bool take = (hit.w > 0.0f && s0.w > 0.0f) ? hit.w < s0.w
                                                   : hit.w > 0.0f;
    if (take) *st = hit;
  }
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
