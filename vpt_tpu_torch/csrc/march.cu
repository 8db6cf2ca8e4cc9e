// March kernel: one progressive frame of a fixed-schedule renderer (EAM,
// MIP, Depth, ISO), generate and integrate, one thread a pixel.
//
// Replaces the XLA lax.scan of vpt_tpu/renderers/_march.py:29-55 (march)
// with the composites of eam.py:61-67, mip.py:44-46, depth.py:60-67 and
// iso.py:83-90 and the integrates of their render_frame.  It has no Pallas
// original; its corner fetch and TF lookup are the device functions of
// ray.cuh and tf1d.cuh (vpt_tpu/pallas/tf1d.py:74-100, and the corner row of
// benchmarks/pallas_gather.py).
//
// Bound on the H100: a slice is one dependent 16-byte (bf16) or 32-byte
// (f32) corner-row read and ~50 operations (coordinates and lerps ~21,
// the TF lookup ~14, the composite up to ~10); a pixel's ray setup is ~66
// operations.  On the 512^2 headline a frame takes ~5 M samples (~0.27 G
// operations, 0.004 ms at 67 TFLOP/s) from ~1 M distinct corner rows,
// which with the state (16 bytes a pixel, read and written once) are
// ~25 MB (0.0075 ms at 3.35 TB/s): bytes bound it.  In practice each
// thread's chain of dependent row reads sets the time.
//
// Design: one thread a pixel keeps its ray and its composite's carry in
// registers and touches the state once a frame.  The TF row and the inverse
// MVP sit in shared memory; NDC comes from the pixel index.  The composite
// is a template parameter.  A pixel whose ray misses the cube samples
// nothing (its frame is fixed); EAM and Depth leave the slice loop once the
// pixel goes inactive (its carry never changes after that); ISO marches its
// schedule from the near end and stops at the first hit, which is the JAX
// backward march's last write; MIP runs every slice.  Blocks of kThreads.
//
// Numerics follow the plain PyTorch frame (renderers/eam.py, mip.py,
// depth.py, iso.py) operation by operation: built with -fmad=false, IEEE
// division and sqrt, NaN-propagating min/max, fmodf for MIP's schedule
// (exact, as JAX's mod on these non-negative values).
#include <cstdint>
#include <cuda_runtime.h>

#include "ray.cuh"

namespace {

constexpr int kThreads = 128;

enum Mode { kEam = 0, kMip = 1, kDepth = 2, kIso = 3 };

struct Args {
  float* state;          // (n, 4), or (n,) for MIP
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  int d, h, w;
  const float4* tf_row;  // (tw, 4)
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  const float* mvp;      // 16 floats, row-major inverse MVP
  int width, height;     // the image; n = width * height
  int slices;
  float step;            // the schedule's step
  float first;           // EAM, Depth: t0; MIP: the offset; ISO: 1 - o*step
  float extinction;      // EAM, Depth
  float level;           // Depth: the threshold; ISO: the isovalue
  float mix;             // EAM, Depth: the running mean's weight 1/n
};

template <int kMode, bool kBf16>
__global__ void __launch_bounds__(kThreads)
march_kernel(Args a) {
  // dynamic: the TF row (tw float4)
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  for (int i = threadIdx.x; i < a.tw; i += blockDim.x) s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  __syncthreads();
  const int n = a.width * a.height;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // the pixel's ray (_march.rays): unproject, slab test clamped at 0
  const int y = i / a.width;
  const float ndcx = vpt_pixel_ndc(i - y * a.width, a.width);
  const float ndcy = vpt_pixel_ndc(y, a.height);
  float from[3], to[3], dir[3];
  vpt_unproject(s_mvp, ndcx, ndcy, ndcx, ndcy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  const float tb0 = vpt_nmax(tnear, 0.0f), tb1 = vpt_nmax(tfar, 0.0f);
  const bool miss = tb0 >= tb1;
  float start[3], seg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    start[k] = from[k] + tb0 * dir[k];
    seg[k] = (from[k] + tb1 * dir[k]) - start[k];
  }

  if (kMode == kEam || kMode == kDepth) {
    const float len = sqrtf(seg[0] * seg[0] + seg[1] * seg[1]
                            + seg[2] * seg[2]);
    const float rsl = len * a.step;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // EAM's carry
    float t = a.first, dacc = 0.0f;                    // Depth's carry
    for (int s = 0; s < (miss ? 0 : a.slices); ++s) {
      const float ts = a.first + (float)s * a.step;
      // inactive for good: the carry never changes after this
      if (kMode == kEam && !(ts < 1.0f && acc.w < 0.99f)) break;
      if (kMode == kDepth && !(t < 1.0f && dacc < a.level)) break;
      const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w,
                                       start[0] + ts * seg[0],
                                       start[1] + ts * seg[1],
                                       start[2] + ts * seg[2]);
      const float4 c = vpt_tf1d_lookup(s_tf, a.tw, v, a.tf_mode);
      if (kMode == kEam) {
        const float alpha = c.w * rsl * a.extinction;
        const float k = 1.0f - acc.w;
        acc.x = acc.x + k * (c.x * alpha);
        acc.y = acc.y + k * (c.y * alpha);
        acc.z = acc.z + k * (c.z * alpha);
        acc.w = acc.w + k * alpha;
      } else {
        dacc = dacc + (1.0f - dacc) * c.w * rsl * a.extinction;
        t = t + a.step;
      }
    }
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
    float4* st = reinterpret_cast<float4*>(a.state) + i;
    float4 s0 = *st;
    s0.x = s0.x + (frame.x - s0.x) * a.mix;
    s0.y = s0.y + (frame.y - s0.y) * a.mix;
    s0.z = s0.z + (frame.z - s0.z) * a.mix;
    s0.w = s0.w + (frame.w - s0.w) * a.mix;
    *st = s0;
  } else if (kMode == kMip) {
    float val = 0.0f;
    for (int s = 0; s < (miss ? 0 : a.slices); ++s) {
      const float ts = fmodf(a.first + (float)s * a.step, 1.0f);
      const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w,
                                       start[0] + ts * seg[0],
                                       start[1] + ts * seg[1],
                                       start[2] + ts * seg[2]);
      val = vpt_nmax(val, vpt_tf1d_lookup(s_tf, a.tw, v, a.tf_mode).w);
    }
    a.state[i] = vpt_nmax(a.state[i], val);
  } else {  // kIso
    // the nearest hit: the schedule (1 - o*step) - s*step from its near
    // end (the largest s), stopping at the first hit
    float4 hit = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    if (!miss) {
      for (int s = a.slices - 1; s >= 0; --s) {
        const float ts = a.first - (float)s * a.step;
        const float px = start[0] + ts * seg[0];
        const float py = start[1] + ts * seg[1];
        const float pz = start[2] + ts * seg[2];
        const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, px, py, pz);
        if (vpt_tf1d_lookup(s_tf, a.tw, v, a.tf_mode).w >= a.level) {
          hit = make_float4(px, py, pz, ts);
          break;
        }
      }
    }
    // keep the nearer of the frame's and the accumulated hits
    float4* st = reinterpret_cast<float4*>(a.state) + i;
    const float4 s0 = *st;
    const bool take = (hit.w > 0.0f && s0.w > 0.0f) ? hit.w < s0.w
                                                   : hit.w > 0.0f;
    if (take) *st = hit;
  }
}

// Without opting in, a block gets 48 KiB of shared memory, static and
// dynamic together; a TF row near tf1d.MAX_WIDTH needs more.  The attribute
// belongs to the current device, so it is set on every such launch.
template <int kMode, bool kBf16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = a.width * a.height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a.tw * sizeof(float4);
  if (smem > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        march_kernel<kMode, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  march_kernel<kMode, kBf16><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_mode(int mode, const Args& a, cudaStream_t stream) {
  switch (mode) {
    case kEam: return launch<kEam, kBf16>(a, stream);
    case kMip: return launch<kMip, kBf16>(a, stream);
    case kDepth: return launch<kDepth, kBf16>(a, stream);
    case kIso: return launch<kIso, kBf16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vpt_march_frame(
    void* state, int mode, const void* table, int table_bf16, int d, int h,
    int w, const void* tf_row, int tw, int tf_mode, const void* mvp,
    int width, int height, int slices, float step, float first,
    float extinction, float level, float mix, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Args a;
  a.state = (float*)state;
  a.table = table;
  a.d = d; a.h = h; a.w = w;
  a.tf_row = (const float4*)tf_row;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.mvp = (const float*)mvp;
  a.width = width; a.height = height;
  a.slices = slices;
  a.step = step; a.first = first; a.extinction = extinction;
  a.level = level; a.mix = mix;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(table_bf16 ? launch_mode<true>(mode, a, st)
                          : launch_mode<false>(mode, a, st));
}
