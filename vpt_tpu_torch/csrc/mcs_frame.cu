// MCS kernel: one progressive frame of Monte-Carlo single scattering by
// delta tracking, generate and integrate, one thread a pixel.
//
// Replaces the XLA lax.while_loops of vpt_tpu/renderers/mcs.py:47-178
// (generate: sample_distance :86-118, sample_transmittance :120-152) and
// its integrate (:181-185).  It has no Pallas original; its RNG, ray setup,
// corner fetch and TF lookup are the device functions of ray.cuh and
// tf1d.cuh, which the MCM event kernel shares.
//
// Bound on the H100: a tracking step is one exponential draw (a logf), a
// division, one dependent corner-row read and a TF lookup, ~70 operations;
// a pixel runs ~1 + extinction x (path length) of them along its ray and
// as many along its shadow segment, plus ~120 of ray setup.  The state is
// 16 bytes a pixel, read and written once.  With the default extinction
// (1) on the 512^2 headline a frame takes ~0.1 M tracking steps, far
// fewer operations (~0.04 G) than the bytes of the state and the ~80 k
// distinct rows take (~10 MB, 0.003 ms at 3.35 TB/s): bytes bound it.
// The dependent reads and the divergence of the per-pixel loops hold it
// above.
//
// Design: one thread a pixel runs both tracking loops in registers, each
// to the pixel's own exit (the JAX loop's done mask, pixel by pixel); a
// pixel whose ray misses the cube or escapes writes the environment texel
// without tracking the shadow segment.  The TF row, the inverse MVP and
// the 1x1 environment texel sit in shared memory; NDC and the stream seed
// come from the pixel index; the frame's scatter direction comes from the
// host.  With a cheb-skip tracking table the free paths extend over empty
// cells and colors come from that table, as in the MCM event kernel.
//
// Numerics follow the plain PyTorch frame (renderers/mcs.py) operation by
// operation: built with -fmad=false, IEEE division and sqrt, NaN-
// propagating min/max, half-to-even rintf for the cheb distance.  logf is
// not bitwise equal to other libraries' results, so a pixel's stream may
// part from the plain version's after a flip in a float comparison.
#include <cstdint>
#include <cuda_runtime.h>

#include "ray.cuh"

namespace {

constexpr int kThreads = 128;
// mcs._MAX_TRACKING_ITERS, the tracking loops' backstop
constexpr int kMaxIters = 100000;

struct Args {
  float4* state;         // (n, 4): the running mean
  const void* table;     // (D*H*W, 8) corner rows: tracking or volume
  int d, h, w;
  const float4* tf_row;  // (tw, 4)
  int tw, tf_mode;
  const float* env;      // 4 floats: the 1x1 environment texel
  const float* mvp;      // 16 floats, row-major inverse MVP
  int width, height;
  float seed, extinction, cell;
  int use_skip;
  float sx, sy, sz;      // the frame's scatter direction
  float frame_number;    // n of the running mean
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mcs_frame_kernel(Args a) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float4 s_env;
  for (int i = threadIdx.x; i < a.tw; i += blockDim.x) s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (threadIdx.x == 0)
    s_env = make_float4(__ldg(a.env), __ldg(a.env + 1), __ldg(a.env + 2),
                        __ldg(a.env + 3));
  __syncthreads();
  const int n = a.width * a.height;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool skip = a.use_skip != 0;
  const float4 env = s_env;

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

  // the 1x1 environment: what a miss or an escaped path sees
  float4 frame = env;
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
    uint32_t s = vpt_seed_pixel(ndcx, ndcy, a.seed);

    // sampleDistance: a path that leaves the segment takes 1 draw in that
    // iteration, one that stays takes 2
    float dist = 0.0f, cheb = 0.0f;
    for (int it = 0; it < kMaxIters; ++it) {
      uint32_t s1 = s;
      float d = vpt_exponential(s1, a.extinction);
      if (skip) d = vpt_nmax(d, vpt_nmax(cheb - 1.0f, 0.0f) * a.cell);
      const float ndist = dist + d;
      dist = ndist;
      if (ndist > maxc) {
        s = s1;
        break;
      }
      const float f = ndist / maxc;
      const float u = vpt_uniform(s1);
      s = s1;
      const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w,
                                       start[0] + f * seg[0],
                                       start[1] + f * seg[1],
                                       start[2] + f * seg[2]);
      const float alpha = vpt_color(s_tf, a.tw, a.tf_mode, v, skip).w;
      if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
      if (u < alpha) break;                  // a collision
    }

    if (!(dist > maxd)) {
      // the scattering point and its shadow segment to the cube
      const float t = dist / maxc;
      float sp[3], sseg[3];
      const float sdir[3] = {a.sx, a.sy, a.sz};
#pragma unroll
      for (int k = 0; k < 3; ++k) sp[k] = start[k] + t * seg[k];
      float tn2, tf2;
      vpt_intersect_cube(sp, sdir, &tn2, &tf2);
      tf2 = vpt_nmax(tf2, 0.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) sseg[k] = (sp[k] + sdir[k] * tf2) - sp[k];
      const float sd = sqrtf(sseg[0] * sseg[0] + sseg[1] * sseg[1]
                             + sseg[2] * sseg[2]);
      const float sdc = vpt_nmax(sd, 1e-20f);
      const float4 diffuse = vpt_color(
          s_tf, a.tw, a.tf_mode,
          vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, sp[0], sp[1], sp[2]),
          skip);

      // sampleTransmittance: one draw an iteration
      float dist2 = 0.0f, trans = 1.0f;
      cheb = 0.0f;
      for (int it = 0; it < kMaxIters; ++it) {
        float d = vpt_exponential(s, a.extinction);
        if (skip) d = vpt_nmax(d, vpt_nmax(cheb - 1.0f, 0.0f) * a.cell);
        const float ndist = dist2 + d;
        dist2 = ndist;
        if (ndist > sdc) break;
        const float f = ndist / sdc;
        const float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w,
                                         sp[0] + f * sseg[0],
                                         sp[1] + f * sseg[1],
                                         sp[2] + f * sseg[2]);
        trans = trans * (1.0f - vpt_color(s_tf, a.tw, a.tf_mode, v, skip).w);
        if (skip) cheb = rintf(vpt_nmax(-v, 0.0f));
      }
      frame = make_float4(diffuse.x * env.x * trans, diffuse.y * env.y * trans,
                          diffuse.z * env.z * trans,
                          diffuse.w * env.w * trans);
    }
  }

  // the running mean: acc + (frame - acc) / n, the IEEE quotient
  float4 acc = a.state[i];
  acc.x = acc.x + (frame.x - acc.x) / a.frame_number;
  acc.y = acc.y + (frame.y - acc.y) / a.frame_number;
  acc.z = acc.z + (frame.z - acc.z) / a.frame_number;
  acc.w = acc.w + (frame.w - acc.w) / a.frame_number;
  a.state[i] = acc;
}

template <bool kBf16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = a.width * a.height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a.tw * sizeof(float4);
  if (smem > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcs_frame_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  mcs_frame_kernel<kBf16><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vpt_mcs_frame(
    void* state, const void* table, int table_bf16, int d, int h, int w,
    const void* tf_row, int tw, int tf_mode, const void* mvp,
    const void* env, int width, int height, float seed, float extinction,
    float cell, int use_skip, float sx, float sy, float sz,
    float frame_number, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Args a;
  a.state = (float4*)state;
  a.table = table;
  a.d = d; a.h = h; a.w = w;
  a.tf_row = (const float4*)tf_row;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.env = (const float*)env;
  a.mvp = (const float*)mvp;
  a.width = width; a.height = height;
  a.seed = seed; a.extinction = extinction; a.cell = cell;
  a.use_skip = use_skip;
  a.sx = sx; a.sy = sy; a.sz = sz;
  a.frame_number = frame_number;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(table_bf16 ? launch<true>(a, st) : launch<false>(a, st));
}
