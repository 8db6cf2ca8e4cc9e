// MCM event machine: one progressive frame of `steps` null-collision events
// for every pixel's photon.
//
// Replaces the XLA fori_loop of vpt_tpu/renderers/mcm.py:197-310
// (render_frame; flight_phase :85-110, interact_phase :113-184,
// _photon_reset :45-55, Scene.sample_color_tracking in base.py:187-219).
// It has no Pallas original; its TF lookup is the device function of the
// tf1d kernel (vpt_tpu/pallas/tf1d.py:74-100, here tf1d.cuh), and its RNG,
// ray setup and corner fetch are those of ray.cuh, which the march, ISO
// shade and MCS kernels share.
//
// Bound on the H100: every event runs ~110 float32 operations (flight,
// one dependent 16-byte (bf16) or 32-byte (f32) corner-row read, the TF
// lookup, the classification), every deposit ~125 more (the running mean
// and the photon reset: 15 divisions, a sqrt, and with blur a sin, cos and
// sqrt more) and every scatter ~75 (the Henyey-Greenstein sample).  IEEE
// divisions, logf, sinf and cosf take many instructions each, so the kernel
// issues far more than its operation count.  At 32 events per pixel the
// bound is the operations at 67 TFLOP/s; at 8 it is the state's 120 bytes
// per pixel plus the distinct corner rows the frame fetches, each read
// once, at 3.35 TB/s.
//
// Design: one thread per pixel keeps its photon in registers for all
// `steps` events and touches the state in device memory once a frame.  The
// TF row, the inverse MVP and the environment texel sit in shared memory;
// NDC and the pixel's stream seed are computed from the pixel index.
// Without blur the reset skips the disk sample: its two draws still advance
// the stream, and nothing else of it reaches the result.  Blocks of
// kThreads; 40 registers, no spills, 12 blocks an SM.
//
// Measured against it (bench_mcm_event.py; PERF.md has the numbers): a
// wavefront inside a block (the photons' state in shared memory, dense
// reset and scatter queues built by ballots, a persistent one-wave grid at
// 32 registers) gave the same bits but took 14-16% longer: the lanes that
// a divergent reset or scatter leaves idle cost less than the shared-memory
// traffic and barriers that remove them.  A 32-register cap (16 blocks an
// SM, one wave at 512^2) spills and loses 2-5%; staging the state through
// shared memory coalesces its loads and stores but needs 56 registers and
// loses at 8 events a frame.
//
// Numerics follow the plain PyTorch event (renderers/mcm.py) operation by
// operation: built with -fmad=false, IEEE division and sqrt, half-to-even
// rintf for the cheb distance, NaN-propagating min/max.  logf, sinf and
// cosf are not bitwise equal to other libraries' results, so a pixel's
// stream may part from the plain version's after a flip in a float
// comparison.
#include <cstdint>
#include <cuda_runtime.h>

#include "ray.cuh"

namespace {

#define F32(x) ((float)(x))

constexpr int kThreads = 128;

struct Args {
  float* position;       // (n, 3)
  float* direction;      // (n, 3)
  float* bounces;        // (n,)
  float* transmittance;  // (n, 3)
  float* radiance;       // (n, 3)
  float* samples;        // (n,)
  float* cheb;           // (n,) or null
  const void* table;     // (D*H*W, 8) float32 or bfloat16 corner rows
  int d, h, w;
  const float4* tf_row;  // (tw, 4)
  int tw, tf_mode;       // tf_mode: tf1d.cuh's lookup mode
  const float* env;      // 4 floats: the 1x1 environment texel
  const float* mvp;      // 16 floats, row-major inverse MVP
  int width, height;     // the image; n = width * height
  float inv_res_x, inv_res_y, seed, extinction, anisotropy, blur, cell;
  int max_bounces, steps, use_skip;
};

// resetPhoton (mcm.py:45-55): stochastic unproject (4 uniforms: disk, then
// square), normalize, clip to the cube.  m: the inverse MVP, row-major.
// Without blur the disk offset is a finite value times 0, so ndc + offset
// is ndc: its two draws advance the stream and nothing else is computed.
__device__ __forceinline__ void photon_reset(uint32_t& s, float ndcx,
                                             float ndcy, const Args& a,
                                             const float* m, float p[3],
                                             float dir[3]) {
  float nx = ndcx, ny = ndcy;
  if (a.blur == 0.0f) {
    s = vpt_pcg(vpt_pcg(s));
  } else {
    float r = vpt_uniform(s);
    float ang = F32(6.28318530718) * vpt_uniform(s);
    float radius = sqrtf(r);
    float diskx = radius * cosf(ang), disky = radius * sinf(ang);
    nx = ndcx + diskx * a.blur;
    ny = ndcy + disky * a.blur;
  }
  float aax = vpt_uniform(s), aay = vpt_uniform(s);
  float fx = ndcx + (aax * 2.0f - 1.0f) * a.inv_res_x;
  float fy = ndcy + (aay * 2.0f - 1.0f) * a.inv_res_y;
  float from[3], to[3];
  vpt_unproject(m, nx, ny, fx, fy, from, to);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = to[k] - from[k];
  float n2 = dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2];
  float norm = sqrtf(vpt_nmax(n2, F32(1e-20)));
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = dir[k] / norm;
  float tnear, tfar;
  vpt_intersect_cube(from, dir, &tnear, &tfar);
  float tb = vpt_nmax(tnear, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = from[k] + tb * dir[k];
}

// henyey_greenstein (sampling.py:661-687): the sphere sample (2 uniforms),
// plus the HG cosine (1 uniform) unless |g| < EPS.
__device__ __forceinline__ void henyey_greenstein(uint32_t& s, float g,
                                                  float dir[3]) {
  float r = vpt_uniform(s);
  float ang = F32(6.28318530718) * vpt_uniform(s);
  float radius = sqrtf(r);
  float d0 = radius * cosf(ang), d1 = radius * sinf(ang);
  float norm = d0 * d0 + d1 * d1;
  float rad2 = 2.0f * sqrtf(vpt_nmax(1.0f - norm, 0.0f));
  float u[3] = {rad2 * d0, rad2 * d1, 1.0f - 2.0f * norm};
  if (fabsf(g) < F32(1e-5)) {
    dir[0] = u[0]; dir[1] = u[1]; dir[2] = u[2];
    return;
  }
  float uu = vpt_uniform(s);
  float g2 = g * g;
  float c = (1.0f - g2) / (1.0f - g + 2.0f * g * uu);
  float hgcos = (1.0f + g2 - c * c) / (2.0f * g);
  float proj = u[0] * dir[0] + u[1] * dir[1] + u[2] * dir[2];
  float perp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) perp[k] = u[k] - proj * dir[k];
  float pn = sqrtf(vpt_nmax(
      perp[0] * perp[0] + perp[1] * perp[1] + perp[2] * perp[2],
      F32(1e-12)));
  float st = sqrtf(vpt_nmax(1.0f - hgcos * hgcos, 0.0f));
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = st * (perp[k] / pn) + hgcos * dir[k];
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mcm_event_kernel(Args a) {
  // dynamic: the TF row (tw float4)
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float s_env[3];
  for (int i = threadIdx.x; i < a.tw; i += blockDim.x) s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (threadIdx.x < 3) s_env[threadIdx.x] = __ldg(a.env + threadIdx.x);
  __syncthreads();
  const long long n = (long long)a.width * a.height;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float p[3], dir[3], tr[3], rad[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = a.position[3 * i + k];
    dir[k] = a.direction[3 * i + k];
    tr[k] = a.transmittance[3 * i + k];
    rad[k] = a.radiance[3 * i + k];
  }
  float b = a.bounces[i];
  float samples = a.samples[i];
  const bool skip = a.use_skip != 0;
  float ch = skip ? a.cheb[i] : 0.0f;
  // NDC of the row-major pixel index (row 0 is the bottom of the image);
  // the wrapper keeps width * height below 2^31
  const int y = (int)i / a.width;
  const float ndcx = vpt_pixel_ndc((int)i - y * a.width, a.width);
  const float ndcy = vpt_pixel_ndc(y, a.height);
  const float maxb = (float)a.max_bounces;

  // per-pixel stream: pcg(19 x + 47 y + 101 seed + 131) over the float bits
  // of the mapped position (ndc * 0.5 + 0.5) and the seed (glsl:128)
  uint32_t s = vpt_seed_pixel(ndcx, ndcy, a.seed);

  for (int step = 0; step < a.steps; ++step) {
    // flight: exponential free path, extended over empty cells in skip mode
    float dist = vpt_exponential(s, a.extinction);
    if (skip) dist = vpt_nmax(dist, vpt_nmax(ch - 1.0f, 0.0f) * a.cell);
    float q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = p[k] + dist * dir[k];

    // sample: one corner row, then the TF row
    float v = vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, q[0], q[1], q[2]);
    float4 vs = vpt_color(s_tf, a.tw, a.tf_mode, v, skip);
    float cheb_new = skip ? rintf(vpt_nmax(-v, 0.0f)) : 0.0f;

    // classify (mcm.py:122-133)
    float alpha = vs.w;
    float p_null = 1.0f - alpha;
    float p_scatter = (b >= maxb)
        ? 0.0f : alpha * vpt_nmax(vpt_nmax(vs.x, vs.y), vs.z);
    float p_absorb = 1.0f - p_null - p_scatter;
    float fortune = vpt_uniform(s);
    bool oob = q[0] > 1.0f || q[0] < 0.0f || q[1] > 1.0f || q[1] < 0.0f
               || q[2] > 1.0f || q[2] < 0.0f;
    bool absorb = !oob && fortune < p_absorb;
    bool scatter = !oob && !absorb && fortune < p_absorb + p_scatter;

    if (oob || absorb) {
      // deposit into the running mean, then re-seed the photon
      samples = samples + 1.0f;
      float den = vpt_nmax(samples, 1.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float r_new = oob ? tr[k] * s_env[k] : 0.0f;
        rad[k] = rad[k] + (r_new - rad[k]) / den;
        tr[k] = 1.0f;
      }
      photon_reset(s, ndcx, ndcy, a, s_mvp, p, dir);
      b = 0.0f;
      ch = 0.0f;
    } else {
      if (scatter) {
        henyey_greenstein(s, a.anisotropy, dir);
        b = b + 1.0f;
        tr[0] = tr[0] * vs.x;
        tr[1] = tr[1] * vs.y;
        tr[2] = tr[2] * vs.z;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = q[k];
      ch = cheb_new;
    }
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.position[3 * i + k] = p[k];
    a.direction[3 * i + k] = dir[k];
    a.transmittance[3 * i + k] = tr[k];
    a.radiance[3 * i + k] = rad[k];
  }
  a.bounces[i] = b;
  a.samples[i] = samples;
  if (skip) a.cheb[i] = ch;
}

// Without opting in, a block gets 48 KiB of shared memory, static and
// dynamic together; a TF row near tf1d.MAX_WIDTH (3072 texels, 48 KiB)
// needs more.  The attribute belongs to the current device, so it is set
// on every such launch.
template <bool kBf16>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mcm_event_kernel<kBf16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The launch shape for a TF row of tw texels (see vpt_mcm_event_info).
template <bool kBf16>
cudaError_t info(int tw, int* out) {
  const size_t smem = (size_t)tw * sizeof(float4);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err;
  if ((err = allow_smem<kBf16>(smem)) != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mcm_event_kernel<kBf16>, kThreads, smem)) != cudaSuccess)
    return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mcm_event_kernel<kBf16>))
      != cudaSuccess)
    return err;
  out[0] = kThreads;
  out[1] = per_sm;
  out[2] = sms;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = (int)attr.sharedSizeBytes;
  out[6] = (int)smem;
  return cudaSuccess;
}

template <bool kBf16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long n = (long long)a.width * a.height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)a.tw * sizeof(float4);
  cudaError_t err = allow_smem<kBf16>(smem);
  if (err != cudaSuccess) return err;
  mcm_event_kernel<kBf16><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vpt_mcm_event(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, const void* mvp, int width, int height,
    float inv_res_x, float inv_res_y, float seed, float extinction,
    float anisotropy, float blur, float cell, int max_bounces, int steps,
    int use_skip, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Args a;
  a.position = (float*)position;
  a.direction = (float*)direction;
  a.bounces = (float*)bounces;
  a.transmittance = (float*)transmittance;
  a.radiance = (float*)radiance;
  a.samples = (float*)samples;
  a.cheb = (float*)cheb;
  a.table = table;
  a.d = d; a.h = h; a.w = w;
  a.tf_row = (const float4*)tf_row;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.env = (const float*)env;
  a.mvp = (const float*)mvp;
  a.width = width; a.height = height;
  a.inv_res_x = inv_res_x; a.inv_res_y = inv_res_y;
  a.seed = seed; a.extinction = extinction; a.anisotropy = anisotropy;
  a.blur = blur; a.cell = cell;
  a.max_bounces = max_bounces; a.steps = steps; a.use_skip = use_skip;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(table_bf16 ? launch<true>(a, st) : launch<false>(a, st));
}

// The launch shape of the kernel for a TF row of `tw` texels: out[0..6] =
// threads a block, resident blocks an SM, SMs, registers a thread, local
// (spilled) bytes a thread, static and dynamic shared bytes a block.
extern "C" int vpt_mcm_event_info(int table_bf16, int tw, int* out) {
  return (int)(table_bf16 ? info<true>(tw, out) : info<false>(tw, out));
}
