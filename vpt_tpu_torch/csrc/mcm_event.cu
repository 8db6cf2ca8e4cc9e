// MCM event machine: one progressive frame of `steps` null-collision events
// for every pixel's photon.
//
// Replaces the XLA fori_loop of vpt_tpu/renderers/mcm.py:197-310
// (render_frame; flight_phase :85-110, interact_phase :113-184,
// _photon_reset :45-55, Scene.sample_color_tracking in base.py:187-219).
// It has no Pallas original; its TF lookup is the device function of the
// tf1d kernel (vpt_tpu/pallas/tf1d.py:74-100, here tf1d.cuh).
//
// Bound on the H100: every event makes one dependent 16-byte (bf16) or
// 32-byte (f32) random read of a corner row, then a few dozen flops and one
// or two hashes; a 128^3 table of bf16 rows is 32 MiB, so the reads mostly
// hit the 50 MB L2.  The limit is the latency of that dependent read chain
// and the branch divergence between a warp's photons, not bandwidth.
// Design: one thread per pixel keeps its photon in registers for all
// `steps` events and touches the state in device memory once per frame;
// the TF row sits in shared memory, the inverse MVP and the environment
// texel are read through the read-only cache; a thread draws random numbers
// only on the branch it takes, so no tentative draws are computed.  Many
// resident warps hide the read latency.
//
// Numerics follow the plain PyTorch event (renderers/mcm.py) operation by
// operation: built with -fmad=false, IEEE division and sqrt, half-to-even
// rintf for the cheb distance, NaN-propagating min/max.  logf, sinf and cosf
// are not bitwise equal to other libraries' results, so a pixel's stream
// may part from the plain version's after a flip in a float comparison.
#include <cstdint>
#include <cuda_runtime.h>

#include "tf1d.cuh"

namespace {

#define F32(x) ((float)(x))

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

// state = pcg(state); u = float(state) / float(~0u)
__device__ __forceinline__ float uniform(uint32_t& s) {
  s = pcg(s);
  return __uint2float_rn(s) / F32(4294967295.0);
}

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
  const float* ndc;      // (n, 2)
  float inv_res_x, inv_res_y, seed, extinction, anisotropy, blur, cell;
  int max_bounces, steps, use_skip;
  long long n;
};

// Trilinear fetch from a corner-packed table (sampling.py:480-510): the
// GL CLAMP_TO_EDGE coordinate, one row of the 8 corners (z, y, x; x minor),
// then the lerp chain of _trilerp_chain (sampling.py:424-432).
template <bool kBf16>
__device__ __forceinline__ float fetch(const void* table, int d, int h, int w,
                                       float px, float py, float pz) {
  float ux = vpt_clip(px * (float)w - 0.5f, 0.0f, (float)(w - 1));
  float uy = vpt_clip(py * (float)h - 0.5f, 0.0f, (float)(h - 1));
  float uz = vpt_clip(pz * (float)d - 0.5f, 0.0f, (float)(d - 1));
  float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  float fx = ux - ix, fy = uy - iy, fz = uz - iz;
  int64_t row = ((int64_t)vpt_index(iz, d - 1) * h + vpt_index(iy, h - 1))
                    * w + vpt_index(ix, w - 1);
  float c[8];
  if (kBf16) {
    uint4 q = __ldg((const uint4*)table + row);
    uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] = __uint_as_float(words[k] << 16);
      c[2 * k + 1] = __uint_as_float(words[k] & 0xFFFF0000u);
    }
  } else {
    float4 a = __ldg((const float4*)table + 2 * row);
    float4 b = __ldg((const float4*)table + 2 * row + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  }
  float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  float cx0 = c[0] * gx + c[1] * fx;
  float cx1 = c[2] * gx + c[3] * fx;
  float cx2 = c[4] * gx + c[5] * fx;
  float cx3 = c[6] * gx + c[7] * fx;
  float cy0 = cx0 * gy + cx1 * fy;
  float cy1 = cx2 * gy + cx3 * fy;
  return cy0 * gz + cy1 * fz;
}

// resetPhoton (mcm.py:45-55): stochastic unproject (4 uniforms: disk, then
// square), normalize, clip to the cube.
__device__ __forceinline__ void photon_reset(uint32_t& s, float ndcx,
                                             float ndcy, const Args& a,
                                             float p[3], float dir[3]) {
  float r = uniform(s);
  float ang = F32(6.28318530718) * uniform(s);
  float radius = sqrtf(r);
  float diskx = radius * cosf(ang), disky = radius * sinf(ang);
  float aax = uniform(s), aay = uniform(s);
  float nx = ndcx + diskx * a.blur, ny = ndcy + disky * a.blur;
  float fx = ndcx + (aax * 2.0f - 1.0f) * a.inv_res_x;
  float fy = ndcy + (aay * 2.0f - 1.0f) * a.inv_res_y;
  // apply_mat4 (math3d.py:152-156): out_i = v0 m[i,0] + v1 m[i,1] + ...
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = __ldg(a.mvp + k);
  float f4[4], t4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f4[i] = nx * m[4 * i] + ny * m[4 * i + 1] + -1.0f * m[4 * i + 2]
            + 1.0f * m[4 * i + 3];
    t4[i] = fx * m[4 * i] + fy * m[4 * i + 1] + 1.0f * m[4 * i + 2]
            + 1.0f * m[4 * i + 3];
  }
  float from[3], to[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    from[k] = f4[k] / f4[3];
    to[k] = t4[k] / t4[3];
    dir[k] = to[k] - from[k];
  }
  float n2 = dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2];
  float norm = sqrtf(vpt_nmax(n2, F32(1e-20)));
  float tnear = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dir[k] = dir[k] / norm;
    // intersect_cube (sampling.py:39-47)
    float tmin = (0.0f - from[k]) / dir[k];
    float tmax = (1.0f - from[k]) / dir[k];
    float t1 = vpt_nmin(tmin, tmax);
    tnear = (k == 0) ? t1 : vpt_nmax(tnear, t1);
  }
  float tb = vpt_nmax(tnear, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = from[k] + tb * dir[k];
}

// henyey_greenstein (sampling.py:661-687): the sphere sample (2 uniforms),
// plus the HG cosine (1 uniform) unless |g| < EPS.
__device__ __forceinline__ void henyey_greenstein(uint32_t& s, float g,
                                                  float dir[3]) {
  float r = uniform(s);
  float ang = F32(6.28318530718) * uniform(s);
  float radius = sqrtf(r);
  float d0 = radius * cosf(ang), d1 = radius * sinf(ang);
  float norm = d0 * d0 + d1 * d1;
  float rad2 = 2.0f * sqrtf(vpt_nmax(1.0f - norm, 0.0f));
  float u[3] = {rad2 * d0, rad2 * d1, 1.0f - 2.0f * norm};
  if (fabsf(g) < F32(1e-5)) {
    dir[0] = u[0]; dir[1] = u[1]; dir[2] = u[2];
    return;
  }
  float uu = uniform(s);
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
__global__ void __launch_bounds__(128) mcm_event_kernel(Args a) {
  // the TF row is the kernel's only shared memory (the wrapper's cap)
  extern __shared__ float4 s_tf[];
  for (int i = threadIdx.x; i < a.tw; i += blockDim.x) s_tf[i] = a.tf_row[i];
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

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
  const float ndcx = a.ndc[2 * i], ndcy = a.ndc[2 * i + 1];
  const float maxb = (float)a.max_bounces;

  // per-pixel stream: pcg(19 x + 47 y + 101 seed + 131) over the float bits
  // of the mapped position (ndc * 0.5 + 0.5) and the seed (glsl:128)
  uint32_t s = pcg(19u * __float_as_uint(ndcx * 0.5f + 0.5f)
                   + 47u * __float_as_uint(ndcy * 0.5f + 0.5f)
                   + 101u * __float_as_uint(a.seed) + 131u);

  for (int step = 0; step < a.steps; ++step) {
    // flight: exponential free path, extended over empty cells in skip mode
    float x = vpt_nmax(uniform(s), F32(1e-38));
    float dist = -logf(x) / a.extinction;
    if (skip) dist = vpt_nmax(dist, vpt_nmax(ch - 1.0f, 0.0f) * a.cell);
    float q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = p[k] + dist * dir[k];

    // sample: one corner row, then the TF row
    float v = fetch<kBf16>(a.table, a.d, a.h, a.w, q[0], q[1], q[2]);
    float4 vs;
    float cheb_new = 0.0f;
    if (skip) {
      cheb_new = rintf(vpt_nmax(-v, 0.0f));
      vs = vpt_tf1d_lookup(s_tf, a.tw, vpt_nmax(v, 0.0f), a.tf_mode);
      if (v < -0.5f) vs.w = 0.0f;
    } else {
      vs = vpt_tf1d_lookup(s_tf, a.tw, v, a.tf_mode);
    }

    // classify (mcm.py:122-133)
    float alpha = vs.w;
    float p_null = 1.0f - alpha;
    float p_scatter = (b >= maxb)
        ? 0.0f : alpha * vpt_nmax(vpt_nmax(vs.x, vs.y), vs.z);
    float p_absorb = 1.0f - p_null - p_scatter;
    float fortune = uniform(s);
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
        float r_new = oob ? tr[k] * __ldg(a.env + k) : 0.0f;
        rad[k] = rad[k] + (r_new - rad[k]) / den;
        tr[k] = 1.0f;
      }
      photon_reset(s, ndcx, ndcy, a, p, dir);
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

}  // namespace

extern "C" int vpt_mcm_event(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, const void* mvp, const void* ndc,
    float inv_res_x, float inv_res_y, float seed, float extinction,
    float anisotropy, float blur, float cell, int max_bounces, int steps,
    int use_skip, int n_pixels, void* stream) {
  if (n_pixels <= 0) return 0;
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
  a.ndc = (const float*)ndc;
  a.inv_res_x = inv_res_x; a.inv_res_y = inv_res_y;
  a.seed = seed; a.extinction = extinction; a.anisotropy = anisotropy;
  a.blur = blur; a.cell = cell;
  a.max_bounces = max_bounces; a.steps = steps; a.use_skip = use_skip;
  a.n = n_pixels;
  const int threads = 128;
  unsigned blocks = (unsigned)((n_pixels + threads - 1) / threads);
  size_t smem = (size_t)tw * sizeof(float4);
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16)
    mcm_event_kernel<true><<<blocks, threads, smem, st>>>(a);
  else
    mcm_event_kernel<false><<<blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
