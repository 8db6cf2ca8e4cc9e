// MCM event machine: one progressive frame of `steps` null-collision events
// for every pixel's photon.
//
// Replaces the XLA fori_loop of vpt_tpu/renderers/mcm.py:197-310
// (render_frame; flight_phase :85-110, interact_phase :113-184,
// _photon_reset :45-55, Scene.sample_color_tracking in base.py:187-219;
// the majorant-grid branch :224-307 with skipgrid.flight_step; the
// equirect Scene.sample_env at an escape).
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
// The majorant-grid machine (make_scene(tracking="grid")) and an
// environment map larger than 1x1 are template instances beside the
// headline's, whose code they leave as it was.  A grid event reads one
// float2 of the (N^3, 2) grid (32 KB at N = 16, L1- and L2-resident),
// computes the DDA boundary and flies against extinction * maxalpha.  A
// hop (no collision inside the cell) does not fetch the volume: its color
// reaches no result, since only a collision inside the cube can absorb or
// scatter, and the classification's uniform is drawn regardless.  A map
// is read at an escape deposit only, through the read-only cache
// (ray.cuh's vpt_sample_environment).  Two-channel and filtered volumes
// run mcm_event_ext_kernel, the same body (mcm_event) with ray.cuh's ext
// fetch: the filter a warp-uniform argument, the channels a template
// parameter; a two-channel scene reads its 2D TF rows through the
// read-only cache and copies no TF row into shared memory.  The body's
// kC = 0 branches are the headline's code, so its instances keep their
// registers (bench_mcm_event.py --registers against the parent tree).
//
// The flight (mcm_flight), the colour of a fetched value (mcm_value_color)
// and the interaction (mcm_interact) are device functions that the
// whole-frame kernel, the halo instance (ArgsHalo below: a spatially
// sharded volume, a launch an event and one more, with the all-reduce of
// each photon's masked slab-local value between them) and the resident
// instance (ArgsResident below: photons in pools of rows on the rank that
// owns their next sample, migrating between a flight and its interaction;
// replaces the fori_loop of vpt_tpu/parallel/resident.py:441-478) share;
// the whole-frame instances keep
// their registers (40) and their time (bench_mcm_event.py against the
// parent tree, PERF.md §6).
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
#include "slab.cuh"

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
  const float* env;      // the (env_h, env_w, 4) environment map
  int env_h, env_w;
  const float2* grid;    // (N^3,) [maxalpha, chebdist] cells, or null
  int grid_n;            // N
  const float* mvp;      // 16 floats, row-major inverse MVP
  int width, height;     // the image; n = width * height
  float inv_res_x, inv_res_y, seed, extinction, anisotropy, blur, cell;
  int max_bounces, steps, use_skip;
  int row0, full_height; // the launch's rows of the image: [row0,
                         // row0 + height) of full_height rows
};

// The ext instances' argument (two-channel and filtered scenes, ray.cuh):
// the headline's instances take Args, so their code is the one they had.
struct ArgsExt : Args {
  const void* tf_table;  // (th*tw, 16) packed TF of the table's type
  int th;
  int filter;            // ray.cuh's VptFilter
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

// skipgrid.flight_step: the majorant of the cell that holds p (nudged along
// dir by EPS_NUDGE) and, in *t_bound, the distance along dir to the cell's
// boundary (the DDA crossing), extended to a (chebdist - 1)-cell hop in
// exactly-empty space, at least 0.  One float2 of the (N^3, 2) grid, 32 KB
// at N = 16, so it stays in L1 and L2.
__device__ __forceinline__ float grid_flight(const float2* grid, int n,
                                             const float p[3],
                                             const float dir[3],
                                             float* t_bound) {
  const float fn = (float)n;
  int c[3];
  float t = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float pk = p[k] + F32(1e-5) * dir[k];
    c[k] = min(max(__float2int_rz(floorf(pk * fn)), 0), n - 1);
    // divide only where the component is non-zero: inf otherwise
    const float boundary = ((float)c[k] + (dir[k] > 0.0f ? 1.0f : 0.0f))
                           / fn;
    const float tk = dir[k] != 0.0f ? (boundary - p[k]) / dir[k]
                                    : __int_as_float(0x7f800000);
    t = (k == 0) ? tk : vpt_nmin(t, tk);
  }
  const float2 cell = __ldg(grid + ((int64_t)c[2] * n + c[1]) * n + c[0]);
  if (cell.x == 0.0f && cell.y >= 2.0f)
    t = vpt_nmax(t, vpt_nmax(cell.y - 1.0f, 0.0f) / fn);
  *t_bound = vpt_nmax(t, 0.0f);
  return cell.x;
}

// The exact or cheb-skip flight (mcm.flight_phase, mcm.py:85-110): an
// exponential free path, extended over (ch - 1) empty cells in skip mode,
// to the tentative position q.  The whole-frame kernel and the halo
// instance run it alike.
template <class A>
__device__ __forceinline__ void mcm_flight(uint32_t& s, const float p[3],
                                           const float dir[3], float ch,
                                           bool skip, const A& a,
                                           float q[3]) {
  float dist = vpt_exponential(s, a.extinction);
  if (skip) dist = vpt_nmax(dist, vpt_nmax(ch - 1.0f, 0.0f) * a.cell);
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = p[k] + dist * dir[k];
}

// The colour of a fetched value v (the TF row's lookup) and, from a
// cheb-skip table, its cheb distance, rounded half to even as jnp.round.
// (In this order: the colour first, as the whole-frame kernel always had
// it, keeps that kernel's 40 registers without a spill.)
__device__ __forceinline__ float4 mcm_value_color(const float4* s_tf,
                                                  const Args& a, float v,
                                                  bool skip,
                                                  float& cheb_new) {
  const float4 vs = vpt_color(s_tf, a.tw, a.tf_mode, v, skip);
  cheb_new = skip ? rintf(vpt_nmax(-v, 0.0f)) : 0.0f;
  return vs;
}

// The interaction at q with the sampled colour vs (mcm.interact_phase,
// mcm.py:113-184): classify (mcm.py:122-133), then deposit into the
// running mean and re-seed, scatter, or pass a null collision, committing
// the photon in place.  cheb_new is the landing cell's cheb distance (skip
// mode); collide is false for a hop of the grid machine.  The whole-frame
// kernel and the halo instance run it alike.
template <bool kMap, class A>
__device__ __forceinline__ void mcm_interact(
    uint32_t& s, const A& a, const float* s_mvp, const float* s_env,
    float ndcx, float ndcy, float maxb, const float q[3], float4 vs,
    float cheb_new, bool collide, float p[3], float dir[3], float tr[3],
    float rad[3], float& b, float& samples, float& ch) {
  float alpha = vs.w;
  float p_null = 1.0f - alpha;
  float p_scatter = (b >= maxb)
      ? 0.0f : alpha * vpt_nmax(vpt_nmax(vs.x, vs.y), vs.z);
  float p_absorb = 1.0f - p_null - p_scatter;
  float fortune = vpt_uniform(s);
  bool oob = q[0] > 1.0f || q[0] < 0.0f || q[1] > 1.0f || q[1] < 0.0f
             || q[2] > 1.0f || q[2] < 0.0f;
  bool absorb = !oob && collide && fortune < p_absorb;
  bool scatter = !oob && collide && !absorb
                 && fortune < p_absorb + p_scatter;

  if (oob || absorb) {
    // deposit into the running mean, then re-seed the photon; an escape
    // deposits the environment along the photon's direction
    float env[3];
    if constexpr (kMap) {
      const float4 e = oob ? vpt_sample_environment(
                                 reinterpret_cast<const float4*>(a.env),
                                 a.env_h, a.env_w, dir[0], dir[1], dir[2])
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      env[0] = e.x; env[1] = e.y; env[2] = e.z;
    } else {
      env[0] = s_env[0]; env[1] = s_env[1]; env[2] = s_env[2];
    }
    samples = samples + 1.0f;
    float den = vpt_nmax(samples, 1.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float r_new = oob ? tr[k] * env[k] : 0.0f;
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

// The three machines are template instances: kGrid the majorant grid's
// flight (the exact and cheb-skip flights otherwise, by use_skip), kMap an
// environment map larger than 1x1 (the headline's 1x1 texel sits in
// shared memory otherwise).  kC is 0 for the headline's fetch (one
// channel, linear), else the channels of an ext instance (ray.cuh's
// two-channel and filtered fetch, with no cheb-skip table).  The
// headline's instance is <bf16, false, false, 0>.
template <bool kBf16, bool kGrid, bool kMap, int kC, class A>
__device__ __forceinline__ void mcm_event(const A& a) {
  // dynamic: the TF row (tw float4); a two-channel scene reads the 2D TF
  // table instead
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float s_env[3];
  if (kC != 2)
    for (int i = threadIdx.x; i < a.tw; i += blockDim.x)
      s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (!kMap && threadIdx.x < 3)
    s_env[threadIdx.x] = __ldg(a.env + threadIdx.x);
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
  const bool skip = !kGrid && kC == 0 && a.use_skip != 0;
  float ch = skip ? a.cheb[i] : 0.0f;
  // NDC of the row-major pixel index (row 0 is the bottom of the image),
  // the row taken in the window's image; the wrapper keeps width * height
  // below 2^31
  const int y = (int)i / a.width;
  const float ndcx = vpt_pixel_ndc((int)i - y * a.width, a.width);
  const float ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
  const float maxb = (float)a.max_bounces;

  // per-pixel stream: pcg(19 x + 47 y + 101 seed + 131) over the float bits
  // of the mapped position (ndc * 0.5 + 0.5) and the seed (glsl:128)
  uint32_t s = vpt_seed_pixel(ndcx, ndcy, a.seed);

  for (int step = 0; step < a.steps; ++step) {
    float q[3];
    float4 vs;
    float cheb_new = 0.0f;
    bool collide = true;   // a hop of the grid machine collides with nothing
    if constexpr (kGrid) {
      // flight against the cell's majorant mu; a tentative collision past
      // the cell's boundary becomes a hop just beyond it (mcm.py:224-241)
      float t_bound;
      const float mu = grid_flight(a.grid, a.grid_n, p, dir, &t_bound);
      const float tau = vpt_exponential(s, 1.0f);
      const float sigma = a.extinction * mu;
      const float t_coll = sigma > 0.0f ? tau / vpt_nmax(sigma, F32(1e-30))
                                        : __int_as_float(0x7f800000);
      collide = t_coll < t_bound;
      const float dist = collide ? t_coll : t_bound + F32(1e-5);
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = p[k] + dist * dir[k];
      // only a collision reads the volume: a hop's color reaches nothing
      vs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (collide) {
        if constexpr (kC == 0) {
          vs = vpt_color(s_tf, a.tw, a.tf_mode,
                         vpt_fetch<kBf16>(a.table, a.d, a.h, a.w, q[0],
                                          q[1], q[2]), false);
        } else {
          vs = vpt_fetch_color<kBf16, kC>(a.table, a.d, a.h, a.w, a.filter,
                                          q[0], q[1], q[2], s_tf, a.tw,
                                          a.tf_mode, a.tf_table, a.th);
        }
      }
      // the collision's rate relative to the local majorant
      vs.w = mu > 0.0f ? vpt_nmin(vs.w / mu, 1.0f) : 0.0f;
    } else {
      mcm_flight(s, p, dir, ch, skip, a, q);

      // sample: one corner row, then the TF row
      if constexpr (kC == 0) {
        vs = mcm_value_color(s_tf, a, vpt_fetch<kBf16>(a.table, a.d, a.h,
                                                       a.w, q[0], q[1],
                                                       q[2]),
                             skip, cheb_new);
      } else {
        vs = vpt_fetch_color<kBf16, kC>(a.table, a.d, a.h, a.w, a.filter,
                                        q[0], q[1], q[2], s_tf, a.tw,
                                        a.tf_mode, a.tf_table, a.th);
      }
    }

    mcm_interact<kMap>(s, a, s_mvp, s_env, ndcx, ndcy, maxb, q, vs,
                       cheb_new, collide, p, dir, tr, rad, b, samples, ch);
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

template <bool kBf16, bool kGrid, bool kMap>
__global__ void __launch_bounds__(kThreads)
mcm_event_kernel(Args a) {
  mcm_event<kBf16, kGrid, kMap, 0>(a);
}

// The ext instances: kC channels (1: a filtered volume, float32 rows; 2: a
// two-channel volume, no grid).
template <bool kBf16, bool kGrid, bool kMap, int kC>
__global__ void __launch_bounds__(kThreads)
mcm_event_ext_kernel(ArgsExt a) {
  mcm_event<kBf16, kGrid, kMap, kC>(a);
}

// The halo instance (parallel/halo.py, a HaloScene frame): the volume is
// z slabs over the ranks of a group, each rank holding its slab's corner
// rows, and a value is the sum over the ranks of their masked slab-local
// fetches (vpt_tpu/parallel/halo.py:199-216), an all-reduce between the
// fetch and its use.  So a frame of E events is E + 1 launches on the state
// tensors, the wrapper all-reducing the values between them: launch e
// finishes event e - 1 (interact: the colour of the summed value, with
// skip its cheb distance, then mcm_interact) and starts event e (flight:
// mcm_flight and this rank's masked value, slab.cuh's cell; 0 where another
// rank owns it).  Between launches a photon keeps its state, its stream as
// it was before the flight and the value: the interact redraws the flight
// from that stream (the same operations on the same inputs, so the same
// position) instead of storing the tentative position, so an event moves
// the state in and out once, plus the value and the stream across the
// all-reduce (136 bytes a pixel with cheb-skip).  The state round-trips
// device memory between launches (float32, exact), so a frame equals the
// whole-frame kernel's when one rank owns every cell.  Instances: the
// headline's fetch (kC = 0: one channel, linear; exact and cheb-skip
// flights by use_skip) and the two-channel fetch (kC = 2: ray.cuh's
// vpt_load_rows and vpt_lerp_rg over the slab cell, the pair (value,
// channel 1) summed over the ranks, then the 2D TF lookup vpt_tf2d, as
// mcm_event_ext_kernel's over the whole table), bf16 or float32 rows, a
// 1x1 or equirect environment; contiguous or interleaved slabs, masked or
// not (slab.cuh).  A HaloScene has no majorant grid and no filter.
struct ArgsHalo : ArgsExt {
  uint32_t* rng;   // (n,) each photon's stream before its flight
  float* value;    // (n, kC or 1) the masked slab-local value, then the sum
  VptSlab slab;
  int interact;    // 1: finish the previous event (0: seed the streams)
  int flight;      // 1: start the next event
};

// The colour of a fetched (value, channel 1): mcm_value_color's for one
// channel, the 2D TF lookup of the packed TF table for two (a two-channel
// scene has no cheb-skip table).
template <bool kBf16, int kC>
__device__ __forceinline__ float4 slab_color(const float4* s_tf,
                                             const ArgsExt& a, float2 v,
                                             bool skip, float& cheb_new) {
  if constexpr (kC == 2) {
    cheb_new = 0.0f;
    return vpt_tf2d<kBf16>(a.tf_table, a.tw, a.th, v.x, v.y);
  } else {
    return mcm_value_color(s_tf, a, v.x, skip, cheb_new);
  }
}

// The TF row (one channel), the inverse MVP and the 1x1 environment texel
// in shared memory, for a launch that runs interactions.
template <bool kMap, int kC>
__device__ __forceinline__ void load_interact_smem(const Args& a,
                                                   float4* s_tf,
                                                   float* s_mvp,
                                                   float* s_env) {
  if (kC != 2)
    for (int i = threadIdx.x; i < a.tw; i += blockDim.x)
      s_tf[i] = a.tf_row[i];
  if (threadIdx.x < 16) s_mvp[threadIdx.x] = __ldg(a.mvp + threadIdx.x);
  if (!kMap && threadIdx.x < 3)
    s_env[threadIdx.x] = __ldg(a.env + threadIdx.x);
  __syncthreads();
}

template <bool kBf16, bool kMap, int kC>
__global__ void __launch_bounds__(kThreads)
mcm_halo_kernel(ArgsHalo a) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float s_env[3];
  if (a.interact) load_interact_smem<kMap, kC>(a, s_tf, s_mvp, s_env);
  constexpr int kV = kC == 2 ? 2 : 1;  // values a photon
  const long long n = (long long)a.width * a.height;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float p[3], dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = a.position[3 * i + k];
    dir[k] = a.direction[3 * i + k];
  }
  const bool skip = kC == 0 && a.use_skip != 0;
  float ch = skip ? a.cheb[i] : 0.0f;
  const int y = (int)i / a.width;
  const float ndcx = vpt_pixel_ndc((int)i - y * a.width, a.width);
  const float ndcy = vpt_pixel_ndc(a.row0 + y, a.full_height);
  uint32_t s;
  if (a.interact) {
    float tr[3], rad[3], q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tr[k] = a.transmittance[3 * i + k];
      rad[k] = a.radiance[3 * i + k];
    }
    float b = a.bounces[i];
    float samples = a.samples[i];
    s = a.rng[i];
    mcm_flight(s, p, dir, ch, skip, a, q);
    float cheb_new;
    const float2 v = make_float2(a.value[kV * i],
                                 kV == 2 ? a.value[kV * i + 1] : 0.0f);
    const float4 vs = slab_color<kBf16, kC>(s_tf, a, v, skip, cheb_new);
    mcm_interact<kMap>(s, a, s_mvp, s_env, ndcx, ndcy, (float)a.max_bounces,
                       q, vs, cheb_new, true, p, dir, tr, rad, b, samples,
                       ch);
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
  } else {
    s = vpt_seed_pixel(ndcx, ndcy, a.seed);
  }
  if (a.flight) {
    a.rng[i] = s;
    float q[3];
    mcm_flight(s, p, dir, ch, skip, a, q);
    const VptSlabCell c = vpt_slab_cell(a.d, a.h, a.w, a.slab, q[0], q[1],
                                        q[2]);
    float2 v = make_float2(0.0f, 0.0f);
    if (c.local) v = vpt_slab_value<kBf16, kC>(a.table, c);
    a.value[kV * i] = v.x;
    if (kV == 2) a.value[kV * i + 1] = v.y;
  }
}

using KernelHalo = void (*)(ArgsHalo);

// The halo instance for a bf16 (flags & 1) or float32 table, an
// environment map larger than 1x1 (flags & 4) or the 1x1 texel, and two
// channels (flags & 16) or the headline's fetch.
template <int kC>
KernelHalo pick_halo_fetch(int flags) {
  switch (flags & 5) {
    case 0: return mcm_halo_kernel<false, false, kC>;
    case 1: return mcm_halo_kernel<true, false, kC>;
    case 4: return mcm_halo_kernel<false, true, kC>;
    default: return mcm_halo_kernel<true, true, kC>;
  }
}

KernelHalo pick_halo(int flags) {
  return (flags & 16) ? pick_halo_fetch<2>(flags) : pick_halo_fetch<0>(flags);
}

// The resident instance (parallel/resident.py, vpt_tpu/parallel/
// resident.py:312-525): photons live in a pool of rows on the rank that
// owns the slab holding their next sample and migrate between ranks (the
// wrapper's all_to_all) between a flight and its interaction.  A launch
// works over the pool's rows (width rows, height 1): each row carries its
// photon's state, its pixel's NDC, id and stream (a uint32 in an int64,
// the port's layout of a stream) and the flags occupied and pending (the
// flight taken, the sample not yet).  Unlike the halo instance, the flight
// stores the tentative position in position and the advanced stream in
// rstate and sets pending, as vpt_tpu's do_flight does, since the photon
// may change rank before its interaction.  A launch runs, in order:
// - reseed (the frame's first launch): every row that is not pending takes
//   its pixel's frame stream (the frame's per-pixel reseed; a pending row
//   keeps its mid-event stream);
// - interact: each ready row (occupied, pending, and owned here: the
//   owner of its position's cell, or pixel_id % S out of the cube) samples
//   this rank's slab unmasked (slab.cuh), takes the colour and commits the
//   interaction (mcm_interact), and is no longer pending;
// - flight: each occupied row that is not pending flies (mcm_flight);
//   every occupied row is then pending.
// An unoccupied row keeps its state: only the reseed gives it a stream and
// the flight clears its pending flag, as vpt_tpu's frame does to every
// row, so every pool field equals the plain frame's.  No migration falls
// between an interaction and the next flight, so one launch finishes
// event e and starts event e + 1: an exact frame of E events is E + 1
// launches around E exchanges.  Instances: the headline's fetch or two
// channels (kC), bf16 or float32 rows, a 1x1 or equirect environment.
struct ArgsResident : ArgsExt {
  long long* rstate;        // (n,) each row's stream
  const float* ndc;         // (n, 2) its pixel's NDC
  const int* pixel_id;      // (n,)
  const uint8_t* occupied;  // (n,) bool
  uint8_t* pending;         // (n,) bool
  VptSlab slab;             // unmasked
  int reseed, interact, flight;
};

template <bool kBf16, bool kMap, int kC>
__global__ void __launch_bounds__(kThreads)
mcm_resident_kernel(ArgsResident a) {
  extern __shared__ float4 s_tf[];
  __shared__ float s_mvp[16];
  __shared__ float s_env[3];
  if (a.interact) load_interact_smem<kMap, kC>(a, s_tf, s_mvp, s_env);
  const long long n = a.width;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool pend = a.pending[i] != 0;
  const bool fresh = a.reseed && !pend;
  uint32_t s = fresh ? vpt_seed_pixel(a.ndc[2 * i], a.ndc[2 * i + 1],
                                      a.seed)
                     : (uint32_t)a.rstate[i];
  if (!a.occupied[i]) {
    if (fresh) a.rstate[i] = (long long)s;
    if (a.flight && pend) a.pending[i] = 0;
    return;
  }
  float p[3], dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = a.position[3 * i + k];
    dir[k] = a.direction[3 * i + k];
  }
  const bool skip = kC == 0 && a.use_skip != 0;
  float ch = skip ? a.cheb[i] : 0.0f;
  bool moved = false;
  if (a.interact && pend) {
    const VptSlabCell c = vpt_slab_cell(a.d, a.h, a.w, a.slab, p[0], p[1],
                                        p[2]);
    const bool oob = p[0] > 1.0f || p[0] < 0.0f || p[1] > 1.0f
                     || p[1] < 0.0f || p[2] > 1.0f || p[2] < 0.0f;
    const int dest = oob ? a.pixel_id[i] % a.slab.count : c.owner;
    if (dest == a.slab.index) {
      float tr[3], rad[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tr[k] = a.transmittance[3 * i + k];
        rad[k] = a.radiance[3 * i + k];
      }
      float b = a.bounces[i];
      float samples = a.samples[i];
      float cheb_new;
      const float4 vs = slab_color<kBf16, kC>(
          s_tf, a, vpt_slab_value<kBf16, kC>(a.table, c), skip, cheb_new);
      const float q[3] = {p[0], p[1], p[2]};
      mcm_interact<kMap>(s, a, s_mvp, s_env, a.ndc[2 * i], a.ndc[2 * i + 1],
                         (float)a.max_bounces, q, vs, cheb_new, true, p, dir,
                         tr, rad, b, samples, ch);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.transmittance[3 * i + k] = tr[k];
        a.radiance[3 * i + k] = rad[k];
      }
      a.bounces[i] = b;
      a.samples[i] = samples;
      pend = false;
      moved = true;
    }
  }
  if (a.flight) {
    if (!pend) {
      float q[3];
      mcm_flight(s, p, dir, ch, skip, a, q);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = q[k];
      moved = true;
    }
    pend = true;
  }
  if (moved) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.position[3 * i + k] = p[k];
      a.direction[3 * i + k] = dir[k];
    }
    if (skip) a.cheb[i] = ch;
  }
  if (moved || fresh) a.rstate[i] = (long long)s;
  if (pend != (a.pending[i] != 0)) a.pending[i] = pend ? 1 : 0;
}

using KernelResident = void (*)(ArgsResident);

// The resident instance for the bits of pick_halo.
template <int kC>
KernelResident pick_resident_fetch(int flags) {
  switch (flags & 5) {
    case 0: return mcm_resident_kernel<false, false, kC>;
    case 1: return mcm_resident_kernel<true, false, kC>;
    case 4: return mcm_resident_kernel<false, true, kC>;
    default: return mcm_resident_kernel<true, true, kC>;
  }
}

KernelResident pick_resident(int flags) {
  return (flags & 16) ? pick_resident_fetch<2>(flags)
                      : pick_resident_fetch<0>(flags);
}

// Without opting in, a block gets 48 KiB of shared memory, static and
// dynamic together; a TF row near tf1d.MAX_WIDTH (3072 texels, 48 KiB)
// needs more.  The attribute belongs to the current device, so it is set
// on every such launch.
using Kernel = void (*)(Args);
using KernelExt = void (*)(ArgsExt);

// The instance for a table type (flags & 1), the grid machine (flags & 2)
// and an environment map larger than 1x1 (flags & 4).
template <bool kBf16>
Kernel pick_machine(int flags) {
  switch (flags & 6) {
    case 0: return mcm_event_kernel<kBf16, false, false>;
    case 2: return mcm_event_kernel<kBf16, true, false>;
    case 4: return mcm_event_kernel<kBf16, false, true>;
    default: return mcm_event_kernel<kBf16, true, true>;
  }
}

Kernel pick(int flags) {
  return (flags & 1) ? pick_machine<true>(flags) : pick_machine<false>(flags);
}

// The ext instance (flags & 8) for the same bits and two channels (flags &
// 16); null for what make_scene never builds: a grid with two channels,
// a filtered volume in bf16 rows.
template <bool kBf16, int kC>
KernelExt pick_ext_machine(int flags) {
  if constexpr (kC == 2) {
    if (flags & 2) return nullptr;
    return (flags & 4) ? mcm_event_ext_kernel<kBf16, false, true, 2>
                       : mcm_event_ext_kernel<kBf16, false, false, 2>;
  } else {
    switch (flags & 6) {
      case 0: return mcm_event_ext_kernel<kBf16, false, false, 1>;
      case 2: return mcm_event_ext_kernel<kBf16, true, false, 1>;
      case 4: return mcm_event_ext_kernel<kBf16, false, true, 1>;
      default: return mcm_event_ext_kernel<kBf16, true, true, 1>;
    }
  }
}

KernelExt pick_ext(int flags) {
  if (flags & 16)
    return (flags & 1) ? pick_ext_machine<true, 2>(flags)
                       : pick_ext_machine<false, 2>(flags);
  return (flags & 1) ? nullptr : pick_ext_machine<false, 1>(flags);
}

// the dynamic shared memory of an instance: the TF row, which a
// two-channel instance does not copy
size_t tf_smem(int flags, int tw) {
  return (flags & 16) ? 0 : (size_t)tw * sizeof(float4);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The launch shape for smem dynamic bytes (see vpt_mcm_event_info).
template <class K>
cudaError_t info(K kernel, size_t smem, int* out) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
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

template <class K, class A>
cudaError_t launch(K kernel, const A& a, size_t smem, cudaStream_t stream) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const long long n = (long long)a.width * a.height;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One frame of any instance.  env: the (env_h, env_w, 4) float32
// environment map (1x1: the headline's shared texel); grid: null, or the
// (grid_n^3, 2) float32 majorant grid, which selects the grid machine
// (use_skip is then 0).  channels 2 (a two-channel table of (D*H*W, 16)
// rows and the packed (th*tw, 16) TF table tf_table of its type) or a
// filter other than linear (0) select an ext instance (use_skip 0).  The
// launch renders rows [row0, row0 + height) of a full_height-row image:
// their NDCs and streams are those rows' of the whole image (inv_res_y is
// 1 / full_height).
extern "C" int vpt_mcm_event_frame(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, int env_h, int env_w, const void* grid,
    int grid_n, const void* mvp, int width, int height, float inv_res_x,
    float inv_res_y, float seed, float extinction, float anisotropy,
    float blur, float cell, int max_bounces, int steps, int use_skip,
    const void* tf_table, int th, int channels, int filter, int row0,
    int full_height, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  if (row0 < 0 || full_height < row0 + height)
    return (int)cudaErrorInvalidValue;
  ArgsExt a;
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
  a.env_h = env_h; a.env_w = env_w;
  a.grid = (const float2*)grid;
  a.grid_n = grid_n;
  a.mvp = (const float*)mvp;
  a.width = width; a.height = height;
  a.inv_res_x = inv_res_x; a.inv_res_y = inv_res_y;
  a.seed = seed; a.extinction = extinction; a.anisotropy = anisotropy;
  a.blur = blur; a.cell = cell;
  a.max_bounces = max_bounces; a.steps = steps; a.use_skip = use_skip;
  a.row0 = row0; a.full_height = full_height;
  a.tf_table = tf_table;
  a.th = th;
  a.filter = filter;
  const bool ext = channels == 2 || filter != 0;
  const int flags = (table_bf16 ? 1 : 0) | (grid ? 2 : 0)
                    | (env_h == 1 && env_w == 1 ? 0 : 4) | (ext ? 8 : 0)
                    | (channels == 2 ? 16 : 0);
  if ((channels != 1 && channels != 2) || filter < 0 || filter > 2
      || (ext && use_skip))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tf_smem(flags, tw);
  if (ext) return (int)launch(pick_ext(flags), a, smem, (cudaStream_t)stream);
  const Args& base = a;
  return (int)launch(pick(flags), base, smem, (cudaStream_t)stream);
}

// The same frame through the argument list the event kernel has taken
// since its redesign (every build of it exports this: env is a 1x1 texel,
// no grid, one channel, linear), so that builds can be timed against each
// other.
extern "C" int vpt_mcm_event(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, const void* mvp, int width, int height,
    float inv_res_x, float inv_res_y, float seed, float extinction,
    float anisotropy, float blur, float cell, int max_bounces, int steps,
    int use_skip, void* stream) {
  return vpt_mcm_event_frame(
      position, direction, bounces, transmittance, radiance, samples, cheb,
      table, table_bf16, d, h, w, tf_row, tw, tf_mode, env, 1, 1, nullptr,
      0, mvp, width, height, inv_res_x, inv_res_y, seed, extinction,
      anisotropy, blur, cell, max_bounces, steps, use_skip, nullptr, 0, 1, 0,
      0, height, stream);
}

// The launch shape of the instance `flags` (1: a bf16 table, 2: the grid
// machine, 4: an environment map larger than 1x1, 8: an ext instance, 16:
// with two channels) for a TF row of `tw` texels: out[0..6] = threads a
// block, resident blocks an SM, SMs, registers a thread, local (spilled)
// bytes a thread, static and dynamic shared bytes a block.
extern "C" int vpt_mcm_event_info(int flags, int tw, int* out) {
  const size_t smem = tf_smem(flags, tw);
  return (int)((flags & 8) ? info(pick_ext(flags), smem, out)
                           : info(pick(flags), smem, out));
}

// The scene's part of a halo or resident launch (the Args fields both
// take): table (the rank's slab of the corner table the events sample, the
// cheb-skip table with use_skip, (slab rows, 8 * channels); d, h, w the
// whole volume's), the TF row, the environment, the inverse MVP and, for
// two channels, the packed (th*tw, 16) TF table of the table's type.
static void slab_scene_args(ArgsExt& a, const void* table, int d, int h,
                            int w, const void* tf_row, int tw, int tf_mode,
                            const void* env, int env_h, int env_w,
                            const void* mvp, const void* tf_table, int th,
                            float inv_res_x, float inv_res_y, float seed,
                            float extinction, float anisotropy, float blur,
                            float cell, int max_bounces, int use_skip) {
  a.table = table;
  a.d = d; a.h = h; a.w = w;
  a.tf_row = (const float4*)tf_row;
  a.tw = tw;
  a.tf_mode = tf_mode;
  a.env = (const float*)env;
  a.env_h = env_h; a.env_w = env_w;
  a.mvp = (const float*)mvp;
  a.tf_table = tf_table;
  a.th = th;
  a.inv_res_x = inv_res_x; a.inv_res_y = inv_res_y;
  a.seed = seed; a.extinction = extinction; a.anisotropy = anisotropy;
  a.blur = blur; a.cell = cell;
  a.max_bounces = max_bounces; a.steps = 1; a.use_skip = use_skip;
}

static void state_args(Args& a, void* position, void* direction,
                       void* bounces, void* transmittance, void* radiance,
                       void* samples, void* cheb) {
  a.position = (float*)position;
  a.direction = (float*)direction;
  a.bounces = (float*)bounces;
  a.transmittance = (float*)transmittance;
  a.radiance = (float*)radiance;
  a.samples = (float*)samples;
  a.cheb = (float*)cheb;
}

// the flags of a halo or resident instance, or -1 for what none takes
static int slab_flags(int table_bf16, int env_h, int env_w, int channels,
                      int use_skip, const void* tf_table) {
  if ((channels != 1 && channels != 2)
      || (channels == 2 && (use_skip || tf_table == nullptr)))
    return -1;
  return (table_bf16 ? 1 : 0) | (env_h == 1 && env_w == 1 ? 0 : 4)
         | (channels == 2 ? 16 : 0);
}

static bool slab_ok(int d, int slab_index, int num_slabs, int interleave) {
  return num_slabs >= 1 && interleave >= 1 && slab_index >= 0
         && slab_index < num_slabs && d % (num_slabs * interleave) == 0;
}

// One launch of the halo instance (see ArgsHalo): interact finishes the
// previous event (the TF row or table, environment and inverse MVP; the
// value the sum over the slabs), flight starts the next; the scene's
// arguments as slab_scene_args's, channels 1 or 2 (two: tf_table, no
// use_skip).  rng (n,) uint32 and value (n, channels) float32 carry an
// event between launches; a launch without interact seeds the streams
// (the frame's first).  The slab: its index of num_slabs, the thin slabs a
// rank (interleave) and whether the fetch is masked (slab.cuh).  The
// launch renders rows [row0, row0 + height) of a full_height-row image, as
// vpt_mcm_event_frame's.
extern "C" int vpt_mcm_halo_event(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, int env_h, int env_w, const void* mvp,
    const void* tf_table, int th, int channels, int width, int height,
    float inv_res_x, float inv_res_y, float seed, float extinction,
    float anisotropy, float blur, float cell, int max_bounces, int use_skip,
    int row0, int full_height, void* rng, void* value, int slab_index,
    int num_slabs, int interleave, int masked, int interact, int flight,
    void* stream) {
  if (width <= 0 || height <= 0) return 0;
  const int flags = slab_flags(table_bf16, env_h, env_w, channels,
                               use_skip, tf_table);
  if (row0 < 0 || full_height < row0 + height || flags < 0
      || !slab_ok(d, slab_index, num_slabs, interleave))
    return (int)cudaErrorInvalidValue;
  ArgsHalo a = {};
  state_args(a, position, direction, bounces, transmittance, radiance,
             samples, cheb);
  slab_scene_args(a, table, d, h, w, tf_row, tw, tf_mode, env, env_h, env_w,
                  mvp, tf_table, th, inv_res_x, inv_res_y, seed, extinction,
                  anisotropy, blur, cell, max_bounces, use_skip);
  a.width = width; a.height = height;
  a.row0 = row0; a.full_height = full_height;
  a.rng = (uint32_t*)rng;
  a.value = (float*)value;
  a.slab = {slab_index, num_slabs, interleave, masked ? 1 : 0};
  a.interact = interact;
  a.flight = flight;
  return (int)launch(pick_halo(flags), a, tf_smem(flags, tw),
                     (cudaStream_t)stream);
}

// The launch shape of the halo instance for flags 1 (a bf16 table), 4 (an
// environment map larger than 1x1) and 16 (two channels) and a TF row of
// `tw` texels, as vpt_mcm_event_info's.
extern "C" int vpt_mcm_halo_info(int flags, int tw, int* out) {
  return (int)info(pick_halo(flags), tf_smem(flags, tw), out);
}

// One launch of the resident instance (see ArgsResident) over a pool of
// `rows` rows: the state's seven pointers, the scene's arguments as
// slab_scene_args's (channels 1 or 2), inv_res the whole image's; the
// pool's rstate (rows,) int64, ndc (rows, 2) float32, pixel_id (rows,)
// int32, occupied and pending (rows,) bool; this rank's slab (unmasked);
// the launch's parts reseed, interact and flight.
extern "C" int vpt_mcm_resident_event(
    void* position, void* direction, void* bounces, void* transmittance,
    void* radiance, void* samples, void* cheb, const void* table,
    int table_bf16, int d, int h, int w, const void* tf_row, int tw,
    int tf_mode, const void* env, int env_h, int env_w, const void* mvp,
    const void* tf_table, int th, int channels, int rows, float inv_res_x,
    float inv_res_y, float seed, float extinction, float anisotropy,
    float blur, float cell, int max_bounces, int use_skip, void* rstate,
    const void* ndc, const void* pixel_id, const void* occupied,
    void* pending, int slab_index, int num_slabs, int interleave,
    int reseed, int interact, int flight, void* stream) {
  if (rows <= 0) return 0;
  const int flags = slab_flags(table_bf16, env_h, env_w, channels,
                               use_skip, tf_table);
  if (flags < 0 || !slab_ok(d, slab_index, num_slabs, interleave))
    return (int)cudaErrorInvalidValue;
  ArgsResident a = {};
  state_args(a, position, direction, bounces, transmittance, radiance,
             samples, cheb);
  slab_scene_args(a, table, d, h, w, tf_row, tw, tf_mode, env, env_h, env_w,
                  mvp, tf_table, th, inv_res_x, inv_res_y, seed, extinction,
                  anisotropy, blur, cell, max_bounces, use_skip);
  a.width = rows; a.height = 1;
  a.row0 = 0; a.full_height = 1;
  a.rstate = (long long*)rstate;
  a.ndc = (const float*)ndc;
  a.pixel_id = (const int*)pixel_id;
  a.occupied = (const uint8_t*)occupied;
  a.pending = (uint8_t*)pending;
  a.slab = {slab_index, num_slabs, interleave, 0};
  a.reseed = reseed;
  a.interact = interact;
  a.flight = flight;
  return (int)launch(pick_resident(flags), a, tf_smem(flags, tw),
                     (cudaStream_t)stream);
}

// The launch shape of the resident instance for the flags of
// vpt_mcm_halo_info.
extern "C" int vpt_mcm_resident_info(int flags, int tw, int* out) {
  return (int)info(pick_resident(flags), tf_smem(flags, tw), out);
}
