// The slab-local cell of a spatially sharded volume (parallel/halo.py,
// HaloScene._cell_coords; vpt_tpu/parallel/halo.py:168-197), shared by the
// MCM event kernel's halo and resident instances (mcm_event.cu), the halo
// instances of the march, ISO shade, MCS, DOS and LAO kernels (march.cu,
// iso_shade.cu, mcs_frame.cu, dos_sweep.cu, lao_march.cu) and the corner
// fetch's slab instance (corner_gather.cu); vpt_slab_value, the value of a
// slab cell's row, is the per-pixel kernels'.
//
// A rank holds z planes of the volume and the matching rows of its corner
// tables.  A position's cell is the global GL CLAMP_TO_EDGE cell (ray.cuh's
// vpt_cell, the plain version's operations in their order); the slab's row
// of it and the cell's owner follow the plain rule (corner_gather.
// slab_cells):
// - contiguous slabs (interleave 1): the slab [k*ds, (k+1)*ds] (ds = D / S,
//   one halo plane, the last slab's repeating plane D - 1); owner =
//   clip(z0 / ds, 0, S - 1), zloc = clip(z0 - k*ds, 0, ds - 1);
// - interleaved thin slabs (interleave m > 1): the volume in m*S thin slabs
//   of thin_ds = D / (m*S) planes, thin slab t = z0 / thin_ds held by rank
//   t % S after its (t / S) predecessors there, each with its halo plane:
//   owner = t % S, zloc = (t / S)*(thin_ds + 1) + (z0 - t*thin_ds).
// A cell never indexes its slab's halo plane as z0, so every zloc of an
// owned cell addresses a row of the slab's table; a cell another rank owns
// still addresses a row of it (zloc is clipped, or its thin slab's place).
// masked: the cell is local where this rank owns it (the halo's
// ownership-masked fetch); unmasked, every cell is local (the resident
// machine's fetch, whose caller owns every position it samples).  Both are
// warp-uniform arguments.  K10's halo instance and K9's halo fetch (of a
// frame and of a band) read the same integers from the slab's plane map
// (vpt_slab_plane), built once on the host, in place of vpt_slab_z's
// integer divisions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ray.cuh"

// The slab a rank holds: its index k of the S slabs, the thin slabs a
// rank (1: contiguous) and whether its fetch is masked by ownership.
struct VptSlab {
  int index, count, interleave, masked;
};

struct VptSlabCell {
  int64_t row;  // the row of the slab's corner table
  float fx, fy, fz;
  int owner;    // the rank that owns the cell
  bool local;   // the fetch reads the cell (owned, or unmasked)
};

// The slab-local plane of a cell whose global z index is z0, and in owner
// the rank that owns the cell (the rules above).
__device__ __forceinline__ int vpt_slab_z(int d, VptSlab slab, int z0,
                                          int* owner) {
  if (slab.interleave == 1) {
    const int ds = d / slab.count;
    *owner = min(max(z0 / ds, 0), slab.count - 1);
    return min(max(z0 - slab.index * ds, 0), ds - 1);
  }
  const int thin_ds = d / (slab.interleave * slab.count);
  const int thin = z0 / thin_ds;
  *owner = thin % slab.count;
  return (thin / slab.count) * (thin_ds + 1) + (z0 - thin * thin_ds);
}

// whether a slab's fetch reads a cell that owner owns
__device__ __forceinline__ bool vpt_slab_local(VptSlab slab, int owner) {
  return !slab.masked || owner == slab.index;
}

// the most z planes of a plane map: its copy in a block's shared memory
// stays under 48 KB (kernels/_build.MAX_PLANES)
constexpr int kVptMaxPlanes = 6144;

// The slab's plane map: for each global plane z0 of the volume, {the
// slab-local plane, the owner} that vpt_slab_z gives, built once on the
// host (kernels/_build.slab_plane_map) and staged in shared memory by the
// kernels that read it, so that placing a cell takes one load and no
// division.  The same integers as vpt_slab_z; local as vpt_slab_local.
__device__ __forceinline__ int vpt_slab_plane(const int2* planes,
                                              VptSlab slab, int z0,
                                              bool* local) {
  const int2 m = planes[z0];
  *local = vpt_slab_local(slab, m.y);
  return m.x;
}

// Copy the d planes of a plane map into shared memory, the block's threads
// striding over them; the caller synchronises the block before reading.
__device__ __forceinline__ void vpt_stage_planes(int2* s_planes,
                                                 const int2* planes, int d) {
  for (int z = threadIdx.x; z < d; z += blockDim.x) s_planes[z] = planes[z];
}

// vpt_slab_cell through a plane map: the same cell, fractions and local
// flag, its row of the slab's table in Row (int where the table has fewer
// than 2^31 rows, as ray.cuh's vpt_cell).
template <class Row>
__device__ __forceinline__ VptCell<Row> vpt_slab_plane_cell(
    int d, int h, int w, VptSlab slab, const int2* planes, float px,
    float py, float pz, bool* local) {
  const float ux = vpt_clip(px * (float)w - 0.5f, 0.0f, (float)(w - 1));
  const float uy = vpt_clip(py * (float)h - 0.5f, 0.0f, (float)(h - 1));
  const float uz = vpt_clip(pz * (float)d - 0.5f, 0.0f, (float)(d - 1));
  const float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  const int zloc = vpt_slab_plane(planes, slab, vpt_index(iz), local);
  VptCell<Row> c;
  c.row = ((Row)zloc * h + vpt_index(iy)) * w + vpt_index(ix);
  c.fx = ux - ix;
  c.fy = uy - iy;
  c.fz = uz - iz;
  return c;
}

__device__ __forceinline__ VptSlabCell vpt_slab_cell(int d, int h, int w,
                                                     VptSlab slab, float px,
                                                     float py, float pz) {
  const float ux = vpt_clip(px * (float)w - 0.5f, 0.0f, (float)(w - 1));
  const float uy = vpt_clip(py * (float)h - 0.5f, 0.0f, (float)(h - 1));
  const float uz = vpt_clip(pz * (float)d - 0.5f, 0.0f, (float)(d - 1));
  const float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  VptSlabCell c;
  const int zloc = vpt_slab_z(d, slab, vpt_index(iz), &c.owner);
  c.local = vpt_slab_local(slab, c.owner);
  c.row = ((int64_t)zloc * h + vpt_index(iy)) * w + vpt_index(ix);
  c.fx = ux - ix;
  c.fy = uy - iy;
  c.fz = uz - iz;
  return c;
}

// (value, channel 1) of a slab cell's row of a (slab rows, 8 * channels)
// corner table, kC = 0 (one channel; channel 1 is 0) or 2: ray.cuh's row
// read and lerp chain, as the whole-table fetch runs them on the global
// cell's row, which holds the same corners.
template <bool kBf16, int kC, class Row>
__device__ __forceinline__ float2 vpt_slab_value(const void* table,
                                                 const VptCell<Row>& cell) {
  if constexpr (kC == 2) {
    return vpt_lerp_rg<kBf16, 2>(vpt_load_rows<kBf16, 2>(table, cell.row),
                                 cell);
  } else {
    return make_float2(
        vpt_lerp_row<kBf16>(vpt_load_row<kBf16>(table, cell.row), cell),
        0.0f);
  }
}

template <bool kBf16, int kC>
__device__ __forceinline__ float2 vpt_slab_value(const void* table,
                                                 const VptSlabCell& c) {
  const VptCell<int64_t> cell = {c.row, c.fx, c.fy, c.fz};
  return vpt_slab_value<kBf16, kC, int64_t>(table, cell);
}
