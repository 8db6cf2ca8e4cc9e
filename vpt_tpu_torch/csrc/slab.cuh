// The slab-local, ownership-masked cell of a spatially sharded volume
// (parallel/halo.py, HaloScene._cell_coords; vpt_tpu/parallel/halo.py
// :168-197), shared by the MCM event kernel's halo instance (mcm_event.cu)
// and the corner fetch's slab instance (corner_gather.cu).
//
// A rank holds z planes of the volume and the matching rows of its corner
// tables: the contiguous slab [k*ds, (k+1)*ds] (ds = D / S, one halo
// plane, the last slab's repeating plane D - 1).  A position's cell is the
// global GL CLAMP_TO_EDGE cell (ray.cuh's vpt_cell, the plain version's
// operations in their order); the slab's row of it and whether this rank
// owns it follow the plain rule: owner = clip(z0 / ds, 0, S - 1), zloc =
// clip(z0 - k*ds, 0, ds - 1).  A cell never indexes its slab's halo plane
// as z0, so every zloc addresses a row of the slab's table.  Interleaved
// thin slabs (HaloScene.interleave > 1) have the plain rule only: the
// wrappers refuse them on the card (ROADMAP item 16 part 3).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tf1d.cuh"

// The slab a rank holds: its index k of the S slabs.
struct VptSlab {
  int index, count;
};

struct VptSlabCell {
  int64_t row;  // the row of the slab's corner table
  float fx, fy, fz;
  bool local;   // this rank owns the cell
};

__device__ __forceinline__ VptSlabCell vpt_slab_cell(int d, int h, int w,
                                                     VptSlab slab, float px,
                                                     float py, float pz) {
  const float ux = vpt_clip(px * (float)w - 0.5f, 0.0f, (float)(w - 1));
  const float uy = vpt_clip(py * (float)h - 0.5f, 0.0f, (float)(h - 1));
  const float uz = vpt_clip(pz * (float)d - 0.5f, 0.0f, (float)(d - 1));
  const float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  const int z0 = vpt_index(iz);
  const int ds = d / slab.count;
  VptSlabCell c;
  c.local = min(max(z0 / ds, 0), slab.count - 1) == slab.index;
  const int zloc = min(max(z0 - slab.index * ds, 0), ds - 1);
  c.row = ((int64_t)zloc * h + vpt_index(iy)) * w + vpt_index(ix);
  c.fx = ux - ix;
  c.fy = uy - iy;
  c.fz = uz - iz;
  return c;
}
