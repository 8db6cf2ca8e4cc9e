"""Resident-photon spatial sharding: photons migrate between slab owners.

Mirrors ``vpt_tpu/parallel/resident.py``, the second spatial-sharding
design.  ``halo.py`` keeps every photon on its pixel's rank and assembles
each remote sample by an ownership-masked sum, so every rank of a ``space``
group runs the whole event for its pixels.  Here photons reside on the rank
that owns the slab holding their next sample, so the space axis divides the
event work too.  The MCM event touches the volume once, at the post-flight
position, so it splits around the fetch:

    event k:   flight (anywhere) → MIGRATE crossers → sample + interact
               (on the owner, from its slab's rows, unmasked)

The per-photon math is ``renderers/mcm.py``'s ``flight_phase`` and
``interact_phase``, so a stall-free frame equals the replicated frame.

- A rank holds a pool of ``capacity`` rows (:func:`resident_reset`): the
  MCM state's fields as (capacity, c) rows, the pixel's ``ndc``,
  ``pixel_id`` and stream ``rstate`` (the port's layout of a stream: an
  int64 holding a uint32), the flags ``occupied`` and ``pending`` (the
  flight taken, the sample not yet), and the int32 counters ``migrated``,
  ``stalled`` and ``dropped``.
- Migration (:func:`_exchange`): departures grouped by destination by a
  stable sort, two ``all_gather``s of the demands and the free slots, the
  same grants computed on every rank (destination s's free slots go to the
  senders in rank order), then ONE ``all_to_all`` over ``space`` of the
  granted rows only, and the arrivals into free slots in slot order.  Rows
  that are not granted stall (they keep their pending position and retry);
  ``dropped`` stays 0 by construction.  The free slots are counted before
  this exchange's departures vacate theirs, as in ``vpt_tpu``: two full
  pools that each wait for the other's departures grant each other nothing,
  and their crossers stall every event (ROADMAP queue 3, decided and
  mirrored).
- A photon still pending at a frame boundary keeps its stream instead of
  the frame's reseed, so stalled runs match the replicated frame
  statistically rather than bit for bit.

On the card a frame runs K5's resident instance
(``kernels/mcm_event.resident_event``): in exact mode ``steps + 1``
launches around ``steps`` exchanges, each launch finishing the previous
event's interactions and starting the next flights; on the CPU (or for a
scene with ``kernels`` False) the plain phases over a
``HaloScene(collective=False, interleave=m)``.  A group of one rank
migrates nothing and issues no collective.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng, sampling
from ..kernels import corner_gather, mcm_event
from ..renderers import mcm
from .halo import (_SCENE_FIELDS, COLLECTIVES, _group_size, halo_scene,
                   place_scene_slabs, slab_of)
from .mesh import axis_group, axis_index, axis_size

#: photon-state fields that ride in the pool (the MCM state dict), stored
#: as (capacity, c) rows; scalars widen to (capacity, 1)
_PH_FIELDS = ("position", "direction", "bounces", "transmittance",
              "radiance", "samples")
_COUNTERS = ("migrated", "stalled", "dropped")
_SCALARS = ("bounces", "samples", "cheb")


def slab_owner(position, depth: int, num_slabs: int, interleave: int = 1):
    """The ``space`` rank that owns a sample position: the slab holding its
    trilinear cell's z0 plane, with ``corner_gather.slab_cells``'s rule
    (the same float32 operations, so ownership and the slab-local fetch
    agree bit for bit); out-of-cube positions clamp.  ``interleave`` m > 1
    gives thin slab t = z0 // (D / (m·S)) to rank t mod S.  Returns int64."""
    i0f, _ = sampling._filter_coords(position[..., 2:3], (depth,))
    z0 = sampling._clamp_index(i0f, (depth,))[..., 0]
    return corner_gather.slab_owners(z0, depth, num_slabs, interleave)


def shard_volume_cyclic(volume, num_slabs: int, interleave: int):
    """(D, H, W, C) → (S, m·(thin_ds+1), H, W, C): rank c's block is its m
    thin slabs {c, c+S, …, c+(m−1)S}, each with its own +z halo plane
    (``halo.slab_of``)."""
    return torch.stack([slab_of(volume, num_slabs, k, interleave)
                        for k in range(num_slabs)])


def _fields(pool):
    return _PH_FIELDS + (("cheb",) if "cheb" in pool else ())


def _ph_of(pool):
    """Pool rows → the MCM photon dict the phases consume."""
    return {f: pool[f][..., 0] if f in _SCALARS else pool[f]
            for f in _fields(pool)}


def _store_ph(pool, ph, mask):
    """Commit ``ph`` into the pool rows where ``mask`` holds."""
    for f in _fields(pool):
        new = ph[f][..., None] if ph[f].dim() == 1 else ph[f]
        pool[f] = torch.where(mask[..., None], new, pool[f])
    return pool


# ---------------------------------------------------------------------------
# Row migration: group → all_to_all → merge
# ---------------------------------------------------------------------------

def _moving(pool):
    """The leaves that travel with a row, in one order on every rank."""
    return sorted(k for k in pool if k != "occupied" and k not in _COUNTERS)


def _words(rows):
    """(n, ...) rows of any leaf as (n, k) int32 words."""
    x = rows.reshape(rows.shape[0],
                     int(np.prod(rows.shape[1:], dtype=np.int64)))
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x.contiguous().view(torch.int32)


def pack_rows(pool, rows, names):
    """The leaves ``names`` of the pool rows ``rows`` as one (n, words)
    int32 tensor (float32 and int32 as their bits, int64 as two words,
    bool as 0/1): one buffer a collective."""
    return torch.cat([_words(pool[name][rows]) for name in names], dim=1)


def unpack_rows(pool, names, words):
    """The inverse of :func:`pack_rows`: ``{name: (n, ...) rows}``."""
    out, col = {}, 0
    for name in names:
        leaf = pool[name]
        per = int(np.prod(leaf.shape[1:], dtype=np.int64))
        width = per * (2 if leaf.dtype == torch.int64 else 1)
        chunk = words.new_empty((words.shape[0], width))
        chunk.copy_(words[:, col:col + width])  # fresh strides
        col += width
        if leaf.dtype == torch.bool:
            vals = chunk != 0
        else:
            vals = chunk.view(leaf.dtype)
        out[name] = vals.reshape((-1,) + tuple(leaf.shape[1:]))
    return out


def _gather_counts(local, group):
    """(S, ...) of every rank's ``local`` int32 tensor, by group rank."""
    from .shard import _all_gather

    size = _group_size(group)
    if size == 1:
        return local[None]
    out = local.new_empty((size * local.shape[0],) + tuple(local.shape[1:]))
    _all_gather(out, local, group)
    COLLECTIVES["all_gather"] += 1
    return out.reshape((size,) + tuple(local.shape))


def _all_to_all_rows(send, in_splits, out_splits, group):
    """Rows of ``send`` to each rank of ``group`` in order (``in_splits``
    rows each), the rows from each in order (``out_splits``): one
    ``all_to_all_single``."""
    import torch.distributed as dist

    recv = send.new_empty((sum(out_splits), send.shape[1]))
    if _group_size(group) == 1:
        return send
    dist.all_to_all_single(recv, send, out_splits, in_splits, group=group)
    COLLECTIVES["all_to_all"] += 1
    return recv


def _exchange(pool, dest, departs, num_slabs: int, fanout: int, group,
              index: int):
    """Move rows flagged ``departs`` to rank ``dest`` of ``group``, in
    place on ``pool``.  Returns ``(stalled, dropped, moved)``: device
    int32 counts, and ``dropped`` a host int.

    Rows group by destination in a stable sort; two all_gathers carry each
    rank's demands and its free slots (counted before this exchange's
    departures vacate theirs); every rank computes the same grants,
    ``grant[i, s] = clip(F_s − Σ_{j<i} D[j, s], 0, D[i, s])``, capped at
    ``fanout``; only the granted rows travel, in one all_to_all whose
    split sizes every rank knows from the grants.  Arrivals come in sender
    order, each sender's in its sorted order, and fill the free slots in
    slot order."""
    dev = dest.device
    occupied = pool["occupied"]
    departs = departs & occupied
    key = torch.where(departs, dest, torch.full_like(dest, num_slabs))
    order = torch.argsort(key, stable=True)      # departing first, by dest
    inv = torch.argsort(order, stable=True)      # slot → sorted position
    slabs = torch.arange(num_slabs, device=dev)
    counts = ((dest[None, :] == slabs[:, None]) & departs[None, :]).sum(
        dim=1, dtype=torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    dest_c = torch.clamp(dest, 0, num_slabs - 1)
    ranks = inv - offsets[dest_c]

    free_here = (~occupied).sum(dtype=torch.int32)
    demand = _gather_counts(counts, group)               # (S, S)
    free_all = _gather_counts(free_here[None], group)    # (S, 1)
    demand = demand.cpu().numpy().astype(np.int64)
    free_all = free_all.cpu().numpy().astype(np.int64)[:, 0]
    prefix = np.cumsum(demand, axis=0) - demand
    grants = np.minimum(np.maximum(free_all[None, :] - prefix, 0), demand)
    cap = np.minimum(grants[index], fanout)
    fits = departs & (ranks < torch.as_tensor(cap, device=dev)[dest_c])
    stalled = (departs & ~fits).sum(dtype=torch.int32)

    names = _moving(pool)
    send_rows = order[fits[order]]               # by destination, then slot
    recv = _all_to_all_rows(pack_rows(pool, send_rows, names),
                            cap.tolist(),
                            np.minimum(grants[:, index], fanout).tolist(),
                            group)

    # vacate the senders, then fill free slots with the arrivals
    occupied = occupied & ~fits
    free_slots = torch.argsort(occupied.to(torch.int8), stable=True)
    n_free = int(free_all[index]) + int(cap.sum())
    n_acc = min(recv.shape[0], n_free)
    slots = free_slots[:n_acc]
    for name, rows in unpack_rows(pool, names, recv[:n_acc]).items():
        pool[name][slots] = rows
    occupied[slots] = True
    pool["occupied"] = occupied
    return stalled, recv.shape[0] - n_acc, fits.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------

def reset_pool(scene, params: mcm.Params, height: int, width: int,
               n_data: int, num_slabs: int, capacity: int | None = None,
               seed: float = 0.0, interleave: int = 1) -> dict:
    """The whole ``(n_data, S, capacity, …)`` pool of :func:`resident_reset`
    as numpy arrays (``vpt_tpu``'s layout, zero counters), the same on
    every rank."""
    n_pix = height * width
    if n_pix % n_data:
        raise ValueError(f"{n_pix} pixels not divisible by data={n_data}")
    group = n_pix // n_data
    if capacity is None:
        capacity = group                      # slack = S: stall-free
    if capacity * num_slabs < group:
        raise ValueError(
            f"capacity {capacity} × {num_slabs} slabs cannot hold "
            f"{group} photons per data group")
    state = mcm.reset(params, height, width, scene, seed=seed)
    ndc = sampling.pixel_ndc(height, width, device=scene.device)

    fields = _PH_FIELDS + (("cheb",) if "cheb" in state else ())
    rows = {f: state[f].reshape(n_pix, -1).cpu().numpy() for f in fields}
    rows["ndc"] = ndc.reshape(n_pix, 2).cpu().numpy()
    owner = slab_owner(torch.from_numpy(rows["position"]),
                       scene.volume.shape[0], num_slabs, interleave).numpy()

    pool = {f: np.zeros((n_data, num_slabs, capacity, v.shape[-1]),
                        v.dtype) for f, v in rows.items()}
    pool["pixel_id"] = np.full((n_data, num_slabs, capacity), n_pix,
                               np.int32)
    pool["rstate"] = np.zeros((n_data, num_slabs, capacity), np.int64)
    pool["occupied"] = np.zeros((n_data, num_slabs, capacity), bool)
    pool["pending"] = np.zeros((n_data, num_slabs, capacity), bool)

    for gi in range(n_data):
        pix = np.arange(gi * group, (gi + 1) * group)
        own = owner[pix].astype(np.int64)
        order = np.argsort(own, kind="stable")
        sp, so = pix[order], own[order]
        counts = np.bincount(so, minlength=num_slabs)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ranks = np.arange(group) - starts[so]
        direct = ranks < capacity
        slabs_idx = so[direct]
        slots_idx = ranks[direct]
        # spill the overflow into free slots, lowest slot index first; a
        # committed photon may sit anywhere: it migrates once it goes
        # pending
        spill_pix = sp[~direct]
        if spill_pix.size:
            fill0 = np.minimum(counts, capacity)
            free = np.arange(capacity)[:, None] >= fill0[None, :]
            take = np.argwhere(free)[:spill_pix.size]  # by slot, then slab
            slabs_idx = np.concatenate([slabs_idx, take[:, 1]])
            slots_idx = np.concatenate([slots_idx, take[:, 0]])
            sp = np.concatenate([sp[direct], spill_pix])
        else:
            sp = sp[direct]
        for f, v in rows.items():
            pool[f][gi, slabs_idx, slots_idx] = v[sp]
        pool["pixel_id"][gi, slabs_idx, slots_idx] = sp
        pool["occupied"][gi, slabs_idx, slots_idx] = True
    for c in _COUNTERS:
        pool[c] = np.zeros((n_data, num_slabs), np.int32)
    return pool


def resident_reset(scene, params: mcm.Params, height: int, width: int,
                   mesh, num_slabs: int, capacity: int | None = None,
                   seed: float = 0.0, data_axis: str = "data",
                   space_axis: str = "space", interleave: int = 1) -> dict:
    """This rank's pool: the replicated MCM reset (``mcm.reset``, the same
    photon seeding), distributed into the ranks' pools by slab ownership of
    each photon's entry position, the overflow spilled to free slots
    elsewhere (a committed photon may sit anywhere: it migrates once it
    goes pending).  Every rank computes the whole distribution alike and
    keeps its block of the ``(n_data, S, capacity, …)`` pool, on the
    scene's device.  ``capacity`` defaults to the pixels of a data group
    (stall-free); fewer than group / S raises."""
    from ..interop import resident_pool_from_numpy

    pool = reset_pool(scene, params, height, width,
                      axis_size(mesh, data_axis), num_slabs, capacity, seed,
                      interleave)
    return resident_pool_from_numpy(pool, axis_index(mesh, data_axis),
                                    axis_index(mesh, space_axis),
                                    scene.device)


# ---------------------------------------------------------------------------
# The resident frame
# ---------------------------------------------------------------------------

def _dest_of(pool, hs):
    """Each row's owner among the HaloScene ``hs``'s slabs: its position's
    slab, or out of the cube (where the sample is discarded) a uniform
    pixel hash instead of piling onto the boundary slabs."""
    pos = pool["position"]
    dest = slab_owner(pos, hs.volume_shape[0], hs.num_slabs, hs.interleave)
    oob = ((pos > 1.0) | (pos < 0.0)).any(-1)
    return torch.where(oob, pool["pixel_id"].to(torch.int64) % hs.num_slabs,
                       dest)


def resident_render_frame(mesh, scene, num_slabs: int, height: int,
                          width: int, data_axis: str = "data",
                          space_axis: str = "space",
                          fanout: int | None = None, interleave: int = 1,
                          migrate_every: int = 1):
    """The resident-photon MCM frame.

    Returns ``(frame_fn, tables)``: ``frame_fn(pool, tables, params, seed,
    frame_number)`` runs one frame on this rank's pool from
    :func:`resident_reset`, in place (counters included), and returns it;
    ``tables`` is this rank's (volume slab, corner-table rows or None,
    cheb-skip rows or None) (``halo.place_scene_slabs`` with
    ``interleave``), so a caller may drop the scene.  ``fanout`` bounds
    the rows exchanged an event and destination (None: the pool's
    capacity, stall-free).  ``migrate_every`` 1 is the exact mode (flight,
    migrate, interact each event); k > 1 the amortized mode: each round one
    exchange, then k (flight, interact) events, photons that cross a slab
    boundary mid-round parking (pending, remote) until the next round
    (``params.steps`` must be a multiple of k)."""
    import torch.distributed as dist

    if scene.majorant is not None:
        raise ValueError(
            "resident_render_frame does not implement the majorant-grid "
            "tracking machine (its flight needs the coarse grid); build "
            "the scene with tracking='none'/'cheb' or use the "
            "replicated/halo paths")
    if axis_size(mesh, space_axis) != num_slabs:
        raise ValueError(f"{num_slabs} slabs on a {space_axis} axis of "
                         f"{axis_size(mesh, space_axis)} ranks: one slab a "
                         "rank")
    index = axis_index(mesh, space_axis)
    group = axis_group(mesh, space_axis)
    if _group_size(group) > 1 and dist.get_rank(group) != index:
        raise ValueError("the space group's ranks must follow the mesh's "
                         "space coordinates")
    fields = {name: getattr(scene, name) for name in _SCENE_FIELDS}
    volume_shape = tuple(scene.volume.shape)
    tables = place_scene_slabs(scene, num_slabs, index, interleave)
    last = {}

    def scene_of(tables):
        key = tuple(id(t) for t in tables)
        if last.get("key") != key:
            last["key"], last["scene"] = key, halo_scene(
                fields, index, num_slabs, None, tables, interleave,
                collective=False, volume_shape=volume_shape)
        return last["scene"]

    def migrate(pool, hs, fo):
        if num_slabs == 1:
            return
        dest = _dest_of(pool, hs)
        stalled, dropped, moved = _exchange(
            pool, dest, pool["pending"] & (dest != index), num_slabs, fo,
            group, index)
        pool["migrated"] += moved
        pool["stalled"] += stalled
        pool["dropped"] += dropped

    def frame_fn(pool, tables, params, seed, frame_number):
        del frame_number  # the seed alone selects the frame's streams
        if migrate_every != 1 and params.steps % migrate_every:
            raise ValueError(
                f"steps={params.steps} not divisible by "
                f"migrate_every={migrate_every}")
        hs = scene_of(tables)
        k = pool["occupied"].shape[0]
        fo = min(fanout, k) if fanout is not None else k
        if pool["position"].is_cuda and hs.kernels:
            mcm_event.check_pool(pool, pool["position"].device)
            run, inv_res = mcm_event.resident_event, (1.0 / width,
                                                      1.0 / height)
        else:
            run, inv_res = _plain_step, mcm.inverse_resolution(
                height, width, pool["ndc"].device)

        def step(reseed, interact, flight):
            run(pool, hs, params, seed, inv_res, reseed, interact, flight)

        # a step runs (reseed, interact, flight) in this order; no
        # migration falls between an interaction and the next flight
        if migrate_every == 1:
            step(True, False, params.steps > 0)
            for e in range(params.steps):
                migrate(pool, hs, fo)
                step(False, True, e < params.steps - 1)
        else:
            rounds = params.steps // migrate_every
            if rounds == 0:
                step(True, False, False)
            for r in range(rounds):
                # the reseed after the round's exchange: it moves pending
                # rows only, which the reseed leaves alone
                migrate(pool, hs, fo)
                step(r == 0, False, True)
                for _ in range(migrate_every - 1):
                    step(False, True, True)
                step(False, True, False)
        return pool

    return frame_fn, tables


def _plain_step(pool, hs, params, seed, inv_res, reseed: bool,
                interact: bool, flight: bool):
    """One step of the frame in plain PyTorch over the HaloScene ``hs``, in
    place on ``pool``, as :func:`mcm_event.resident_event`'s launch: the
    frame's reseed of every row that is not pending, ``vpt_tpu``'s
    ``do_interact`` (the ready rows sample the slab and commit) and its
    ``do_flight`` (the committed rows fly; every occupied row is then
    pending), each where asked, in this order."""
    use_skip = "cheb" in pool
    if reseed:
        fresh = rng.seed_pixels(pool["ndc"] * 0.5 + 0.5, np.float32(seed))
        pool["rstate"] = torch.where(pool["pending"], pool["rstate"], fresh)
    if interact:
        ready = pool["occupied"] & pool["pending"] \
            & (_dest_of(pool, hs) == hs.slab_index)
        if use_skip:
            vs, cheb_new = hs.sample_color_tracking(pool["position"])
        else:
            vs, cheb_new = hs.sample_color(pool["position"]), None
        new_ph, new_rs = mcm.interact_phase(
            _ph_of(pool), pool["rstate"], pool["position"], vs, cheb_new,
            hs, params, pool["ndc"], inv_res, use_skip)
        _store_ph(pool, new_ph, ready)
        pool["rstate"] = torch.where(ready, new_rs, pool["rstate"])
        pool["pending"] = pool["pending"] & ~ready
    if flight:
        occ = pool["occupied"]
        fly = occ & ~pool["pending"]
        rs_f, pos_f = mcm.flight_phase(
            _ph_of(pool), pool["rstate"], params, use_skip,
            mcm.skip_cell_size(hs) if use_skip else None)
        pool["rstate"] = torch.where(fly, rs_f, pool["rstate"])
        pool["position"] = torch.where(fly[..., None], pos_f,
                                       pool["position"])
        pool["pending"] = occ.clone()


# ---------------------------------------------------------------------------
# Display
# ---------------------------------------------------------------------------

def assemble(pool, height: int, width: int, mesh=None):
    """The pool rows scattered back to the (H, W) MCM state dict (one
    photon a pixel, keyed by ``pixel_id``): the display's and the
    comparisons' form.  With ``mesh``, every rank's pool is first
    all-gathered (one collective over the mesh's ranks, every rank gets
    the whole state); without, ``pool`` is one pool or a list of pools."""
    pools = pool if isinstance(pool, (list, tuple)) else [pool]
    names = _fields(pools[0]) + ("pixel_id", "occupied")
    if mesh is not None:
        import torch.distributed as dist

        from .shard import _all_gather

        local = pack_rows(pools[0], slice(None), names)
        world = dist.get_world_size()
        if world > 1:
            out = local.new_empty((world * local.shape[0], local.shape[1]))
            _all_gather(out, local, None)
            COLLECTIVES["all_gather"] += 1
            local = out
        pools = [unpack_rows(pools[0], names, local)]
    rows = {f: torch.cat([p[f] for p in pools]) for f in names}
    n_pix = height * width
    pid = torch.where(rows["occupied"], rows["pixel_id"].to(torch.int64),
                      torch.full_like(rows["pixel_id"], n_pix,
                                      dtype=torch.int64))
    out = {}
    for f in _fields(pools[0]):
        r = rows[f]
        flat = r.new_zeros((n_pix + 1,) + tuple(r.shape[1:]))
        flat[pid] = r
        flat = flat[:n_pix]
        out[f] = flat[..., 0].reshape(height, width) if f in _SCALARS \
            else flat.reshape(height, width, r.shape[-1])
    return out
