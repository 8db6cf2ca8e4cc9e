"""The slab's plane map that K10's halo instance and K9's halo fetch (of a
frame and of a band) read in place of ``vpt_slab_z``'s divisions, the prepared band frame of
DOS's row bands, and the C layouts of the structs that carry them.

``_build.slab_plane_map`` is held, for every z plane of the volume, against
the port's plain slab rule (``corner_gather.slab_cells``) and ``vpt_tpu``'s
(``HaloScene._cell_coords``, JAX on the CPU) at S ∈ {1, 2, 4} slabs and
interleave ∈ {1, 2}, and an owned plane's local index against
``halo.slab_planes``.  On the CPU ``dos.render_band`` runs the plain band
slice a slice: its frame is held against ``band_slice_plain``'s bit for bit
(the prepared band frame itself runs only on the card).  The ctypes mirrors
of ``VptLaoHalo``, ``VptDosHalo``, ``VptDosBandFrame``, K8's
``VptMcsHaloFrame``, K6's ``VptMarchHalo`` and K7's ``VptIsoHalo`` are held
against the C declarations, member by member; a mismatch would show only
on the card.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.parallel.halo import HaloScene as JHaloScene
from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import _build, corner_gather, dos_sweep, iso_shade
from vpt_tpu_torch.kernels import lao_march, march, mcs_frame
from vpt_tpu_torch.parallel import halo
from vpt_tpu_torch.renderers import dos, make_scene

DEPTH = 32
LAYOUTS = [(s, m) for s in (1, 2, 4) for m in (1, 2)]
CSRC = _build.CSRC


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads only spin against the
    other workers of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def plane_positions():
    """(DEPTH, 3) float32 positions at the centre of a voxel of each z
    plane (x and y off centre), seeded: the cell of row z has z index
    z."""
    rng = np.random.default_rng(7)
    z = (np.arange(DEPTH, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(DEPTH)
    xy = rng.uniform(0.05, 0.95, size=(DEPTH, 2)).astype(np.float32)
    return np.concatenate([xy, z[:, None]], axis=1)


@pytest.mark.parametrize("num_slabs,interleave", LAYOUTS,
                         ids=[f"S{s}-m{m}" for s, m in LAYOUTS])
def test_plane_map_follows_the_slab_rule(plane_positions, num_slabs,
                                         interleave):
    """Every slab's map gives, for every z plane, the slab-local plane
    and ownership of the port's plain rule and of vpt_tpu's."""
    shape = (DEPTH, 8, 8, 1)
    position = torch.from_numpy(plane_positions)
    for k in range(num_slabs):
        planes = _build.slab_plane_map(DEPTH, num_slabs, k, interleave)
        assert planes.dtype == torch.int32 and planes.shape == (DEPTH, 2)
        zloc, _, _, _, local = corner_gather.slab_cells(
            position, shape, k, num_slabs, interleave)
        assert torch.equal(planes[:, 0].long(), zloc)
        assert torch.equal(planes[:, 1] == k, local)
        owner = planes[:, 1]
        assert bool(((owner >= 0) & (owner < num_slabs)).all())
        jself = types.SimpleNamespace(volume_shape=shape,
                                      num_slabs=num_slabs,
                                      interleave=interleave, slab_index=k)
        jz, _, _, _, _, _, jlocal = JHaloScene._cell_coords(
            jself, jnp.asarray(plane_positions))
        assert np.array_equal(np.asarray(jz), planes[:, 0].numpy())
        assert np.array_equal(np.asarray(jlocal), (owner == k).numpy())


@pytest.mark.parametrize("num_slabs,interleave", LAYOUTS,
                         ids=[f"S{s}-m{m}" for s, m in LAYOUTS])
def test_plane_map_places_owned_planes_in_the_slab(num_slabs, interleave):
    """An owned plane's local index addresses that plane of the slab's
    planes (``halo.slab_planes``), and each plane has one owner."""
    owners = None
    for k in range(num_slabs):
        planes = _build.slab_plane_map(DEPTH, num_slabs, k, interleave)
        held = halo.slab_planes(DEPTH, num_slabs, k, interleave)
        owned = torch.nonzero(planes[:, 1] == k).flatten()
        assert torch.equal(held[planes[owned, 0].long()], owned)
        owners = planes[:, 1] if owners is None else owners
        # the owner of a plane is the same in every slab's map
        assert torch.equal(planes[:, 1], owners)
    counts = torch.bincount(owners.long(), minlength=num_slabs)
    assert bool((counts == DEPTH // num_slabs).all())


@pytest.mark.parametrize("depth,num_slabs,slab_index,interleave", [
    (_build.MAX_PLANES + 4, 4, 0, 1), (30, 4, 0, 1), (32, 2, 2, 1),
    (32, 2, 0, 3), (0, 1, 0, 1)])
def test_plane_map_refuses_what_no_kernel_takes(depth, num_slabs,
                                                slab_index, interleave):
    with pytest.raises(ValueError):
        _build.slab_plane_map(depth, num_slabs, slab_index, interleave)


@pytest.fixture(scope="module")
def band_scene():
    return make_scene(volume.blobs_volume(16, seed=3, device="cpu"),
                      transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                      device="cpu")


def _band(state, r0, r1):
    return {k: (v[r0:r1].clone() if k in ("color", "occlusion")
                else v.clone()) for k, v in state.items()}


def test_render_band_equals_the_plain_band_slices(band_scene):
    """On the CPU a frame of ``dos.render_band`` on a band of rows (its
    extended buffer the whole image's start, its own rows updated) equals
    the same slices through ``band_slice_plain`` bit for bit.  The
    prepared band frame runs only on the card (``tests/test_torch_cuda.py``
    holds it to the band instance and the plain twin)."""
    params = dos.Params(extinction=80.0, steps=13, slices=30, samples=6)
    start = dos.reset(params, 20, 20, band_scene)
    rows = (5, 14)
    n = dos.active_slices(start, params)
    assert 0 < n <= params.steps

    def extend(occ):
        return torch.cat([start["occlusion"][:rows[0]], occ,
                          start["occlusion"][rows[1]:]]), 0

    got = dos.render_band(_band(start, *rows), band_scene, params,
                          (rows[0], 20), extend)
    want = _band(start, *rows)
    for k in range(n):
        ext, ext_row0 = extend(want["occlusion"])
        dos_sweep.band_slice_plain(want, ext, ext_row0, band_scene, params, k,
                                   (rows[0], 20))
    want["depth"] = want["depth"] + float(n) * want["slice_distance"]
    for key in ("color", "occlusion", "depth"):
        assert torch.equal(got[key], want[key]), key
    assert float(got["color"][..., 3].max()) > 0.0


_KINDS = {"int": "c_int", "float": "c_float"}


def c_members(name):
    """The flattened ``(member, ctypes kind name)`` of ``struct name`` in
    ``csrc/``: a base struct's members first, a struct member's own
    members in its place, pointers as ``c_void_p``, an ``x[n]`` array as
    ctypes names its array type."""
    sources = " ".join(p.read_text() for p in sorted(CSRC.glob("*.cu"))
                       + sorted(CSRC.glob("*.cuh")))
    found = re.findall(r"struct " + name + r"(?: : (\w+))? \{(.*?)\n\};",
                       sources, re.S)
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    base, body = found[0]
    out = c_members(base) if base else []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?) (.*)", decl).groups()
        for member in names.split(", "):
            array = re.match(r"(\w+)\[(\d+)\]", member)
            if ctype.endswith("*"):
                out.append((member, "c_void_p"))
            elif array:
                out.append((array.group(1), f"{_KINDS[ctype]}_Array_"
                            f"{array.group(2)}"))
            elif ctype in _KINDS:
                out.append((member, _KINDS[ctype]))
            else:
                out += c_members(ctype)
    return out


def _mirror(cls):
    fields = []
    for klass in reversed(cls.__mro__):
        fields += [(n, t.__name__) for n, t in
                   klass.__dict__.get("_fields_", [])]
    return fields


@pytest.mark.parametrize("cls,struct", [
    (lao_march._HaloArgs, "VptLaoHalo"), (dos_sweep._HaloArgs, "VptDosHalo"),
    (dos_sweep._BandFrameArgs, "VptDosBandFrame"),
    (mcs_frame._HaloFrameArgs, "VptMcsHaloFrame"),
    (march._HaloArgs, "VptMarchHalo"), (iso_shade._HaloArgs, "VptIsoHalo")],
    ids=["VptLaoHalo", "VptDosHalo", "VptDosBandFrame", "VptMcsHaloFrame",
         "VptMarchHalo", "VptIsoHalo"])
def test_prepared_halo_structs_match_the_c_layouts(cls, struct):
    """Each ctypes mirror declares the C struct's members in order and
    kind (the band frame's nested band and slab flattened: their C
    padding falls where the next pointer aligns)."""
    kinds = [kind for _, kind in _mirror(cls)]
    assert kinds == [kind for _, kind in c_members(struct)]
    assert [name for name, _ in _mirror(cls)][-1] \
        == c_members(struct)[-1][0]
