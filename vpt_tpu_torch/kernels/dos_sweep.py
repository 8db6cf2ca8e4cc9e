"""The DOS slice kernel (K9): one frame of DOS's slice sweep.

There is no Pallas original: in ``vpt_tpu`` a frame is an XLA ``lax.scan``
over the slices (``vpt_tpu/renderers/dos.py:126-212``, the taps of
``_shifted_occlusion_taps`` ``:43-86``).  Here it is

- :func:`sweep_frame_plain`, ``renderers/dos.slice_table``,
  ``composite_slices`` on the scene with ``kernels=False`` and
  ``advance_depth``, on any device;
- the CUDA kernel ``csrc/dos_sweep.cu``: one cooperative launch a frame, a
  persistent grid over the pixels that runs the frame's slices with a
  grid-wide barrier between them.  Each block computes each slice's row of
  the table (NDC depth, active flag, slice distance, each tap's shift and
  fraction) itself, with :func:`slice_table`'s operations; a pixel
  unprojects at the slice's NDC depth, takes one colour fetch (the corner
  fetch of ``csrc/ray.cuh``, the TF lookup of ``csrc/tf1d.cuh``) before the
  barrier, then composites it into the colour state in place and writes the
  new occlusion (the mean of the disk taps of the previous buffer times the
  slice transmittance) into the other of two occlusion buffers.  The loop
  stops at the first slice past the far depth; the state's occlusion
  tensor ends holding the last slice's buffer (copied back after an odd
  number of slices), and the kernel advances the state's depth in place by
  the active slices.  A two-channel or filtered scene runs the kernel's
  ext instance (the filtered fetch of ``csrc/ray.cuh``, its row of two
  channels and the packed 2D TF), whose cooperative grid comes from that
  instance's own residency.

:func:`sweep_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, images of 2^31 pixels or more, a grid the card cannot
hold at once) and never falls back.  A frame reads nothing back to the
host.  What a launch takes of the scene, the Params and the resolution it
prepares once (``VptDosArgs``, passed as one pointer), with
``tan(aperture)`` from ``dos._tan_aperture`` on the scene's device, so that
the kernel's rows equal :func:`slice_table`'s bit for bit;
:func:`slice_rows_plain` is the kernel's row computation in numpy float32
scalars.  :data:`LAUNCHES` counts kernel launches: one a frame.  A frame
over a ``parallel.halo.HaloScene`` (a rank's z slab) runs the kernel's
halo instance on the card (:func:`halo_sweep_frame`: one fetch of every
slice's masked values, one all-reduce and one cooperative fold a frame,
no read from the card); its plain twin is :func:`sweep_frame_plain` over
the same scene.  A band of rows
(:func:`band_slice`, a slice a launch of the band instance) over a
HaloScene runs the band's halo instance, whose plain twin is
:func:`band_slice_plain` over the same scene.  A band's frame is checked
and prepared once (:func:`band_frame`, a ``VptDosBandFrame`` holding the
state's pointers), so that a slice's call passes the slice and the
previous occlusion only; the halo fetch, a frame's and a band's, places
its cells through the slab's plane map (``_build.slab_plane_map``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from . import _build

#: kernel launches (one a frame) since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the band instance (one a slice), likewise
BAND_LAUNCHES = 0
#: launches of the halo instance (a fetch and a fold a frame; a chunk of
#: ``_build.halo_chunk`` slices each past ``_build.HALO_VALUE_BYTES``),
#: likewise
HALO_LAUNCHES = 0
#: launches of the halo band instance (a fetch a chunk of HALO_CHUNK
#: active slices and a fold a slice), likewise
HALO_BAND_LAUNCHES = 0
#: slices a halo band's fetch samples (``kHaloChunk``; vpt_tpu's sweep
#: samples 8 slices a ``sample_color``, one ``psum`` each)
HALO_CHUNK = 8
#: the leading floats of a table row (``dos.TABLE_HEAD``)
_HEAD = 4
#: the most disk taps the kernel takes: a block holds at least one row of
#: 4 + 4·N floats in its 32 KB of rows (``kRowBytes``)
MAX_SAMPLES = (32 * 1024 // 4 - _HEAD) // 4


def sweep_frame_plain(state, scene, params):
    """One frame of DOS in plain PyTorch, in place on the state."""
    from ..renderers import dos

    table = dos.slice_table(state, scene, params)
    dos.composite_slices(state, dataclasses.replace(scene, kernels=False),
                         params, table)
    dos.advance_depth(state, table)


def band_slice_plain(state, ext, ext_row0: int, scene, params, k: int,
                     window):
    """Slice ``k`` of the frame on a band of rows in plain PyTorch, in
    place on the band's colour and occlusion: ``window`` = (row0, H)
    places the band in the image, ``ext`` (E, W) is the previous slice's
    occlusion from the image's row ``ext_row0``
    (``dos.extended_taps``); the row and occlusion scale are
    ``dos.slice_table``'s and the taps vpt_tpu's sharded taps
    (``dos.hook_taps``)."""
    from .. import sampling
    from ..renderers import dos

    color = state["color"]
    band_h, width = color.shape[:2]
    height = sampling.row_window(window, band_h)[1]
    scene = dataclasses.replace(scene, kernels=False)
    table = dos.slice_table(state, scene, params)
    scale = dos._slice_projection(state, scene, params)[2][k]
    ndc = sampling.pixel_ndc(band_h, width, device=color.device,
                             window=window)
    taps = dos.hook_taps(ndc, state["offsets"], scale)

    def tap_mean(occ):
        return dos._mean_of_taps(dos.extended_taps(ext, ext_row0, taps,
                                                   height, width))

    color, occlusion = dos._slice_step(
        color, state["occlusion"], scene, params, table[k], ndc,
        state["slice_distance"], tap_mean)
    state["color"].copy_(color)
    state["occlusion"].copy_(occlusion)


def slice_rows_plain(depth, max_depth, slice_distance, projection, offsets,
                     tan_aperture, steps: int, height: int, width: int):
    """The kernel's rows of a frame (``dos_row`` of ``csrc/dos_sweep.cu``)
    in numpy float32 scalars, one operation at a time in its order: a
    (steps, 4 + 4·N) float32 array that equals ``dos.slice_table`` bit for
    bit.  ``projection`` is the 4×4 row-major projection, ``offsets`` the
    (N, 2) disk offsets, ``tan_aperture`` the float32 of
    ``dos._tan_aperture``."""
    f = np.float32
    m = np.asarray(projection, np.float32).reshape(4, 4)
    off = np.asarray(offsets, np.float32).reshape(-1, 2)
    depth, max_depth, sd = f(depth), f(max_depth), f(slice_distance)
    one, lim = f(1.0), f(width + 1)
    dims = (f(width), f(height))
    extent = sd * f(tan_aperture)
    rows = np.zeros((steps, _HEAD + 4 * len(off)), np.float32)
    for k in range(steps):
        dk = depth + f(k) * sd
        out = [one * m[r, 0] + one * m[r, 1] + -dk * m[r, 2]
               + one * m[r, 3] for r in range(4)]
        corr = [out[j] / out[3] for j in range(3)]
        scale = (corr[0] * extent, corr[1] * extent)
        rows[k, :_HEAD] = (corr[2], one if dk <= max_depth else f(0.0), sd,
                           f(0.0))
        for j in range(len(off)):
            for c in range(2):
                dd = off[j, c] * scale[c] * dims[c]
                base = np.minimum(np.maximum(np.floor(dd), -lim), lim)
                rows[k, _HEAD + 4 * j + c] = base
                rows[k, _HEAD + 4 * j + 2 + c] = dd - base
    return rows


class _Args(ctypes.Structure):
    """``VptDosExt`` of ``csrc/dos_sweep.cu``: the ``VptDosArgs`` fields,
    then the ext instances'."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("table", "tf_row", "mvp", "projection")]
                + [(name, ctypes.c_int) for name in
                   ("table_bf16", "d", "h", "w", "tw", "tf_mode", "width",
                    "height", "samples", "steps")]
                + [(name, ctypes.c_float) for name in
                   ("extinction", "tan_aperture")]
                + [(name, ctypes.c_int) for name in ("blocks", "device")]
                + [("tf_table", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in
                   ("th", "channels", "filter")])


class _HaloArgs(_Args):
    """``VptDosHalo``: ``VptDosExt`` and the slab's plane map."""
    _fields_ = [("planes", ctypes.c_void_p)]


class _BandFrameArgs(ctypes.Structure):
    """``VptDosBandFrame`` of ``csrc/dos_sweep.cu``: the scene's prepared
    arguments, the band (``VptDosBand``: the state's pointers, the slice,
    the band's rows and the previous occlusion's, the last four set by each
    slice's call), the band's values and the slab (over a HaloScene), and
    the frame's active slices."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("args", "color", "occlusion", "ext", "depth", "max_depth",
                  "slice_distance", "offsets")]
                + [(name, ctypes.c_int) for name in
                   ("slice", "row0", "band_h", "ext_row0", "ext_h")]
                + [("value", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in
                   ("slab_index", "num_slabs", "interleave", "masked",
                    "halo", "n_active")])


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.projection, scene.tf_mxu, scene.transfer_packed,
            scene.filter)


def _prepare(scene, key):
    """What every frame of ``key`` = (params, height, width) takes of the
    scene: the checked tensors, ``tan(aperture)`` and the ``VptDosArgs``
    with the cooperative grid."""
    from ..renderers import dos

    params, height, width = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the DOS kernel indexes pixels "
                         "with 32-bit integers")
    if not 1 <= params.samples <= MAX_SAMPLES or params.steps < 1:
        raise ValueError(f"the DOS kernel takes 1 to {MAX_SAMPLES} disk "
                         "taps and at least one slice a frame")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, mvp, *ext) = \
        _build.scene_args(scene, scene.volume_packed, "DOS", ext=True)
    channels, filt = ext[2:]
    projection = scene.projection.to(torch.float32).contiguous()
    tan_aperture = float(dos._tan_aperture(params, scene.device))
    device = scene.volume.get_device()
    blocks = 0
    if device >= 0:
        # the grid of the instance that will run: an ext instance may hold
        # fewer blocks an SM than the headline's
        occ = occupancy(tensors[0].dtype, tf_mode, params.samples,
                        params.steps, device, channels=channels,
                        filtered=filt != 0)
        blocks = occ["blocks_per_sm"] * occ["sms"]
        if blocks == 0:
            raise RuntimeError("the DOS kernel fits no block on an SM")
    args = _Args(table, row, mvp, projection.data_ptr(), bf16, d, h, w, tw,
                 tf_mode, width, height, params.samples, params.steps,
                 float(np.float32(params.extinction)), tan_aperture, blocks,
                 device, *ext)
    return _build.Prepared(
        tensors=(*tensors, projection), args=args,
        address=ctypes.addressof(args), device=device,
        color_shape=torch.Size((height, width, 4)),
        occlusion_shape=torch.Size((height, width)),
        table_shape=(params.steps, _HEAD + 4 * params.samples), scratch={},
        band_frames={},
        launch=_build.library().vpt_dos_frame if device >= 0 else None)


#: the last (scene, params, resolution)'s preparation
_scene_cache = _build.LastScene(_prepare, _fields)


def _check_tensor(tensor, shape, device, what):
    if tensor.device != device or tensor.dtype != torch.float32 \
            or tuple(tensor.shape) != tuple(shape) \
            or not tensor.is_contiguous():
        raise ValueError(f"the DOS {what} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}")


def sweep_frame(state, scene, params, table=None):
    """``params.steps`` slices of the sweep, in place on the DOS state
    (its colour, occlusion and depth), in one launch.  ``table``: None, or
    a CUDA float32 (steps, 4 + 4·N) tensor that receives the frame's rows
    as the kernel computed them (``dos.slice_table``'s)."""
    color, occlusion = state["color"], state["occlusion"]
    if not color.is_cuda:
        if table is not None:
            raise ValueError("the plain sweep writes no table")
        sweep_frame_plain(state, scene, params)
        return
    if _build.is_halo(scene):
        if table is not None:
            raise ValueError("the DOS halo frame writes no table")
        halo_sweep_frame(state, scene, params)
        return
    global LAUNCHES
    p = _scene_cache.get(scene, (params,) + tuple(color.shape[:2]))
    device = color.device
    if color.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{device}")
    _build.check_image(color, p.color_shape, device, "the DOS color")
    _build.check_image(occlusion, p.occlusion_shape, device,
                       "the DOS occlusion")
    _build.check_aligned(color, "the DOS color")
    offsets = state["offsets"]
    _check_tensor(offsets, (params.samples, 2), device, "offsets")
    scalars = [state[k] for k in ("depth", "max_depth", "slice_distance")]
    for key, value in zip(("depth", "max_depth", "slice_distance"), scalars):
        _check_tensor(value, (), device, key)
    if table is not None:
        _check_tensor(table, p.table_shape, device, "table")
    stream = _build.current_stream(p.device)
    scratch = p.scratch.get(stream)
    if scratch is None:
        scratch = p.scratch[stream] = occlusion.new_empty(occlusion.shape)
    err = p.launch(p.address, color.data_ptr(), occlusion.data_ptr(),
                   scratch.data_ptr(), *(v.data_ptr() for v in scalars),
                   offsets.data_ptr(),
                   None if table is None else table.data_ptr(), stream)
    if err:
        _build.check("vpt_dos_frame", err)
    LAUNCHES += 1


def band_slice(state, ext, ext_row0: int, scene, params, k: int, window,
               n_active=None):
    """Slice ``k`` of the frame on a band of rows, in place on the band's
    colour and occlusion: K9's band instance for CUDA state (one launch),
    :func:`band_slice_plain` for CPU state.  ``window`` = (row0, H) places
    the band's rows in the image; ``ext`` is the previous slice's
    occlusion, (E, W) float32 from the image's row ``ext_row0``, covering
    the band (``dos.render_band`` builds it); the state's depth is the
    frame's first slice's (``dos.render_band`` advances it after the
    frame).  Over a HaloScene on the card the band's halo instance runs,
    which takes the frame's active slices ``n_active``.  The slice of
    :func:`band_frame`'s frame of the band: a frame is prepared once and
    found again while the band's state tensors stay the same."""
    if not state["color"].is_cuda:
        band_slice_plain(state, ext, ext_row0, scene, params, k, window)
        return
    band_frame(state, scene, params, window, n_active).slice(ext, ext_row0,
                                                             k)


class BandFrame:
    """A band's frame on the card, prepared and checked once
    (:func:`band_frame`): a ``VptDosBandFrame`` that holds the scene's
    prepared arguments and the band state's pointers, so that a slice's
    call passes the slice and the previous occlusion only."""

    def __init__(self, p, state, scene, row0, band_h, width, n_active,
                 halo):
        # the scene weakly: the preparation holds this frame
        self.p, self.scene, self.halo = p, weakref.ref(scene), halo
        self.tensors = tuple(state[key] for key in _BAND_KEYS)
        self.width, self.n_active = width, n_active
        self.device = p.device
        value = None
        if halo:
            # a band's own values: bands of one process interleave their
            # slices
            value = p.band_values.get((row0, band_h))
            if value is None:
                value = p.band_values[row0, band_h] = torch.empty(
                    HALO_CHUNK * band_h * width * p.args.channels,
                    dtype=torch.float32, device=p.scratch.device)
        self.value = value
        self.args = _BandFrameArgs(
            p.address, *(t.data_ptr() for t in self.tensors[:2]), None,
            *(t.data_ptr() for t in self.tensors[2:]), 0, row0, band_h, 0,
            0, None if value is None else value.data_ptr(),
            *((scene.slab_index, scene.num_slabs, scene.interleave,
               int(scene.collective)) if halo else (0, 0, 0, 0)),
            int(halo), n_active)
        self.address = ctypes.addressof(self.args)
        lib = _build.library()
        _build.check("vpt_dos_band_check", lib.vpt_dos_band_check(
            self.address))
        self._slice, self._fetch = lib.vpt_dos_band_slice, \
            lib.vpt_dos_band_fetch

    def holds(self, state, n_active) -> bool:
        """Whether this frame is the one of ``state`` and ``n_active``."""
        t = self.tensors
        return (self.n_active == n_active and state["color"] is t[0]
                and state["occlusion"] is t[1] and state["depth"] is t[2]
                and state["max_depth"] is t[3]
                and state["slice_distance"] is t[4]
                and state["offsets"] is t[5])

    def slice(self, ext, ext_row0: int, k: int):
        """Slice ``k``: ``ext`` as :func:`band_slice`'s; over a HaloScene
        at a chunk's first slice the fetch and the all-reduce before it."""
        global BAND_LAUNCHES, HALO_BAND_LAUNCHES
        if ext.dtype is not torch.float32 or ext.dim() != 2 \
                or ext.shape[1] != self.width or not ext.is_contiguous() \
                or ext.get_device() != self.device:
            raise ValueError(f"the DOS extended occlusion must be a "
                             f"contiguous float32 (E, {self.width}) tensor "
                             "on the state's device")
        stream = _build.current_stream(self.device)
        if self.halo and k % HALO_CHUNK == 0:
            _build.check("vpt_dos_band_fetch",
                         self._fetch(self.address, k, stream))
            HALO_BAND_LAUNCHES += 1
            self.scene().reduce_(self.value)
        _build.check("vpt_dos_band_slice", self._slice(
            self.address, ext.data_ptr(), ext_row0, ext.shape[0], k, stream))
        if self.halo:
            HALO_BAND_LAUNCHES += 1
        else:
            BAND_LAUNCHES += 1


#: the band state's tensors a band frame points into, in its order
_BAND_KEYS = ("color", "occlusion", "depth", "max_depth", "slice_distance",
              "offsets")


def band_frame(state, scene, params, window, n_active=None) -> BandFrame:
    """The :class:`BandFrame` of a band's CUDA ``state`` (``window`` =
    (row0, H) places its rows in the image) over ``scene``: the one this
    band last prepared while it holds the same state tensors, the scene's
    same preparation and ``n_active``, else one checked and prepared now.
    A HaloScene's band takes the frame's active slices ``n_active`` (a
    fetch and an all-reduce a chunk of HALO_CHUNK of them, a fold each);
    the band instance runs any of the frame's ``steps`` slices."""
    color = state["color"]
    band_h, width = color.shape[:2]
    row0, height = (0, band_h) if window is None \
        else (int(window[0]), int(window[1]))
    halo = _build.is_halo(scene)
    p = (_halo_cache if halo else _scene_cache).get(
        scene, (params, height, width))
    if not halo:
        n_active = params.steps
    frame = p.band_frames.get((row0, band_h))
    if frame is not None and frame.holds(state, n_active):
        return frame
    from .. import sampling

    row0, height = sampling.row_window(window, band_h)
    if halo and (n_active is None or not 0 <= n_active <= params.steps):
        raise ValueError("a HaloScene's band frame takes the frame's active "
                         "slices (dos.render_band counts them)")
    device = color.device
    if color.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{device}")
    _build.check_image(color, (band_h, width, 4), device, "the DOS color")
    _build.check_image(state["occlusion"], (band_h, width), device,
                       "the DOS occlusion")
    _build.check_aligned(color, "the DOS color")
    _check_tensor(state["offsets"], (params.samples, 2), device, "offsets")
    for key in ("depth", "max_depth", "slice_distance"):
        _check_tensor(state[key], (), device, key)
    frame = p.band_frames[row0, band_h] = BandFrame(
        p, state, scene, row0, band_h, width, n_active, halo)
    return frame


def _halo_fields(scene):
    return (scene.slab_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.projection, scene.tf_mxu, scene.transfer_packed)


def _prepare_halo(scene, key):
    """What every halo frame of ``key`` = (params, height, width) takes of
    a HaloScene: the ``VptDosHalo`` of its slab rows (its plane map) with
    the fold's cooperative grid for a chunk of ``_build.halo_chunk``
    slices, the second occlusion buffer; the chunk's (chunk, n,
    channels) values are allocated at the first frame (a band allocates
    its own)."""
    from ..renderers import dos

    params, height, width = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the DOS kernel indexes pixels "
                         "with 32-bit integers")
    if not 1 <= params.samples <= MAX_SAMPLES or params.steps < 1:
        raise ValueError(f"the DOS kernel takes 1 to {MAX_SAMPLES} disk "
                         "taps and at least one slice a frame")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, _, _, _, mvp, tf_table,
              th, channels) = _build.slab_scene(scene)
    projection = scene.projection.to(torch.float32).contiguous()
    dev = tensors[0].device
    n = height * width
    chunk = _build.halo_chunk(params.steps, n, channels)
    occ = halo_occupancy(1, tensors[0].dtype, tf_mode, params.samples,
                         dev.index, channels, steps=chunk)
    blocks = occ["blocks_per_sm"] * occ["sms"]
    if blocks == 0:
        raise RuntimeError("the DOS halo fold fits no block on an SM")
    planes = _build.scene_plane_map(scene)
    args = _HaloArgs(table, row, mvp, projection.data_ptr(), bf16, d, h, w,
                     tw, tf_mode, width, height, params.samples,
                     params.steps, float(np.float32(params.extinction)),
                     float(dos._tan_aperture(params, scene.device)), blocks,
                     dev.index, tf_table, th, channels, 0,
                     planes.data_ptr())
    return _build.Prepared(
        tensors=(*tensors, projection, planes), args=args,
        address=ctypes.addressof(args), device=dev.index,
        color_shape=torch.Size((height, width, 4)),
        occlusion_shape=torch.Size((height, width)),
        scratch=torch.empty((height, width), dtype=torch.float32,
                            device=dev), chunk=chunk, value=None,
        values=chunk * n * channels, band_values={}, band_frames={},
        launch=_build.library().vpt_dos_halo_launch)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_sweep_frame(state, scene, params):
    """``params.steps`` slices of the sweep over a HaloScene on the card,
    in place on the DOS state: a launch of the halo instance's fetch (this
    rank's masked values of every slice of the frame, 0 past the far
    depth, which the card decides from the state's depth), one all-reduce
    of them (``HaloScene.reduce_``) and a cooperative launch of its fold
    (the slices as K9 runs them, from the summed values, up to the first
    past the far depth), which advances the depth.  So a frame is 2
    launches and one all-reduce and reads nothing back, where vpt_tpu
    ``psum``s a ``sample_color`` of 8 slices and the plain twin a slice at
    a time; a frame after the sweep's end takes the same 2 and 1 and
    changes nothing but the depth's advance by 0.  Values past
    ``_build.HALO_VALUE_BYTES`` go in chunks of ``_build.halo_chunk``
    slices, each a fetch, an all-reduce and a fold.  Equal bit for bit to
    :func:`sweep_frame` on the whole scene."""
    global HALO_LAUNCHES

    color, occlusion = state["color"], state["occlusion"]
    if not color.is_cuda:
        sweep_frame_plain(state, scene, params)
        return
    p = _halo_cache.get(scene, (params,) + tuple(color.shape[:2]))
    device = color.device
    if color.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{device}")
    _build.check_image(color, p.color_shape, device, "the DOS color")
    _build.check_image(occlusion, p.occlusion_shape, device,
                       "the DOS occlusion")
    _build.check_aligned(color, "the DOS color")
    offsets = state["offsets"]
    _check_tensor(offsets, (params.samples, 2), device, "offsets")
    scalars = [state[k] for k in ("depth", "max_depth", "slice_distance")]
    for key, value in zip(("depth", "max_depth", "slice_distance"), scalars):
        _check_tensor(value, (), device, key)
    if p.value is None:
        p.value = torch.empty(p.values, dtype=torch.float32, device=device)
    stream = _build.current_stream(p.device)
    head = (p.address, color.data_ptr(), occlusion.data_ptr(),
            p.scratch.data_ptr(), *(v.data_ptr() for v in scalars),
            offsets.data_ptr(), scene.slab_index, scene.num_slabs,
            scene.interleave, int(scene.collective), p.value.data_ptr())
    for k0, count, last in _build.halo_chunks(params.steps, p.chunk):
        _build.check("vpt_dos_halo_launch",
                     p.launch(*head, k0, count, 0, 0, stream))
        scene.reduce_(p.value)
        _build.check("vpt_dos_halo_launch",
                     p.launch(*head, k0, count, 1, int(last), stream))
        HALO_LAUNCHES += 2


def halo_occupancy(stage: int, table_dtype, tf_mode: int = 0,
                   samples: int = 8, device: int = 0,
                   channels: int = 1, steps: int = HALO_CHUNK) -> dict:
    """The launch shape of the halo instance's fetch (``stage`` 0, of a
    frame or a band, through the plane map: the map's D·8 bytes of shared
    memory a block come on top) or its cooperative fold of ``steps``
    slices (1), as :func:`occupancy`'s.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 4 * (channels == 2)
    _build.check("vpt_dos_halo_info", _build.library().vpt_dos_halo_info(
        stage, flags, tf_mode, samples, steps, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


#: the fields of :func:`occupancy`, in the order ``vpt_dos_sweep_info``
#: writes them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes", "rows_at_once")


def occupancy(table_dtype, tf_mode: int = 0, samples: int = 8,
              steps: int = 50, device: int = 0, channels: int = 1,
              filtered: bool = False) -> dict:
    """The kernel's launch shape on CUDA ``device`` for a corner table of
    ``table_dtype``, the TF lookup mode ``tf_mode`` (``tf1d.mode_code``),
    ``samples`` disk taps, ``steps`` slices a frame and the fetch
    (``channels`` 2, or ``filtered``: an ext instance): threads a block,
    resident blocks an SM (the cooperative grid is that times the SMs),
    SMs, registers and local (spill) bytes a thread, static and dynamic
    shared memory a block, and the slices whose rows a block holds at
    once.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) \
        | 2 * (filtered and channels == 1) | 4 * (channels == 2)
    _build.check("vpt_dos_sweep_info", _build.library().vpt_dos_sweep_info(
        flags, tf_mode, steps, samples, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
