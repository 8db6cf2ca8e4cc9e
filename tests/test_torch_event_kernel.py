"""What the CPU can check of the MCM event kernel (``csrc/mcm_event.cu``)
and of the port's default device.

- The kernel computes each pixel's NDC and RNG stream seed from the pixel
  index.  A numpy float32 mirror of that arithmetic (one IEEE operation at
  a time, as the kernel runs it with ``-fmad=false``) must equal
  ``sampling.pixel_ndc``, ``rng.seed_pixels`` and eager JAX's
  ``pixel_ndc`` bit for bit: a one-ulp difference in an NDC moves the
  pixel to another stream.
- ctypes passes exactly the argument kinds that ``_build.SIGNATURES``
  lists; the C prototypes in ``csrc/`` must declare the same kinds, or a
  mismatch would show only on the card.
- The port's entry points run on the card unless the caller names another
  device, and raise without a card.
"""

import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu_torch import environment, interop, rng, sampling, transfer
from vpt_tpu_torch import utils, volume
from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.renderers import make_scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CSRC = pathlib.Path(__file__).resolve().parent.parent / "vpt_tpu_torch" \
    / "csrc"
F32 = np.float32


def _pcg(x):
    """The kernel's pcg on uint32 (wrapping) arithmetic."""
    with np.errstate(over="ignore"):
        x = x * np.uint32(747796405) + np.uint32(2891336453)
        x = ((x >> ((x >> np.uint32(28)) + np.uint32(4))) ^ x) \
            * np.uint32(277803737)
        return (x >> np.uint32(22)) ^ x


def kernel_ndc_and_seed(height, width, seed):
    """The kernel's NDC and stream seeding, over every pixel index
    in row-major order: y = p / W, x = p − y·W, ndc = (i + 0.5) / n · 2 − 1,
    then pcg(19·bits(ndcx·0.5 + 0.5) + 47·bits(ndcy·0.5 + 0.5)
    + 101·bits(seed) + 131)."""
    pixel = np.arange(height * width, dtype=np.int64)
    y = pixel // width
    x = pixel - y * width

    def ndc(i, n):
        return (i.astype(F32) + F32(0.5)) / F32(n) * F32(2.0) - F32(1.0)

    ndcx, ndcy = ndc(x, width), ndc(y, height)
    mx = (ndcx * F32(0.5) + F32(0.5)).view(np.uint32)
    my = (ndcy * F32(0.5) + F32(0.5)).view(np.uint32)
    ms = np.asarray(F32(seed)).view(np.uint32)
    with np.errstate(over="ignore"):
        acc = np.uint32(19) * mx + np.uint32(47) * my \
            + np.uint32(101) * ms + np.uint32(131)
    shape = (height, width)
    return (np.stack([ndcx, ndcy], -1).reshape(shape + (2,)),
            _pcg(acc).reshape(shape))


@pytest.mark.parametrize("height,width", [(48, 48), (512, 512), (37, 53),
                                          (1, 1)])
def test_kernel_ndc_and_seed_mirror_the_plain_versions(height, width):
    ndc, state = kernel_ndc_and_seed(height, width, 0.3)
    port_ndc = sampling.pixel_ndc(height, width).numpy()
    assert ndc.dtype == np.float32
    assert np.array_equal(ndc.view(np.uint32), port_ndc.view(np.uint32))
    eager = np.asarray(jsampling.pixel_ndc(height, width))
    assert np.array_equal(ndc.view(np.uint32), eager.view(np.uint32))
    port_state = rng.seed_pixels(torch.from_numpy(port_ndc) * 0.5 + 0.5,
                                 np.float32(0.3))
    assert np.array_equal(state.astype(np.int64), port_state.numpy())


_KINDS = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int,
          "float": _build.ctypes.c_float,
          "long long": _build.ctypes.c_longlong}


def c_argument_kinds(name):
    """The ctypes kind of each parameter of ``extern "C" int name(...)`` as
    declared in ``csrc/*.cu``."""
    sources = " ".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", sources)
    assert len(found) == 1, f"{name}: {len(found)} prototypes"
    kinds = []
    for param in found[0].split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            kinds.append(_KINDS["void*"])
            continue
        ctype = re.sub(r"^const ", "", decl).rsplit(" ", 1)[0]
        kinds.append(_KINDS[ctype])
    return kinds


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_prototypes_match_the_ctypes_signatures(name):
    assert c_argument_kinds(name) == _build.SIGNATURES[name]


def test_event_kernel_signature_drops_the_ndc_argument():
    """The kernel takes the image's width and height and computes NDC
    itself: pointers, then 4 ints, a pointer, 2 ints, 2 pointers, 2 ints
    (width, height), 7 floats, 3 ints and the stream."""
    kinds = c_argument_kinds("vpt_mcm_event")
    p, i, f = (_KINDS[k] for k in ("void*", "int", "float"))
    assert kinds == [p] * 8 + [i] * 4 + [p, i, i, p, p, i, i] + [f] * 7 \
        + [i] * 3 + [p]


ENTRY_POINTS = {
    "make_scene": lambda **kw: make_scene(
        volume.sphere_volume(4, device="cpu"),
        transfer.gray_ramp(device="cpu"), **kw),
    "sphere_volume": lambda **kw: volume.sphere_volume(4, **kw),
    "blobs_volume": lambda **kw: volume.blobs_volume(4, **kw),
    "gray_ramp": lambda **kw: transfer.gray_ramp(**kw),
    "white": lambda **kw: environment.white(**kw),
    "constant": lambda **kw: environment.constant([0.2, 0.4, 0.6], **kw),
    "tensor_from_numpy": lambda **kw: interop.tensor_from_numpy(
        np.zeros(3, np.float32), **kw),
    "scene_from_numpy": lambda **kw: interop.scene_from_numpy({}, **kw),
    "state_from_numpy": lambda **kw: interop.state_from_numpy(
        {"samples": np.zeros(3)}, **kw),
}
FUNCTIONS = {
    "make_scene": make_scene, "sphere_volume": volume.sphere_volume,
    "blobs_volume": volume.blobs_volume, "gray_ramp": transfer.gray_ramp,
    "white": environment.white, "constant": environment.constant,
    "tensor_from_numpy": interop.tensor_from_numpy,
    "scene_from_numpy": interop.scene_from_numpy,
    "state_from_numpy": interop.state_from_numpy,
}


def test_resolve_device_defaults_to_the_card(monkeypatch):
    assert utils.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert utils.resolve_device(None) == torch.device("cuda")
    assert utils.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utils.resolve_device(None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """``device`` defaults to None, which is the card: without one the
    call raises (no fallback to the CPU); told that there is one, it goes
    to CUDA (which this CPU build of PyTorch refuses); ``device="cpu"``
    runs here."""
    assert inspect.signature(FUNCTIONS[name]).parameters["device"].default \
        is None
    call = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if name != "scene_from_numpy":
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
        monkeypatch.undo()
        call(device="cpu")


def test_event_kernel_preparation_lets_the_scene_go():
    """The wrapper keeps the last scene's launch arguments, but holds the
    scene weakly: dropping the scene drops them and the tensors they
    point into."""
    import gc

    from vpt_tpu_torch.kernels import mcm_event

    scene = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), device="cpu")
    cache = mcm_event._scene_cache
    prepared = cache.get(scene, (False, 4, 6))
    assert cache.get(scene, (False, 4, 6)) is prepared
    assert prepared.args[-2:] == (6, 4)
    assert cache.get(scene, (False, 4, 5)) is not prepared
    del prepared, scene
    gc.collect()
    assert cache._last is None


def c_struct_fields(name):
    """The ``(name, ctypes kind, count)`` of each member of ``struct name``
    as declared in ``csrc/*.cu``, a base struct's members first (pointers
    as void*, ``x[n]`` arrays with their count)."""
    sources = " ".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r"struct " + name + r"(?: : (\w+))? \{(.*?)\n\};",
                       sources, re.S)
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    base, body = found[0]
    fields = c_struct_fields(base) if base else []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?) (.*)", decl).groups()
        kind = _KINDS["void*" if ctype.endswith("*") else ctype]
        for member in names.split(", "):
            array = re.match(r"(\w+)\[(\d+)\]", member)
            fields.append((array.group(1), kind, int(array.group(2)))
                          if array else (member, kind, 1))
    return fields


@pytest.mark.parametrize("module,struct", [
    ("march", "VptMarchExt"), ("mcs_frame", "VptMcsExt"),
    ("iso_shade", "VptIsoShadeExt"), ("dos_sweep", "VptDosExt"),
    ("lao_march", "VptLaoExt")])
def test_prepared_structs_match_the_c_layouts(module, struct):
    """Each prepared ctypes Structure declares the C struct's members in
    its order, with its kinds and array counts; a mismatch would show
    only on the card."""
    import importlib

    args = importlib.import_module(f"vpt_tpu_torch.kernels.{module}")._Args
    mirror = []
    for name, ctype in args._fields_:
        count = getattr(ctype, "_length_", 1)
        mirror.append((name, getattr(ctype, "_type_", ctype)
                       if count > 1 else ctype, count))
    assert mirror == c_struct_fields(struct)
