"""Two-channel volumes (2D transfer functions) in the port against
vpt_tpu's.

- ``volume.gradient_magnitude`` and ``with_gradient_magnitude``: equal bit
  for bit (the square root is the correctly rounded one, as XLA's).
- The ``Scene`` samplers of a two-channel scene (float32 and bf16 corner
  tables of (D·H·W, 16) rows, and unpacked), and a four-channel one that
  crosses through ``interop`` as its channels 0:2: ``sample_value``,
  ``sample_volume_rg``, the 2D ``sample_color`` and ``value_gradient``,
  equal bit for bit.
- ``make_scene``'s rules for C > 1 (no grid, tracking table, clamp box or
  ``tf_mxu``) and their warnings, against vpt_tpu's.
- MCM, MCS, EAM, MIP, Depth and ISO (with its display) on a 16³ blobs
  volume with its gradient magnitude and a 2D TF rasterized from three
  bumps, float32 and bf16 tables, at 32², to the bounds of the
  single-channel tests of the same renderer (``test_torch_mcm.py``,
  ``test_torch_march.py``, ``test_torch_mcs.py``).
- ``cli render`` of a two-channel BVP written by ``write_bvp`` with a
  ``--tf`` widget JSON, against ``vpt_tpu.cli``'s PNG.
- DOS and LAO through the public path (``make_renderer``) on two-channel
  and filtered scenes, against vpt_tpu's Renderer.
"""

import dataclasses
import json
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import cli as jcli
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
import vpt_tpu.renderers as jrenderers
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import cli as tcli
from vpt_tpu_torch import interop, transfer, volume
from vpt_tpu_torch.io import write_bvp
from vpt_tpu_torch.kernels import iso_shade, march, mcm_event, mcs_frame
from vpt_tpu_torch.renderers import make_renderer, make_scene
import vpt_tpu_torch.renderers as trenderers


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RES = 32#: a 2D TF of three bumps over (value, gradient magnitude)
BUMPS = [
    {"position": {"x": 0.3, "y": 0.15}, "size": {"x": 0.25, "y": 0.3},
     "color": {"r": 0.9, "g": 0.6, "b": 0.2, "a": 0.8}},
    {"position": {"x": 0.6, "y": 0.5}, "size": {"x": 0.3, "y": 0.4},
     "color": {"r": 0.2, "g": 0.7, "b": 0.9, "a": 1.0}},
    {"position": {"x": 0.85, "y": 0.1}, "size": {"x": 0.2, "y": 0.2},
     "color": {"r": 1.0, "g": 1.0, "b": 1.0, "a": 0.6}},
]


@pytest.mark.parametrize("n,seed", [(16, 7), (24, 3)])
def test_gradient_magnitude_equals_jax(n, seed):
    jvol = jvolume.blobs_volume(n, seed=seed)
    want = np.asarray(jvolume.with_gradient_magnitude(jvol).data)
    tvol = volume.with_gradient_magnitude(
        volume.Volume(torch.from_numpy(np.array(jvol.data)), "cubic"))
    assert tvol.filter == "cubic" and tvol.channels == 2
    assert np.array_equal(tvol.data.numpy(), want)
    assert np.array_equal(
        volume.gradient_magnitude(torch.from_numpy(want[..., 0])).numpy(),
        np.asarray(jvolume.gradient_magnitude(jnp.asarray(want[..., 0]))))


def _jtf():
    return jtransfer.rasterize(jtransfer.TransferFunctionBumps.from_list(
        BUMPS))


def _jvolume(channels=2):
    jvol = jvolume.with_gradient_magnitude(jvolume.blobs_volume(16, seed=7))
    if channels == 4:
        data = jvol.data
        return jvolume.Volume(jnp.concatenate([data, data[..., ::-1]], -1))
    return jvol


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for kind, kw in (("f32", {}), ("bf16", {"pack_dtype": jnp.bfloat16}),
                     ("unpacked", {"pack": False}), ("c4", {})):
        jscene = jmake_scene(_jvolume(4 if kind == "c4" else 2), _jtf(),
                             **kw)
        out[kind] = (jscene, _port(jscene))
    return out


@pytest.mark.parametrize("kind", ["f32", "bf16", "unpacked", "c4"])
def test_scene_samplers_equal_jax(scenes, kind):
    """The samplers of a two-channel scene at random and out-of-range
    positions, and the tables the port's own make_scene builds."""
    jscene, tscene = scenes[kind]
    p = np.random.default_rng(2).uniform(-0.1, 1.1, (4096, 3)).astype(
        np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    assert tscene.channels == 2
    for name in ("sample_value", "sample_volume_rg", "sample_color"):
        want = np.asarray(getattr(jscene, name)(jp))
        assert np.array_equal(getattr(tscene, name)(tp).numpy(), want), name
    assert np.array_equal(tscene.value_gradient(tp, 0.005).numpy(),
                          np.asarray(jscene.value_gradient(jp, 0.005)))
    dtype = torch.bfloat16 if kind == "bf16" else None
    own = make_scene(
        volume.Volume(torch.from_numpy(np.array(jscene.volume))),
        torch.from_numpy(np.array(jscene.transfer)), pack_dtype=dtype,
        pack=False if kind == "unpacked" else None, device="cpu")
    for name in ("volume_packed", "transfer_packed"):
        a, b = getattr(own, name), getattr(tscene, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a.float(), b.float())
    if kind == "c4":
        assert tuple(own.volume_packed.shape) == (16 ** 3, 16)


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("kwargs", [
    {"tracking": "cheb"}, {"tracking": "auto"}, {"tracking": "grid"},
    {"march_clamp": True}, {"iso_clamp_min": 0.1}, {"tf_mxu": True}],
    ids=["cheb", "auto", "grid", "march_clamp", "iso_clamp_min", "mxu"])
def test_make_scene_rules_and_warnings_equal_jax(kwargs):
    """C = 2: no tracking table, grid, box or ``tf_mxu``; cheb, grid and
    both clamps warn as vpt_tpu does, ``auto`` and ``tf_mxu`` are
    silent."""
    jscene, jwarn = _warned(lambda: jmake_scene(_jvolume(), _jtf(),
                                                **kwargs))
    tscene, twarn = _warned(lambda: make_scene(
        volume.Volume(torch.from_numpy(np.array(_jvolume().data))),
        torch.from_numpy(np.array(_jtf())), device="cpu", **kwargs))
    assert twarn == jwarn
    assert (twarn != []) == (kwargs.get("tracking") in ("cheb", "grid")
                             or "march_clamp" in kwargs
                             or "iso_clamp_min" in kwargs)
    for name in ("tracking_packed", "majorant", "occupied_aabb", "iso_aabb",
                 "transfer_mxu"):
        assert getattr(jscene, name) is None, name
    assert tscene.tracking_packed is None and tscene.majorant is None
    assert tscene.occupied_aabb is None and tscene.iso_aabb is None
    assert tscene.tf_mxu is None


def _params(module, jparams):
    return module.Params(**{f.name: getattr(jparams, f.name)
                            for f in dataclasses.fields(jparams)})


def assert_close(got, want, kind):
    """``test_torch_march.py``'s bounds: float32 tables within 1e-6; bf16
    tables at least 99% of the values within 1e-6 and all within 4e-3."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    if kind == "f32":
        assert diff.max() <= 1e-6, diff.max()
    else:
        assert (diff <= 1e-6).mean() >= 0.99, (diff <= 1e-6).mean()
        assert diff.max() <= 4e-3, diff.max()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso"])
def test_march_renderers_agree_with_jax(scenes, key, kind):
    """One eager ``render_frame`` from ``reset`` (the ``generate`` that
    samples the new fetch, then the integrate); ISO
    also displays JAX's hit buffer (Depth equal with float32 tables)."""
    jscene, tscene = scenes[kind]
    jm, tm = getattr(jrenderers, key), getattr(trenderers, key)
    jparams = jm.Params()
    tparams = _params(tm, jparams)
    jstate = jm.reset(jparams, RES, RES, jscene)
    tstate = tm.reset(tparams, RES, RES, tscene)
    jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(0.37),
                             jnp.int32(1))
    tm.render_frame(tstate, tscene, tparams, 0.37, 1)
    assert_close(tstate, jstate, kind)
    if key == "depth" and kind == "f32":
        assert np.array_equal(tstate.numpy(), np.asarray(jstate))
    if key == "iso":
        assert (np.asarray(jstate)[..., 3] > 0).any()
        want = np.asarray(jm.display(jstate, jscene, jparams))
        got = tm.display(interop.state_from_numpy(np.asarray(jstate),
                                                  device="cpu"),
                         tscene, tparams)
        assert np.abs(got.numpy() - want).max() <= 1e-5
        assert_close(got, want, kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mcs_agrees_with_jax(scenes, kind):
    """Two frames at extinction 8: 99% of the pixels within 1e-6, and
    with float32 tables the means within 1e-4 (``test_torch_mcs.py``)."""
    jscene, tscene = scenes[kind]
    jm, tm = jrenderers.mcs, trenderers.mcs
    jparams, tparams = jm.Params(extinction=8.0), tm.Params(extinction=8.0)
    jstate = jm.reset(jparams, RES, RES, jscene)
    tstate = tm.reset(tparams, RES, RES, tscene)
    for n, seed in ((1, 0.37), (2, 0.81)):
        jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(seed),
                                 jnp.int32(n))
        tm.render_frame(tstate, tscene, tparams, seed, n)
    got, want = tstate.numpy(), np.asarray(jstate)
    close = (np.abs(got - want) <= 1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    if kind == "f32":
        assert abs(float(got.mean()) - float(want.mean())) <= 1e-4


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mcm_frame_agrees_with_jax(scenes, kind):
    """One jitted JAX frame (steps 8, extinction 20) against the port's
    plain frame: ``samples`` agree on at least 97% of the pixels, radiance
    and positions within 1e-5 where they do (``test_torch_mcm.py``)."""
    jscene, tscene = scenes[kind]
    jm, tm = jrenderers.mcm, trenderers.mcm
    jparams = jm.Params(extinction=20.0, anisotropy=0.3, steps=8)
    tparams = tm.Params(extinction=20.0, anisotropy=0.3, steps=8)
    state = jm.reset(jparams, RES, RES, jscene)
    tstate = interop.state_from_numpy({k: np.asarray(v)
                                       for k, v in state.items()},
                                      device="cpu")
    jout = jax.jit(jm.render_frame, static_argnums=(2,))(
        state, jscene, jparams, jnp.float32(0.37), jnp.int32(1))
    tm.render_frame(tstate, tscene, tparams, 0.37, 1)
    tout = interop.state_to_numpy(tstate)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    match = tout["samples"] == jout["samples"]
    assert match.mean() >= 0.97, match.mean()
    assert jout["samples"].mean() > 0.5
    for key in ("radiance", "position"):
        assert np.allclose(tout[key][match], jout[key][match], rtol=0,
                           atol=1e-5), key


def test_plain_kernel_versions_take_two_channel_scenes(scenes):
    """The kernels' plain versions (the oracle on the card) on a
    two-channel scene are the renderers' CPU frames: equal, launching
    nothing."""
    _, tscene = scenes["bf16"]
    before = (march.LAUNCHES, iso_shade.LAUNCHES, mcs_frame.LAUNCHES,
              mcm_event.LAUNCHES)
    for key in ("mip", "iso"):
        module = getattr(trenderers, key)
        a = module.reset(module.Params(), 8, 8, tscene)
        b = a.clone()
        module.render_frame(a, tscene, module.Params(), 0.4, 1)
        march.march_frame_plain(key, b, tscene, module.Params(), 0.4, 1)
        assert torch.equal(a, b)
    assert torch.equal(
        iso_shade.iso_shade_plain(b, tscene, trenderers.iso.Params()),
        trenderers.iso.display(b, tscene, trenderers.iso.Params()))
    a = trenderers.mcs.reset(trenderers.mcs.Params(), 8, 8, tscene)
    b = a.clone()
    trenderers.mcs.render_frame(a, tscene, trenderers.mcs.Params(), 0.4, 1)
    mcs_frame.mcs_frame_plain(b, tscene, trenderers.mcs.Params(), 0.4, 1)
    assert torch.equal(a, b)
    params = trenderers.mcm.Params(steps=4)
    a = trenderers.mcm.reset(params, 8, 8, tscene)
    b = {k: v.clone() for k, v in a.items()}
    trenderers.mcm.render_frame(a, tscene, params, 0.4)
    mcm_event.event_frame_plain(b, tscene, params, 0.4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (march.LAUNCHES, iso_shade.LAUNCHES, mcs_frame.LAUNCHES,
            mcm_event.LAUNCHES) == before


@pytest.mark.parametrize("renderer", ["eam", "mip"])
def test_cli_renders_a_two_channel_bvp_with_a_tf(tmp_path, renderer):
    """``cli render`` of an RG BVP (``write_bvp`` of
    ``with_gradient_magnitude``) with a ``--tf`` widget JSON: the port's
    PNG within 1/255 of vpt_tpu's in every pixel."""
    from PIL import Image

    write_bvp(tmp_path / "rg.bvp", volume.with_gradient_magnitude(
        volume.blobs_volume(16, seed=7, device="cpu")))
    (tmp_path / "tf.json").write_text(json.dumps(BUMPS))
    argv = ["render", "--platform", "cpu", "--volume",
            str(tmp_path / "rg.bvp"), "--tf", str(tmp_path / "tf.json"),
            "--renderer", renderer, "--resolution", "24", "--spp", "2",
            "--precision", "exact"]
    jcli.main(argv + ["-o", str(tmp_path / "jax.png")])
    tcli.main(argv + ["-o", str(tmp_path / "port.png")])
    got, want = (np.asarray(Image.open(tmp_path / f"{n}.png")).astype(int)
                 for n in ("port", "jax"))
    assert got.shape == want.shape == (24, 24, 3)
    assert np.abs(got - want).max() <= 1
    assert len(np.unique(want)) > 2


@pytest.mark.parametrize("kind", ["rg", "nearest", "cubic"])
@pytest.mark.parametrize("key", ["dos", "lao"])
def test_dos_and_lao_raise_for_these_scenes(key, kind):
    """DOS and LAO render two-channel and filtered scenes (they raised
    before item 13d was ported): the port's public path (its own volume
    and ``make_scene``, ``make_renderer``, one frame, ``display``) against
    vpt_tpu's jitted Renderer on the same volume at 8², to the bounds of
    the golden tests through the same path (``tests/test_torch_dos.py``:
    every pixel within 2e-5; ``tests/test_torch_lao.py``: 93% of the
    pixels within 2e-5, all within 2e-3, the jitted NDCs' other random
    values)."""
    vol = volume.blobs_volume(8, seed=1, device="cpu")
    jvol = jvolume.blobs_volume(8, seed=1)
    if kind == "rg":
        vol = volume.with_gradient_magnitude(vol)
        jvol = jvolume.with_gradient_magnitude(jvol)
    else:
        vol = volume.Volume(vol.data, kind)
        jvol = jvolume.Volume(jvol.data, kind)
    scene = make_scene(vol, transfer.gray_ramp(device="cpu"), device="cpu")
    assert (scene.channels, scene.filter) == (
        (2, "linear") if kind == "rg" else (1, kind))
    got = make_renderer(key, height=8, width=8).render_progressive(
        scene, frames=1).numpy()
    want = np.asarray(jrenderers.make_renderer(
        key, height=8, width=8).render_progressive(
            jmake_scene(jvol, jtransfer.gray_ramp()), frames=1))
    assert got.shape == want.shape == (8, 8, 4)
    diff = np.abs(got - want).max(-1)
    if key == "dos":
        assert diff.max() <= 2e-5, diff.max()
    else:
        assert (diff <= 2e-5).mean() >= 0.93, (diff <= 2e-5).mean()
        assert diff.max() <= 2e-3, diff.max()
