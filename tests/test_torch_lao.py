"""The port's LAO renderer against vpt_tpu's.

- ``rng.rand_vec2`` against JAX's: ``cos``/``sin`` differ in the last bit
  between the frameworks (ROADMAP queue 3), and the hash multiplies them by
  1235.7 and 4378.5 before ``mod 1``: measured 96.2% of the values equal,
  all within 4.9e-4.  Asserted: 90% and 1e-3.
- ``sampling.central_raw_gradient`` and ``Scene.sample_transfer`` (the 2D
  TF lookup of the packed table, float32 weights even on a ``tf_mxu``
  scene) against JAX's: measured equal, asserted within 1e-6 / 1e-7.
- ``generate`` against vpt_tpu's, called eagerly, on blobs 24³ at 32²
  (float32 tables, and bf16 with ``tf_mxu``, sRGB and cheb-skip): with the
  port's ``rand_vec2`` returning JAX's values, measured within 2.3e-8;
  with its own, within 1.9e-6 (99.7% of the pixels within 1e-6).
- The slice end to end against ``tests/goldens/lao.npz`` (48², 2 frames,
  seed0 11): jitted JAX rounds 31% of the 48² NDCs differently (ROADMAP
  queue 3), which ``rand_vec2`` turns into another ``rx``: measured 96.5%
  of the pixels within 2e-5, all within 9.8e-4.
- The reference's sequential GLSL emulation of LAO
  (``tests/test_glsl_emulation.py``) with the port's ``generate`` in
  vpt_tpu's place, at that file's 1e-4; the port of
  ``test_lao_num_samples_changes_output``; ``baked_gradient`` raises
  vpt_tpu's ValueError on a one-channel volume.

JAX's frame is computed once per scene (module-scope fixtures).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_glsl_emulation as glsl
from vpt_tpu import rng as jrng
from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import lao as jlao
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, rng, sampling, transfer, volume
from vpt_tpu_torch.kernels import lao_march
from vpt_tpu_torch.renderers import factory, lao, make_renderer, make_scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDENS = pathlib.Path(__file__).parent / "goldens"
RES = 32


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


def _params(jparams):
    """The port's Params with the fields of a vpt_tpu Params."""
    return lao.Params(**{f.name: getattr(jparams, f.name)
                         for f in dataclasses.fields(jparams)})


def jax_rand_vec2(p):
    """JAX's ``rand_vec2`` behind the port's signature."""
    return torch.from_numpy(np.array(jrng.rand_vec2(jnp.asarray(
        p.numpy()))))


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for kind in ("f32", "bf16"):
        extra = {} if kind == "f32" else dict(
            pack_dtype=jnp.bfloat16, tf_mxu=True, tf_srgb=True,
            tracking="auto")
        jscene = jmake_scene(jvolume.blobs_volume(24, seed=7),
                             jtransfer.gray_ramp(alpha_scale=0.9), pack=True,
                             **extra)
        out[kind] = (jscene, _port(jscene))
    assert out["bf16"][1].tf_mxu == torch.bfloat16
    return out


@pytest.fixture(scope="module")
def jax_frames(scenes):
    return {kind: np.asarray(jlao.generate(jscene, jlao.Params(),
                                           jnp.float32(0.0), RES, RES))
            for kind, (jscene, _) in scenes.items()}


def test_rand_vec2_matches_jax():
    p = np.random.default_rng(0).uniform(-1, 1, (64, 64, 2)).astype(
        np.float32)
    p[0, :3] = [[3.14, 2.71], [0.0, 0.0], [-1.0, 1.0]]
    want = np.asarray(jrng.rand_vec2(jnp.asarray(p)))
    got = rng.rand_vec2(torch.from_numpy(p)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert ((got >= 0.0) & (got < 1.0)).all()
    diff = np.abs(got - want)
    assert (diff == 0.0).mean() >= 0.90, (diff == 0.0).mean()
    assert diff.max() <= 1e-3, diff.max()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_raw_gradient_and_sample_transfer_match_jax(scenes, kind):
    """The six-tap raw gradient within 1e-6 of JAX's, and the 2D TF lookup
    within 1e-7 (measured: both equal).  On the ``tf_mxu`` scene the
    lookup reads the packed (bf16) table with float32 weights: no weight
    is rounded to bf16, which at y = 0 would give the 1D lookup's values."""
    jscene, tscene = scenes[kind]
    g = np.random.default_rng(2)
    pos = g.uniform(-0.05, 1.05, (40, 40, 3)).astype(np.float32)
    want = np.asarray(jsampling.central_raw_gradient(
        jscene.sample_value, jnp.asarray(pos), 1.0 / 32.0))
    got = sampling.central_raw_gradient(tscene.sample_value,
                                        torch.from_numpy(pos), 1.0 / 32.0)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    assert torch.equal(got, tscene.raw_gradient(torch.from_numpy(pos),
                                                1.0 / 32.0))
    uv = g.uniform(-0.1, 1.1, (40, 40, 2)).astype(np.float32)
    want = np.asarray(jscene.sample_transfer(jnp.asarray(uv)))
    got = tscene.sample_transfer(torch.from_numpy(uv))
    assert np.abs(got.numpy() - want).max() <= 1e-7
    if kind == "bf16":
        values = torch.from_numpy(g.uniform(0, 1, (4096,)).astype(
            np.float32))
        two_d = tscene.sample_transfer(torch.stack(
            [values, torch.zeros_like(values)], dim=-1))
        one_d = tscene._lookup(values)
        assert not torch.equal(two_d, one_d)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_generate_matches_jax_with_jax_random_values(scenes, jax_frames,
                                                      monkeypatch, kind):
    """The port's ``rand_vec2`` returning JAX's values: every value within
    1e-7 (measured: at most 2.3e-8)."""
    _, tscene = scenes[kind]
    monkeypatch.setattr(rng, "rand_vec2", jax_rand_vec2)
    got = lao.generate(tscene, lao.Params(), 0.0, RES, RES).numpy()
    assert got.shape == (RES, RES, 4)
    assert np.abs(got - jax_frames[kind]).max() <= 1e-7


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_generate_matches_jax(scenes, jax_frames, kind):
    """The port's own ``rand_vec2``: every value within 1e-5 and 99% of
    the pixels within 1e-6 (measured: at most 1.9e-6, 99.7% and 100%)."""
    _, tscene = scenes[kind]
    got = lao.generate(tscene, lao.Params(), 0.0, RES, RES).numpy()
    diff = np.abs(got - jax_frames[kind])
    assert diff.max() <= 1e-5, diff.max()
    assert (diff.max(-1) <= 1e-6).mean() >= 0.99


def test_render_frame_replaces_the_state_in_place(scenes):
    """LAO is not progressive: a frame replaces the state, in place; the
    display is a copy; the CPU path launches no kernel."""
    _, tscene = scenes["f32"]
    params = lao.Params()
    state = lao.reset(params, 12, 10, tscene)
    assert torch.equal(state[..., 3], torch.ones(12, 10))
    before = lao_march.LAUNCHES
    out = lao.render_frame(state, tscene, params, 0.3, 1)
    assert out is state
    assert torch.equal(state, lao.generate(tscene, params, 0.9, 12, 10))
    shown = lao.display(state, tscene, params)
    assert torch.equal(shown, state) and shown.data_ptr() != state.data_ptr()
    assert lao_march.LAUNCHES == before
    assert factory.get_module("lao") is lao


@pytest.mark.parametrize("built", ["jax", "port"])
def test_golden_through_render_progressive(built):
    """tests/goldens/lao.npz: 48², blobs 24³ seed 7, gray_ramp(0.9),
    float32 tables, 2 frames, seed0 11, through the port's public path, on
    vpt_tpu's scene carried across and on the port's own.  Measured on
    both: 96.5% of the pixels within 2e-5, all within 9.8e-4 (the jitted
    NDCs' other ``rx``).  Asserted: 93% and 2e-3."""
    if built == "jax":
        scene = _port(jmake_scene(jvolume.blobs_volume(24, seed=7),
                                  jtransfer.gray_ramp(alpha_scale=0.9),
                                  pack=True))
    else:
        scene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                           transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                           pack=True, device="cpu")
    img = make_renderer("lao", height=48, width=48).render_progressive(
        scene, frames=2, seed0=11).numpy()
    want = np.load(GOLDENS / "lao.npz")["image"]
    assert img.shape == want.shape
    diff = np.abs(img - want).max(-1)
    assert (diff <= 2e-5).mean() >= 0.93, (diff <= 2e-5).mean()
    assert diff.max() <= 2e-3, diff.max()


def test_matches_sequential_glsl_emulation(monkeypatch):
    """``test_lao_matches_sequential_emulation`` (every pixel at 9², atol
    1e-4) with the port's generate in vpt_tpu's place."""
    def generate(scene, params, seed, height, width):
        return lao.generate(_port(scene), _params(params), float(seed),
                            height, width).numpy()

    monkeypatch.setattr(jlao, "generate", generate)
    glsl.test_lao_matches_sequential_emulation(
        jmake_scene(jvolume.sphere_volume(16),
                    jtransfer.gray_ramp(alpha_scale=0.9)))


def test_lao_num_samples_changes_output():
    """tests/test_renderers.py:319 on the port: the carried (non-reset) AO
    accumulator makes N > 1 differ from N = 1."""
    scene = make_scene(volume.sphere_volume(32, device="cpu"),
                       transfer.gray_ramp(alpha_scale=1.0, device="cpu"),
                       device="cpu")
    a = lao.generate(scene, lao.Params(num_lao_samples=1), 0.1, 24, 24)
    b = lao.generate(scene, lao.Params(num_lao_samples=4), 0.1, 24, 24)
    assert not torch.allclose(a, b)


def test_baked_gradient_raises(scenes):
    """``baked_gradient`` on a one-channel volume raises vpt_tpu's
    ValueError, from the plain frame and from the kernel's preparation."""
    jscene, tscene = scenes["f32"]
    params = lao.Params(baked_gradient=True)
    with pytest.raises(ValueError, match="2-channel"):
        jlao.generate(jscene, jlao.Params(baked_gradient=True),
                      jnp.float32(0.0), 4, 4)
    with pytest.raises(ValueError, match="2-channel"):
        lao.generate(tscene, params, 0.0, 4, 4)
    with pytest.raises(ValueError, match="2-channel"):
        lao_march._prepare(tscene, (params, 4, 4))


def test_lao_taps_are_numpys():
    """The AO taps' t2, light_radius·t2 and (1 − t2)² are float32 as
    vpt_tpu's numpy computes them: 20 taps at the default step."""
    params = lao.Params()
    rows = lao.lao_taps(params)
    t2s = np.arange(0.001, 1.0, 0.05, dtype=np.float32)
    assert rows.shape == (20, 3) and rows.dtype == np.float32
    assert np.array_equal(rows[:, 0], t2s)
    assert np.array_equal(rows[:, 1], np.float32(0.19) * t2s)
    assert np.array_equal(rows[:, 2], np.array(
        [np.float32((1.0 - t2) ** 2) for t2 in t2s], np.float32))
