"""The plain twin of K9's slice table, and what K9 and K10 refuse, on the
CPU.

K9 (``csrc/dos_sweep.cu``) builds each slice's row of the frame's table
itself.  ``dos_sweep.slice_rows_plain`` is that computation in numpy
float32 scalars, one operation at a time in the kernel's order; it must
equal ``dos.slice_table`` (the rows the plain sweep reads) bit for bit,
frame after frame and past the far depth.

No JAX program is compiled here.
"""

import numpy as np
import pytest
import torch

from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import dos_sweep, lao_march
from vpt_tpu_torch.renderers import dos, lao, make_scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cpu_scene():
    return make_scene(volume.sphere_volume(8, device="cpu"),
                      transfer.gray_ramp(device="cpu"), device="cpu")


def _mirror(state, scene, params):
    h, w = state["color"].shape[:2]
    return dos_sweep.slice_rows_plain(
        float(state["depth"]), float(state["max_depth"]),
        float(state["slice_distance"]), scene.projection,
        state["offsets"], float(dos._tan_aperture(params, "cpu")),
        params.steps, h, w)


def _bits(rows):
    return np.asarray(rows, np.float32).view(np.uint32)


@pytest.mark.parametrize("params,size", [
    (dos.Params(), (16, 16)),
    (dos.Params(steps=7, slices=30, samples=3, aperture=50.0), (12, 20)),
    (dos.Params(steps=8, slices=30, samples=11, aperture=55.0), (20, 9)),
    (dos.Params(steps=1, slices=5, samples=1, aperture=10.0), (7, 5))],
    ids=["default", "odd", "even-undivided", "one"])
def test_dos_row_mirror_equals_slice_table_over_the_sweep(cpu_scene, params,
                                                          size):
    """At every frame of a sweep and two frames past it (all rows
    inactive), the mirror's rows are ``dos.slice_table``'s, bit for bit;
    the depth advance by the active rows ends the sweep."""
    h, w = size
    state = dos.reset(params, h, w, cpu_scene)
    frames = -(-params.slices // params.steps) + 2
    actives = []
    for _ in range(frames):
        table = dos.slice_table(state, cpu_scene, params)
        assert np.array_equal(_bits(table), _bits(_mirror(state, cpu_scene,
                                                          params)))
        actives.append(int(table[:, 1].sum()))
        dos.advance_depth(state, table)
    assert actives[-1] == 0 and actives[0] == min(params.steps,
                                                  params.slices + 1)
    assert float(state["depth"]) > float(state["max_depth"])


@pytest.mark.parametrize("where", [-0.5, 0.0, 0.5, 3.0])
def test_dos_row_mirror_at_the_far_depth(cpu_scene, where):
    """Depths around the far depth (``where`` slice distances past it):
    the active prefix ends where ``slice_table``'s does, bit for bit."""
    params = dos.Params(steps=9, samples=4, aperture=40.0)
    state = dos.reset(params, 10, 14, cpu_scene)
    sd = state["slice_distance"]
    state["depth"] = state["max_depth"] - 4.0 * sd + where * sd
    table = dos.slice_table(state, cpu_scene, params)
    assert np.array_equal(_bits(table), _bits(_mirror(state, cpu_scene,
                                                      params)))
    active = table[:, 1].numpy()
    assert 0 < active.sum() < params.steps
    assert np.array_equal(active, np.sort(active)[::-1])


def test_dos_table_and_lao_counts_need_the_card(cpu_scene):
    """The plain sweep writes no kernel table and the plain LAO frame
    counts nothing: asking for either on the CPU raises."""
    params = dos.Params(steps=2, slices=4, samples=2)
    state = dos.reset(params, 4, 4, cpu_scene)
    with pytest.raises(ValueError, match="table"):
        dos_sweep.sweep_frame(state, cpu_scene, params,
                              table=torch.zeros(2, 12))
    with pytest.raises(ValueError, match="counts"):
        lao_march.lao_frame(lao.reset(lao.Params(), 4, 4, cpu_scene),
                            cpu_scene, lao.Params(),
                            counts=torch.zeros(2, dtype=torch.int64))


def test_dos_kernel_refuses_rows_it_cannot_hold(cpu_scene):
    """A row of more taps than a block's 32 KB of rows holds, or a frame
    of no slices, is refused when the launch is prepared."""
    for params in (dos.Params(samples=dos_sweep.MAX_SAMPLES + 1),
                   dos.Params(steps=0)):
        with pytest.raises(ValueError, match="disk taps"):
            dos_sweep._scene_cache.get(cpu_scene, (params, 4, 4))
    p = dos_sweep._scene_cache.get(
        cpu_scene, (dos.Params(samples=dos_sweep.MAX_SAMPLES), 4, 4))
    assert 4 * (4 + 4 * p.args.samples) <= 32 * 1024
