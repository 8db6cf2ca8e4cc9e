"""The port's viewer server against ``vpt_tpu``'s, on the CPU: the cases of
``tests/test_runtime.py:150-397`` on both servers, each on a context of
its own package over the same volume (``blobs_volume(24, seed=7)``), TF
(``gray_ramp(0.9)``, sRGB) and queries, at 32², float32 tables
(``exact``): ``tests/test_torch_runtime.py``'s contexts.  (At 24² JAX's
jitted ``pixel_ndc`` divides through a reciprocal and hashes 15–17% of the
pixels to other MCM streams, ROADMAP queue 3; at 32² it does not.)

- ``/info``: the renderers, tone mappers, their schemas (``static`` flags
  included) and the state equal JAX's; ``frame_cost_ms_512`` (TPU times)
  is absent.  ``/`` is JAX's page with the port's title, and without the
  comment that says /info serves frame costs.
- ``/tf``: a POST of widget bumps, the echo, the rasterized texture
  (within 1e-6), ``/tf.png``'s pixels and ``/histogram`` equal JAX's.
- ``/frame`` PNGs after a pose change: EAM within 1 uint8 level in every
  pixel (measured: equal); MCM, 2 requests of 1 spp, pixels within 1 level in at least 97%
  and ``samples`` equal in at least 97% (``tests/test_torch_runtime.py``'s
  MCM bound; measured: all pixels equal).
- The update rules: a pose change keeps the renderer and resets; a Params
  change swaps the Params and resets; a ``static`` field rebuilds; the
  legacy ``extinction`` knob and malformed ``rp`` payloads; resolution,
  filter, TRS and focus, each with the same outcome as JAX's.
"""

import io
import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.runtime import RenderingContext as JContext
from vpt_tpu.runtime import viewer as jviewer
from vpt_tpu_torch import transfer as ttransfer
from vpt_tpu_torch import volume as tvolume
from vpt_tpu_torch.runtime import RenderingContext as TContext
from vpt_tpu_torch.runtime import viewer as tviewer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RES = 32
BUMPS = [{"position": {"x": 0.3, "y": 0.5}, "size": {"x": 0.25, "y": 0.2},
          "color": {"r": 0.2, "g": 0.9, "b": 0.4, "a": 0.8}},
         {"position": {"x": 0.7, "y": 0.4}, "size": {"x": 0.1, "y": 0.3},
          "color": {"r": 0.9, "g": 0.3, "b": 0.1, "a": 0.5}}]


def _contexts(renderer="eam"):
    j = JContext(resolution=RES, precision="exact", tf_srgb=True)
    j.set_volume(jvolume.blobs_volume(24, seed=7))
    j.set_transfer_function(jtransfer.gray_ramp(alpha_scale=0.9))
    j.choose_renderer(renderer)
    j.choose_tone_mapper("reinhard")
    t = TContext(resolution=RES, precision="exact", tf_srgb=True,
                 device="cpu")
    t.set_volume(tvolume.blobs_volume(24, seed=7, device="cpu"))
    t.set_transfer_function(ttransfer.gray_ramp(alpha_scale=0.9,
                                                device="cpu"))
    t.choose_renderer(renderer)
    t.choose_tone_mapper("reinhard")
    return j, t


@pytest.fixture
def servers():
    """Both servers on their contexts, serving on free ports; yields
    [(server, base URL)] in the order JAX, port."""
    out = []
    for cls, ctx in zip((jviewer.ViewerServer, tviewer.ViewerServer),
                        _contexts()):
        server = cls(ctx, port=0)
        out.append((server, f"http://127.0.0.1:{server.serve_background()}"))
    yield out
    for server, _ in out:
        server.shutdown()


def _get(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return resp.read()


def _png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(data)))


def test_info_and_page_match_jax(servers):
    (_, jbase), (_, tbase) = servers
    jinfo = json.loads(_get(f"{jbase}/info"))
    tinfo = json.loads(_get(f"{tbase}/info"))
    assert "frame_cost_ms_512" in jinfo and "frame_cost_ms_512" not in tinfo
    del jinfo["frame_cost_ms_512"]
    assert tinfo == jinfo
    statics = {key: sorted(f["name"] for f in fields if f["static"])
               for key, fields in tinfo["schema"]["renderers"].items()}
    assert statics["dos"] == ["samples", "slices", "steps"]
    assert statics["mcs"] == []
    page = _get(f"{tbase}/").decode()
    assert "<title>vpt_tpu_torch viewer</title>" in page
    jpage = _get(f"{jbase}/").decode()
    assert "BENCH_NOTES" in jpage and "BENCH_NOTES" not in page
    # the page is JAX's but for the title and that comment
    differ = [(a, b) for a, b in zip(jpage.splitlines(), page.splitlines())
              if a != b]
    assert len(jpage.splitlines()) == len(page.splitlines())
    assert len(differ) == 4, differ


def test_tf_editor_endpoints_match_jax(servers):
    (jserver, jbase), (tserver, tbase) = servers
    hists = [json.loads(_get(f"{base}/histogram")) for _, base in servers]
    assert hists[1] == hists[0] and len(hists[1]) == 96
    assert max(hists[1]) == 1.0
    for _, base in servers:
        assert json.loads(_get(f"{base}/tf")) == []
        assert json.loads(_get(f"{base}/tf", json.dumps(BUMPS).encode()))[
            "ok"]
    echoed = [json.loads(_get(f"{base}/tf")) for _, base in servers]
    assert echoed[1] == echoed[0] and len(echoed[1]) == 2
    assert np.allclose(tserver.ctx.transfer_texture.numpy(),
                       np.asarray(jserver.ctx.transfer_texture), rtol=0,
                       atol=1e-6)
    pngs = [_png(_get(f"{base}/tf.png")) for _, base in servers]
    assert pngs[1].shape == pngs[0].shape == (256, 256, 4)
    assert np.abs(pngs[1].astype(int) - pngs[0].astype(int)).max() <= 1
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{tbase}/tf", b"not json")
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{tbase}/nothing")
    assert err.value.code == 404


def _frames(servers, query, requests):
    out = []
    for _, base in servers:
        for _ in range(requests):
            png = _png(_get(f"{base}/frame?{query}"))
        out.append(png.astype(int))
    return out


def test_eam_frames_match_jax(servers):
    """Two EAM requests of 2 spp at a pose, then one at another pose with
    a new extinction: every pixel within 1 uint8 level."""
    query = ("yaw=0.3&pitch=0.2&spp=2&renderer=eam&tonemap=reinhard"
             "&reset=1")
    j, t = _frames(servers, query, 2)
    assert j.shape == t.shape == (RES, RES, 3) and j.max() > 0
    assert np.abs(t - j).max() <= 1
    j, t = _frames(servers, "yaw=-0.7&pitch=0.4&spp=2&renderer=eam&rp="
                   + urllib.parse.quote(json.dumps({"extinction": 40})), 1)
    assert np.abs(t - j).max() <= 1
    for server, _ in servers:
        assert server.ctx.renderer.frame_number == 2


def test_mcm_frames_match_jax(servers):
    query = "yaw=0.3&pitch=0.2&spp=1&renderer=mcm&tonemap=reinhard"
    j, t = _frames(servers, query, 2)
    near = (np.abs(t - j) <= 1).all(-1)
    assert near.mean() >= 0.97, near.mean()
    (jserver, _), (tserver, _) = servers
    samples = (tserver.ctx.renderer.state["samples"].numpy()
               == np.asarray(jserver.ctx.renderer.state["samples"]))
    assert samples.mean() >= 0.97, samples.mean()
    assert tserver.ctx.renderer.frame_number == 2


def _base_query(**extra):
    q = {"yaw": ["0.1"], "pitch": ["0.0"], "renderer": ["eam"],
         "tonemap": ["reinhard"], "rp": [json.dumps({"extinction": 20})],
         "reset": ["1"]}
    q.update(extra)
    return q


def _rules(server):
    """``tests/test_runtime.py``'s pose/Params/static sequence on one
    server; the observations as a list."""
    ctx = server.ctx
    seen = []
    q1 = _base_query()
    server._apply_query(q1)
    r1 = ctx.renderer
    q2 = dict(q1, yaw=["0.5"], reset=["0"])
    server._apply_query(q2)
    seen.append(("pose keeps renderer", ctx.renderer is r1,
                 ctx.renderer.state is None))
    ctx.renderer.state = object()
    q3 = dict(q2, rp=[json.dumps({"extinction": 55})])
    server._apply_query(q3)
    seen.append(("params swap", ctx.renderer is r1,
                 float(ctx.renderer.params.extinction),
                 ctx.renderer.state is None))
    ctx.renderer.state = object()
    server._apply_query(dict(q3, tonemap=["aces"],
                             tp=[json.dumps({"exposure": 2})]))
    seen.append(("tone mapper keeps state", ctx.renderer is r1,
                 ctx.renderer.state is not None, ctx.tone_mapper.name,
                 ctx.tone_mapper.params))
    q4 = dict(q3, rp=[json.dumps({"extinction": 55, "slices": 32})])
    server._apply_query(q4)
    seen.append(("static rebuilds", ctx.renderer is not r1,
                 ctx.renderer.params.slices))
    q5 = dict(q1, renderer=["mcs"], extinction=["7"])
    del q5["rp"]
    server._apply_query(q5)
    seen.append(("legacy knob", ctx.renderer_key,
                 float(ctx.renderer.params.extinction)))
    for bad in ('[1]', '"x"', '3', 'not-json'):
        server._apply_query(dict(q1, rp=[bad]))
        seen.append(("malformed", bad, ctx.renderer_key,
                     float(ctx.renderer.params.extinction)))
    r2 = ctx.renderer
    server._apply_query(dict(q1, rp=[json.dumps({"extinction": 20,
                                                 "random": "false"})]))
    seen.append(("bool static", ctx.renderer is not r2,
                 ctx.renderer.params.random))
    return seen


def test_update_rules_match_jax():
    seen = [_rules(cls(ctx, port=0)) for cls, ctx in
            zip((jviewer.ViewerServer, tviewer.ViewerServer), _contexts())]
    assert seen[1] == seen[0]
    # every rule held: the renderer kept, reset, swapped or rebuilt
    assert all(obs[1] is True for obs in seen[1] if obs[0] != "legacy knob"
               and obs[0] != "malformed")


def test_resolution_filter_trs_and_focus_match_jax():
    out = []
    for cls, ctx in zip((jviewer.ViewerServer, tviewer.ViewerServer),
                        _contexts("mip")):
        server = cls(ctx, port=0)
        q = {"yaw": ["0.1"], "pitch": ["0.0"], "renderer": ["mip"],
             "tonemap": ["reinhard"], "extinction": ["20"],
             "resolution": ["16"], "filter": ["nearest"], "reset": ["1"],
             "vtrans": ["0.1,0,0"], "vrot": ["0,45,0"],
             "vscale": ["1,2,1"]}
        server._apply_query(q)
        obs = [ctx.resolution, ctx.filter, ctx.renderer.height,
               np.asarray(ctx.volume_transform.local_translation),
               np.asarray(ctx.volume_transform.local_scale),
               np.asarray(ctx.get_scene().mvp_inverse)]
        ctx.render(frames=1)
        obs.append(np.asarray(ctx.get_display_image()))
        server._apply_query(dict(q, vtrans=["0,0,0"], vrot=["0,0,0"],
                                 vscale=["1,1,1"]))
        obs.append(np.asarray(ctx.get_scene().mvp_inverse))
        eye0 = np.asarray(ctx.camera.transform.local_translation).copy()
        server._apply_query(dict(q, focus=["0.3,0,0"]))
        obs.append(np.asarray(ctx.camera.transform.local_translation)
                   - eye0)
        out.append(obs)
    (jres, jfilt, jh, *jarrays), (tres, tfilt, th, *tarrays) = out
    assert (tres, tfilt, th) == (jres, jfilt, jh) == (16, "nearest", 16)
    for got, want in zip(tarrays, jarrays):
        assert got.shape == want.shape
        assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.allclose(tarrays[-1], [0.3, 0, 0], atol=1e-6)
    # the identity TRS restores other matrices than the scaled volume's
    assert not np.allclose(tarrays[2], tarrays[4])
