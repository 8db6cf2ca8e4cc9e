"""The port's volume and image I/O against vpt_tpu's, on the CPU.

The loaders, the range ZIP reader and the file server are the port's own
copies of JAX-free modules; they are held to ``tests/test_io.py``'s cases.
BVP and RAW volumes cross between the packages as equal arrays (a BVP
stores uint8 voxels, so both readers decode the same bytes).  The PNG the
port writes with the standard library decodes through Pillow to JAX's
``to_uint8`` of the same image, pixel for pixel.
"""

import json
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu import environment as jenv
from vpt_tpu import volume as jvolume
from vpt_tpu.io import image as jimage
from vpt_tpu.io import readers as jreaders
from vpt_tpu_torch import environment as tenv
from vpt_tpu_torch import volume as tvolume
from vpt_tpu_torch.io import (
    BVPReader, BytesLoader, FileLoader, HTTPLoader, RAWReader,
    ZipRangeReader, list_modalities, load_volume, make_loader, read_image,
    to_uint8, write_bvp, write_png,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_file_and_bytes_loaders(tmp_path):
    p = tmp_path / "data.bin"
    p.write_bytes(bytes(range(256)))
    loader = FileLoader(p)
    assert loader.read_length() == 256
    assert loader.read_data(10, 20) == bytes(range(10, 20))
    loader = BytesLoader(b"hello world")
    assert loader.read_length() == 11
    assert loader.read_data(6, 11) == b"world"
    assert isinstance(make_loader(p), FileLoader)
    assert isinstance(make_loader(b"abc"), BytesLoader)
    assert isinstance(make_loader("http://x/y"), HTTPLoader)


@pytest.mark.parametrize("compression", [zipfile.ZIP_STORED,
                                         zipfile.ZIP_DEFLATED],
                         ids=["stored", "deflate"])
def test_zip_range_reader(tmp_path, compression):
    p = tmp_path / "test.zip"
    payload = b"A" * 10000 + bytes(range(256))
    with zipfile.ZipFile(p, "w", compression=compression) as zf:
        zf.writestr("manifest.json", '{"hello": 1}')
        zf.writestr("sub/data.raw", payload)
    reader = ZipRangeReader(p)
    assert set(reader.namelist()) == {"manifest.json", "sub/data.raw"}
    assert json.loads(reader.read_file("manifest.json")) == {"hello": 1}
    assert reader.read_file("sub/data.raw") == payload
    with pytest.raises(KeyError):
        reader.read_file("nope")


def test_raw_reader_matches_jax(tmp_path):
    data = np.random.default_rng(1).integers(0, 256, (5, 3, 4),
                                             dtype=np.uint8)
    p = tmp_path / "vol.raw"
    p.write_bytes(data.tobytes())
    reader = RAWReader(p, width=4, height=3, depth=5)
    assert reader.read_metadata() == jreaders.RAWReader(
        p, width=4, height=3, depth=5).read_metadata()
    vol = load_volume(reader, device="cpu")
    want = jreaders.load_volume(jreaders.RAWReader(p, 4, 3, 5))
    assert vol.data.shape == (5, 3, 4, 1) and vol.data.dtype == torch.float32
    assert np.array_equal(vol.data.numpy(), np.asarray(want.data))
    # uint16 and from_raw_bytes
    data16 = np.arange(60, dtype=np.uint16).reshape(5, 3, 4) * 1000
    p16 = tmp_path / "vol16.raw"
    p16.write_bytes(data16.tobytes())
    got = load_volume(RAWReader(p16, 4, 3, 5, gl_type=5123), device="cpu")
    want = jreaders.load_volume(jreaders.RAWReader(p16, 4, 3, 5,
                                                   gl_type=5123))
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    got = tvolume.from_raw_bytes(data.tobytes(), 5, 3, 4, device="cpu")
    want = jvolume.from_raw_bytes(data.tobytes(), 5, 3, 4)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


def test_bvp_crosses_between_the_packages(tmp_path):
    """JAX's archive read by the port, and the port's read by JAX: equal
    arrays; both archives hold the same bytes."""
    jsrc = jvolume.blobs_volume(12, seed=3)
    tsrc = tvolume.blobs_volume(12, seed=3, device="cpu")
    jreaders.write_bvp(tmp_path / "jax.bvp", jsrc)
    write_bvp(tmp_path / "port.bvp", tsrc)
    progress = []
    from_jax = load_volume(BVPReader(tmp_path / "jax.bvp"),
                           progress=progress.append, device="cpu")
    from_port = jreaders.load_volume(jreaders.BVPReader(tmp_path /
                                                        "port.bvp"))
    assert progress[-1] == 1.0
    assert from_jax.data.shape == (12, 12, 12, 1)
    assert np.array_equal(from_jax.data.numpy(), np.asarray(from_port.data))
    assert np.allclose(from_jax.data.numpy(), tsrc.data.numpy(),
                       atol=1 / 255)
    for name in ("manifest.json", "block0.raw"):
        assert ZipRangeReader(tmp_path / "jax.bvp").read_file(name) \
            == ZipRangeReader(tmp_path / "port.bvp").read_file(name)


def test_bvp_multi_modality(tmp_path):
    ct = tvolume.sphere_volume(8, device="cpu")
    pet = tvolume.blobs_volume(8, seed=5, device="cpu")
    path = tmp_path / "multi.bvp"
    write_bvp(path, {"ct": ct, "pet": pet})
    reader = BVPReader(str(path))
    assert list_modalities(reader) == jreaders.list_modalities(
        jreaders.BVPReader(str(path)))
    assert [m["name"] for m in list_modalities(reader)] == ["ct", "pet"]
    got = load_volume(reader, modality="pet", device="cpu")
    assert np.allclose(got.data.numpy(), pet.data.numpy(), atol=1 / 255)
    with pytest.raises(ValueError, match="'mri' does not exist"):
        load_volume(reader, modality="mri", device="cpu")


def test_bvp_over_the_range_server(tmp_path):
    """The streaming path on localhost: the port's server and HTTP
    loader."""
    from vpt_tpu_torch.io.server import serve_background

    src = tvolume.blobs_volume(8, seed=3, device="cpu")
    write_bvp(tmp_path / "vol.bvp", src)
    server, port = serve_background(str(tmp_path))
    try:
        vol = load_volume(BVPReader(f"http://127.0.0.1:{port}/vol.bvp"),
                          device="cpu")
    finally:
        server.shutdown()
        server.server_close()
    want = load_volume(BVPReader(tmp_path / "vol.bvp"), device="cpu")
    assert torch.equal(vol.data, want.data)


@pytest.mark.parametrize("shape", [(16, 16, 4), (9, 31, 3), (1, 1, 4)])
def test_write_png_decodes_to_jax_pixels(tmp_path, shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32) * 1.4 \
        - 0.2
    write_png(tmp_path / "port.png", torch.from_numpy(img))
    decoded = Image.open(tmp_path / "port.png")
    assert decoded.mode == "RGB"
    assert np.array_equal(np.asarray(decoded), jimage.to_uint8(img))
    assert np.array_equal(to_uint8(img), jimage.to_uint8(img))
    assert np.array_equal(to_uint8(img, flip=False),
                          jimage.to_uint8(img, flip=False))
    jimage.write_png(tmp_path / "jax.png", img)
    assert np.array_equal(read_image(tmp_path / "port.png"),
                          jimage.read_image(tmp_path / "jax.png"))


def test_synthetic_volumes_and_environments_match_jax(tmp_path):
    assert np.array_equal(tvolume.shell_volume(12, device="cpu").data.numpy(),
                          np.asarray(jvolume.shell_volume(12).data))
    assert np.array_equal(tenv.gradient_sky(8, 16, device="cpu").numpy(),
                          np.asarray(jenv.gradient_sky(8, 16)))
    img = np.random.default_rng(2).integers(0, 256, (4, 6, 3),
                                            dtype=np.uint8)
    for image in (img, img.astype(np.float32) / 255.0):
        assert np.array_equal(tenv.from_image(image, device="cpu").numpy(),
                              np.asarray(jenv.from_image(image)))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_image_matches_jax(tmp_path, mode):
    """An environment map's PNG in each of Pillow's common modes reads to
    JAX's RGBA pixels, flipped or not, and to JAX's environment."""
    rgba = np.random.default_rng(3).integers(0, 256, (12, 20, 4),
                                             dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").convert(mode).save(tmp_path / "map.png")
    for flip in (True, False):
        got = read_image(tmp_path / "map.png", flip=flip)
        assert got.dtype == np.float32 and got.shape == (12, 20, 4)
        assert np.array_equal(got, jimage.read_image(tmp_path / "map.png",
                                                     flip=flip))
    assert np.array_equal(
        tenv.from_image(read_image(tmp_path / "map.png"),
                        device="cpu").numpy(),
        np.asarray(jenv.from_image(jimage.read_image(tmp_path / "map.png"))))
