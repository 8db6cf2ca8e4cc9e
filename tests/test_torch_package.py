"""Package rules of vpt_tpu_torch, checked on its sources.

The port must not import JAX.  The test process imports JAX anyway (through
tests/conftest.py), so this scans the source with ``ast`` instead of looking
at ``sys.modules``."""

import ast
import importlib
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "vpt_tpu_torch"
MODULES = sorted(PKG.rglob("*.py"))
ROOT_SCRIPT = PKG.parent / "chip_smoke.py"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", MODULES + [ROOT_SCRIPT],
                         ids=lambda p: str(p.relative_to(PKG.parent)))
def test_no_jax_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "vpt_tpu", "optax", "flax"}, roots


def test_every_module_imports():
    for path in MODULES:
        rel = path.relative_to(PKG.parent).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        importlib.import_module(name)


@pytest.mark.parametrize("source", ["tf1d.cu", "tonemap.cu",
                                    "mcm_event.cu", "corner_gather.cu",
                                    "corner_scatter.cu", "march.cu",
                                    "iso_shade.cu", "mcs_frame.cu",
                                    "dos_sweep.cu", "lao_march.cu"])
def test_kernel_sources_carry_their_note(source):
    """Each kernel names the TPU function it replaces, what bounds it on
    the H100 and what its design does about that."""
    text = (PKG / "csrc" / source).read_text()
    assert "Replaces" in text and "vpt_tpu/" in text
    assert "Bound on the H100" in text and "Design" in text


def test_build_flags_and_entry_points():
    from vpt_tpu_torch.kernels import _build

    assert set(_build.SIGNATURES) == {
        "vpt_tf1d_lookup", "vpt_tf1d_info", "vpt_tonemap", "vpt_mcm_event",
        "vpt_mcm_event_frame", "vpt_mcm_event_info", "vpt_gather_rows", "vpt_corner_fetch",
        "vpt_scatter_add_rows8", "vpt_corner_grad", "vpt_march_frame",
        "vpt_march_launch", "vpt_march_info", "vpt_iso_shade",
        "vpt_iso_shade_launch", "vpt_iso_shade_info", "vpt_mcs_frame",
        "vpt_mcs_launch", "vpt_mcs_info", "vpt_dos_frame",
        "vpt_dos_sweep_info", "vpt_lao_launch", "vpt_lao_count",
        "vpt_lao_info", "vpt_mcm_halo_event", "vpt_mcm_halo_info",
        "vpt_slab_fetch", "vpt_dos_band_check", "vpt_dos_band_slice",
        "vpt_dos_band_fetch", "vpt_mcm_resident_event",
        "vpt_mcm_resident_info", "vpt_march_halo_check",
        "vpt_march_halo_launch", "vpt_march_halo_info",
        "vpt_iso_halo_check", "vpt_iso_halo_launch", "vpt_iso_halo_info",
        "vpt_mcs_halo_check", "vpt_mcs_halo_run", "vpt_mcs_halo_info",
        "vpt_dos_halo_launch",
        "vpt_dos_halo_info", "vpt_lao_halo_launch",
        "vpt_lao_halo_info"}
    sources = " ".join(p.read_text() for p in (PKG / "csrc").glob("*.cu"))
    for name, argtypes in _build.SIGNATURES.items():
        # ctypes passes exactly the C function's parameters
        params = sources.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(params.split(",")) == len(argtypes), name
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 16


def test_chip_smoke_fails_without_a_gpu():
    """Without CUDA the script exits non-zero and prints no result line."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, str(ROOT_SCRIPT)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
