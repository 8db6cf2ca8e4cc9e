"""The display pass: the port of ``vpt_tpu/pallas/tonemap_kernel.py``.

``pow(max(curve(x·exposure), 0), 1/gamma)`` per channel with alpha forced
to 1, for the eight curves of :data:`vpt_tpu_torch.tonemap.RAW_CURVES`, as
one elementwise pass over the (H, W, 4) image (``csrc/tonemap.cu``).
``1/gamma`` is rounded to float32 on the host, as the Pallas wrapper does.

:func:`tonemap` takes the plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tonemap as tm
from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: curve name -> the kernel's curve id
CURVE_IDS = {name: i for i, name in enumerate(tm.RAW_CURVES)}


def _check_name(name):
    if name not in tm.RAW_CURVES:
        raise ValueError(
            f"tonemap kernel supports {sorted(tm.RAW_CURVES)}, not {name!r}")


def tonemap_plain(image, name: str = "reinhard", exposure=1.0, gamma=2.2):
    """The display pass in plain PyTorch: every channel through the curve,
    then alpha := 1."""
    _check_name(name)
    inv_gamma = float(np.float32(1.0 / gamma))
    y = torch.pow(torch.clamp(tm.RAW_CURVES[name](image * exposure),
                              min=0.0), inv_gamma)
    y[..., 3] = 1.0
    return y


def tonemap(image, name: str = "reinhard", exposure=1.0, gamma=2.2):
    """Apply tone mapper ``name`` to an (H, W, 4) float32 HDR image."""
    _check_name(name)
    if image.ndim != 3 or image.shape[-1] != 4:
        raise ValueError(f"tonemap expects an (H, W, 4) image, "
                         f"got {tuple(image.shape)}")
    if not image.is_cuda:
        return tonemap_plain(image, name, exposure, gamma)
    global LAUNCHES
    if image.dtype != torch.float32:
        raise ValueError("tonemap kernel takes float32 images")
    image = image.contiguous()
    _build.check_aligned(image, "the image")
    out = torch.empty_like(image)
    k0 = k1 = 0.0
    if name == "uncharted2":
        k0 = float(tm.uncharted2_white_scale())
    elif name == "lottes":
        k0, k1 = tm.lottes_bc()
    lib = _build.library()
    _build.check("vpt_tonemap", lib.vpt_tonemap(
        image.data_ptr(), out.data_ptr(), image.shape[0] * image.shape[1],
        CURVE_IDS[name], exposure, 1.0 / gamma, k0, k1,
        _build.stream_ptr(image)))
    LAUNCHES += 1
    return out
