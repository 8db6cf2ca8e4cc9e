"""Carry scenes and renderer state between ``vpt_tpu`` and the port.

Both sides meet as numpy arrays, so this module imports no JAX.  A JAX
``Scene``'s fields go through ``np.asarray``; its bfloat16 tables arrive as
``ml_dtypes.bfloat16`` arrays, which cross bit for bit as int16 views.
"""

from __future__ import annotations

import numpy as np
import torch

from .renderers.base import Scene, transfer_row

#: the Scene fields that cross (the JAX-only TPU layouts stay behind, but
#: the (TW, 4) ``transfer_mxu`` table carries its lookup mode: its dtype)
SCENE_FIELDS = ("volume", "transfer", "environment", "mvp_inverse",
                "model_view", "projection", "volume_packed",
                "transfer_packed", "tracking_packed", "transfer_mxu")


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy → torch, bfloat16 (``ml_dtypes``) included, bit for bit.  The
    array is copied: ``np.asarray`` of a JAX array is a view of JAX's own
    buffer, which the port's in-place updates must not write."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy; bfloat16 comes back as float32 (numpy has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def scene_fields(scene) -> dict:
    """The crossing fields of any scene object as numpy arrays (None where
    the scene has none), plus its ``filter``."""
    out = {}
    for k in SCENE_FIELDS:
        v = getattr(scene, k, None)
        out[k] = None if v is None else np.asarray(v)
    out["filter"] = getattr(scene, "filter", "linear")
    return out


def scene_from_numpy(fields: dict, device="cpu") -> Scene:
    """The port's Scene from a JAX Scene's fields as numpy arrays
    (``{name: np.asarray(getattr(scene, name))}`` for the names in
    :data:`SCENE_FIELDS` that are not None, plus ``filter``).  A
    ``transfer_mxu`` table becomes the TF row and sets ``Scene.tf_mxu`` to
    its dtype."""
    t = {k: tensor_from_numpy(fields[k], device)
         for k in SCENE_FIELDS if fields.get(k) is not None}
    transfer = t["transfer"]
    mxu = t.get("transfer_mxu")
    if mxu is not None:
        row = mxu.to(torch.float32).contiguous()
        mxu = mxu.dtype
    else:
        row = transfer_row(transfer, t.get("transfer_packed"))
    return Scene(volume=t["volume"], transfer=transfer,
                 environment=t["environment"],
                 mvp_inverse=t["mvp_inverse"], model_view=t["model_view"],
                 projection=t["projection"], transfer_1d=row,
                 volume_packed=t.get("volume_packed"),
                 transfer_packed=t.get("transfer_packed"),
                 tracking_packed=t.get("tracking_packed"),
                 filter=fields.get("filter", "linear"), tf_mxu=mxu)


def state_from_numpy(state: dict, device="cpu") -> dict:
    """A dict of numpy arrays → float32 tensors on ``device``, leaving out
    None entries: an MCM state, the differentiable machine's state with its
    ``logw`` (``renderers/diff_mc``), or the fit leaves ``{"volume": ...,
    "tf": ...}`` that ``vpt_tpu.train.fit_mc`` takes and returns."""
    return {k: tensor_from_numpy(np.asarray(v, np.float32), device)
            for k, v in state.items() if v is not None}


def state_to_numpy(state: dict) -> dict:
    return {k: tensor_to_numpy(v) for k, v in state.items()
            if v is not None}
