"""Carry scenes, renderer state and fit state between ``vpt_tpu`` and the
port.

Both sides meet as numpy arrays, so this module imports no JAX.  A JAX
``Scene``'s fields go through ``np.asarray``; its bfloat16 tables arrive as
``ml_dtypes.bfloat16`` arrays, which cross bit for bit as int16 views.
"""

from __future__ import annotations

import numpy as np
import torch

from .renderers.base import Scene, transfer_row
from .utils import resolve_device

#: the Scene fields that cross (the JAX-only TPU layouts stay behind, but
#: the (TW, 4) ``transfer_mxu`` table carries its lookup mode: its dtype),
#: besides ``filter`` and ``iso_clamp_min``
SCENE_FIELDS = ("volume", "transfer", "environment", "mvp_inverse",
                "model_view", "projection", "volume_packed",
                "transfer_packed", "tracking_packed", "transfer_mxu",
                "majorant", "occupied_aabb", "iso_aabb")


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy → torch on ``device`` (default: the card), bfloat16
    (``ml_dtypes``) included, bit for bit.  The array is copied:
    ``np.asarray`` of a JAX array is a view of JAX's own buffer, which the
    port's in-place updates must not write."""
    device = resolve_device(device)
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
    the scene has none), plus its ``filter`` and ``iso_clamp_min``."""
    out = {}
    for k in SCENE_FIELDS:
        v = getattr(scene, k, None)
        out[k] = None if v is None else np.asarray(v)
    out["filter"] = getattr(scene, "filter", "linear")
    out["iso_clamp_min"] = float(getattr(scene, "iso_clamp_min", 0.0))
    return out


def scene_from_numpy(fields: dict, device=None) -> Scene:
    """The port's Scene on ``device`` (default: the card) from a JAX Scene's
    fields as numpy arrays
    (``{name: np.asarray(getattr(scene, name))}`` for the names in
    :data:`SCENE_FIELDS` that are not None, plus ``filter`` and
    ``iso_clamp_min``).  A
    ``transfer_mxu`` table becomes the TF row and sets ``Scene.tf_mxu`` to
    its dtype.  A (D·H·W, 8·C) corner table of C > 2 channels crosses as
    its channels 0:2, the port's table of such a volume."""
    device = resolve_device(device)
    t = {k: tensor_from_numpy(fields[k], device)
         for k in SCENE_FIELDS if fields.get(k) is not None}
    packed = t.get("volume_packed")
    channels = t["volume"].shape[-1]
    if packed is not None and channels > 2:
        t["volume_packed"] = packed.reshape(-1, 8, channels)[..., :2] \
            .reshape(-1, 16).contiguous()
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
                 majorant=t.get("majorant"),
                 occupied_aabb=t.get("occupied_aabb"),
                 iso_aabb=t.get("iso_aabb"),
                 iso_clamp_min=float(fields.get("iso_clamp_min", 0.0)),
                 filter=fields.get("filter", "linear"), tf_mxu=mxu)


def state_from_numpy(state, device=None):
    """A renderer state from numpy to float32 tensors on ``device``
    (default: the card): one array, the accumulator of EAM, MIP, Depth,
    ISO, MCS or LAO ((H, W, 4) or (H, W)), becomes one tensor; a dict of
    arrays and 0-d scalars (an MCM state, a DOS state with its 0-d
    ``depth``, ``max_depth`` and ``slice_distance`` and its (N, 2)
    ``offsets``, the differentiable machine's state with its ``logw``
    (``renderers/diff_mc``), or the fit leaves ``{"volume": ..., "tf":
    ...}`` that ``vpt_tpu.train.fit_mc`` takes and returns) becomes a dict
    of tensors (0-d ones for the scalars), leaving out None entries."""
    device = resolve_device(device)
    if not isinstance(state, dict):
        return tensor_from_numpy(np.asarray(state, np.float32), device)
    return {k: tensor_from_numpy(np.asarray(v, np.float32), device)
            for k, v in state.items() if v is not None}


def state_to_numpy(state):
    """The inverse of :func:`state_from_numpy`: a tensor or a dict of
    tensors to numpy."""
    if isinstance(state, torch.Tensor):
        return tensor_to_numpy(state)
    return {k: tensor_to_numpy(v) for k, v in state.items()
            if v is not None}


def adam_state_from_numpy(count, mu, nu, device=None):
    """``optax.adam``'s state as numpy (``ScaleByAdamState``'s ``count``,
    and ``mu``, ``nu``: {leaf name: array}) → the port's Adam state
    (``train.make_train_step``'s ``opt_state``): {leaf name: {"step",
    "exp_avg", "exp_avg_sq"}} as ``torch.optim.Adam`` keeps it, the step a
    0-d float32 tensor on the host and the moments on ``device`` (default:
    the card).  Both run the same update from this state."""
    device = resolve_device(device)
    return {name: {"step": torch.tensor(float(np.asarray(count)),
                                        dtype=torch.float32),
                   "exp_avg": tensor_from_numpy(
                       np.asarray(mu[name], np.float32), device),
                   "exp_avg_sq": tensor_from_numpy(
                       np.asarray(nu[name], np.float32), device)}
            for name in mu}


def adam_state_to_numpy(opt_state):
    """The inverse of :func:`adam_state_from_numpy`: ``(count, mu, nu)``,
    the count an int32 (every leaf's Adam step is the same)."""
    steps = {int(s["step"]) for s in opt_state.values()}
    if len(steps) != 1:
        raise ValueError(f"the leaves' Adam steps differ: {sorted(steps)}")
    return (np.int32(steps.pop()),
            {k: tensor_to_numpy(s["exp_avg"]) for k, s in opt_state.items()},
            {k: tensor_to_numpy(s["exp_avg_sq"])
             for k, s in opt_state.items()})


def fit_state_from_numpy(fields: dict, device=None):
    """A ``vpt_tpu.train.FitState`` as numpy (``volume_data``,
    ``tf_texture``, ``step``, and its optax Adam state's ``count``, ``mu``
    and ``nu``) → the port's ``train.FitState`` on ``device`` (default:
    the card)."""
    from .train import FitState

    device = resolve_device(device)
    return FitState(
        volume_data=tensor_from_numpy(
            np.asarray(fields["volume_data"], np.float32), device),
        tf_texture=tensor_from_numpy(
            np.asarray(fields["tf_texture"], np.float32), device),
        opt_state=adam_state_from_numpy(fields["count"], fields["mu"],
                                        fields["nu"], device),
        step=int(fields.get("step", 0)))


def fit_state_to_numpy(state) -> dict:
    """The inverse of :func:`fit_state_from_numpy`."""
    count, mu, nu = adam_state_to_numpy(state.opt_state)
    return {"volume_data": tensor_to_numpy(state.volume_data),
            "tf_texture": tensor_to_numpy(state.tf_texture),
            "count": count, "mu": mu, "nu": nu, "step": int(state.step)}


#: the dtypes a resident pool's leaves take in the port (the photon
#: fields and ``ndc`` are float32; ``rstate`` holds a uint32 in an int64,
#: ``rng.py``'s layout of a stream)
_POOL_DTYPES = {"pixel_id": np.int32, "rstate": np.int64,
                "occupied": np.bool_, "pending": np.bool_,
                "migrated": np.int32, "stalled": np.int32,
                "dropped": np.int32}


def resident_pool_from_numpy(global_pool, data_index: int,
                             space_index: int, device=None) -> dict:
    """Rank (``data_index``, ``space_index``)'s block of ``vpt_tpu``'s
    global ``(n_data, S, capacity, …)`` resident pool (numpy arrays, or
    JAX arrays through ``np.asarray``) as the port's pool on ``device``
    (default: the card): (capacity, c) rows, the uint32 ``rstate`` as an
    int64, the counters as 0-d int32 tensors."""
    device = resolve_device(device)
    out = {}
    for name, value in global_pool.items():
        a = np.asarray(value)[data_index, space_index]
        out[name] = tensor_from_numpy(
            a.astype(_POOL_DTYPES.get(name, np.float32)), device)
    return out


def resident_pool_to_numpy(blocks) -> dict:
    """The inverse of :func:`resident_pool_from_numpy`: ``blocks[d][s]``,
    rank (d, s)'s pool, joined into ``vpt_tpu``'s global pool (``rstate``
    as uint32)."""
    names = blocks[0][0].keys()
    out = {}
    for name in names:
        a = np.stack([np.stack([tensor_to_numpy(row[name]) for row in line])
                      for line in blocks])
        out[name] = a.astype(np.uint32) if name == "rstate" else a
    return out
