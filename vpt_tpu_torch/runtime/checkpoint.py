"""Checkpoint / resume for progressive renders.

Mirrors ``vpt_tpu/runtime/checkpoint.py`` in the same ``.npz`` format, so
a checkpoint written by either package resumes in the other: the state's
arrays as ``leaf_0``, ``leaf_1``, … (a dict state's in sorted-key order,
as ``jax.tree_util`` flattens it) and a ``__meta__`` JSON string with
``renderer``, ``frame_number``, ``treedef``, ``params`` and ``extra``
(the context adds ``state_keys`` for dict states and ``seed0``).
Deterministic seeding (seeds derive from the frame index) makes a resumed
render bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..utils import resolve_device


def _leaves(state):
    """The state's tensors in ``jax.tree_util`` order, and its tree's
    description as ``str(treedef)`` gives it."""
    if isinstance(state, dict):
        keys = sorted(state)
        desc = "PyTreeDef({" + ", ".join(f"'{k}': *" for k in keys) + "})"
        return [state[k] for k in keys], desc
    return [state], "PyTreeDef(*)"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path, renderer_key: str, state, frame_number: int,
         params=None, extra: dict = None):
    """Write a progressive-render checkpoint."""
    leaves, desc = _leaves(state)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    meta = {
        "renderer": renderer_key,
        "frame_number": int(frame_number),
        "treedef": desc,
        "extra": extra or {},
    }
    if params is not None:
        meta["params"] = {
            f.name: (getattr(params, f.name)
                     if not hasattr(getattr(params, f.name), "tolist")
                     else np.asarray(getattr(params, f.name)).tolist())
            for f in dataclasses.fields(params)
        }
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _read(path, device):
    """(meta, leaves on ``device``) of a checkpoint file."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        count = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [torch.from_numpy(np.array(data[f"leaf_{i}"])).to(device)
                  for i in range(count)]
    return meta, leaves


def _rebuild(leaves, keys):
    """A dict state from its leaves and keys, or the one leaf."""
    return dict(zip(sorted(keys), leaves)) if keys else leaves[0]


def load(path, state_example=None, device=None):
    """Read a checkpoint → (renderer_key, state, frame_number, meta), the
    state's tensors on ``device`` (default: the card).

    ``state_example``: a state of the same structure (a dict of tensors or
    one tensor; its values are ignored).  If omitted, the state is returned
    as the list of its leaves."""
    meta, leaves = _read(path, resolve_device(device))
    state = leaves
    if state_example is not None:
        state = _rebuild(leaves, list(state_example)
                         if isinstance(state_example, dict) else None)
    return meta["renderer"], state, meta["frame_number"], meta


def save_sharded(*args, **kwargs):
    raise NotImplementedError(
        "orbax checkpoints of sharded states are not ported to "
        "vpt_tpu_torch (ROADMAP.md queue 1 item 16)")


def load_sharded(*args, **kwargs):
    raise NotImplementedError(
        "orbax checkpoints of sharded states are not ported to "
        "vpt_tpu_torch (ROADMAP.md queue 1 item 16)")


def resume_renderer(path, height: int = None, width: int = None,
                    device=None):
    """Rebuild a Renderer (factory, Params, state) from a checkpoint, its
    state on ``device`` (default: the card).

    A dict state (MCM, DOS) is rebuilt from ``extra.state_keys``, one key
    a leaf in sorted order; any other state is its one leaf.  ``vpt_tpu``
    probes ``module.reset`` for the structure instead, which the port's
    resets do not allow (MCM's and DOS's need a scene, the others make
    their state on the default device)."""
    from ..renderers import factory

    meta, leaves = _read(path, resolve_device(device))
    key = meta["renderer"]
    module = factory.get_module(key)
    pkwargs = meta.get("params", {})
    pfields = {f.name for f in dataclasses.fields(module.Params)}
    params = module.Params(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in pkwargs.items() if k in pfields})
    first = leaves[0]
    h = height or first.shape[0]
    w = width or first.shape[1]
    renderer = factory.make_renderer(key, params=params, height=h, width=w)
    names = meta.get("extra", {}).get("state_keys")
    if not names and len(leaves) != 1:
        raise ValueError(f"{path}: a state of {len(leaves)} arrays needs "
                         "extra.state_keys to be rebuilt")
    renderer.state = _rebuild(leaves, names)
    renderer.frame_number = meta["frame_number"]
    return renderer
