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
        meta["params"] = _params_meta(params)
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


def _params_meta(params):
    return {
        f.name: (getattr(params, f.name)
                 if not hasattr(getattr(params, f.name), "tolist")
                 else np.asarray(getattr(params, f.name)).tolist())
        for f in dataclasses.fields(params)
    }


class _Pending:
    """What :func:`save_sharded` returns: ``wait_until_finished()`` blocks
    until the write is on disk (orbax's checkpointer's method)."""

    def __init__(self, future=None):
        self._future = future

    def wait_until_finished(self):
        if self._future is not None:
            self._future.result()
            self._future = None


def _row_leaves(leaves, mesh, height):
    """Which leaves are (this rank's block of) the rows of an
    ``height``-row image: two or more dims and the rank's row count
    (``parallel.shard``'s rule); without a mesh, the whole image's."""
    from ..parallel.mesh import block_of

    r0, r1 = (0, height) if mesh is None else block_of(height, mesh)
    return [getattr(x, "ndim", 0) >= 2 and x.shape[0] == r1 - r0
            for x in leaves]


def _mesh_group(mesh):
    """The process group of every rank of ``mesh``."""
    import torch.distributed as dist

    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def _placements(mesh):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == "data" else Replicate()
            for name in mesh.mesh_dim_names]


def save_sharded(directory, renderer_key: str, state, frame_number: int,
                 params=None, extra: dict = None, wait: bool = True,
                 mesh=None, height: int = None):
    """A ``torch.distributed.checkpoint`` directory of a render state held
    as row blocks by the ranks of ``mesh`` (``parallel.shard.place_state``
    over ``data`` of an ``height``-row image), with ``vpt_tpu``'s
    metadata (renderer key, ``frame_number``, params, ``extra``) in
    ``meta.json``.  Each rank writes only its rows (the ranks of a
    ``space`` line hold the same rows; one of them writes them).
    ``mesh=None``: a whole state of one process (its rows are the leaves
    of the largest leading dim).  Every rank of the mesh calls it.

    ``wait=False`` writes in the background (``async_save``) and returns
    at once; call the result's ``wait_until_finished()`` before exiting or
    reading the directory.  The directory loads onto any number of ranks
    (:func:`load_sharded`)."""
    import pathlib

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    directory = pathlib.Path(directory).absolute()
    leaves, desc = _leaves(state)
    names = sorted(state) if isinstance(state, dict) else ["state"]
    if mesh is None:
        from ..parallel.shard import state_height

        height = state_height(state)
    rows = _row_leaves(leaves, mesh, height)
    tensors = {}
    for name, leaf, is_rows in zip(names, leaves, rows):
        leaf = torch.as_tensor(leaf)
        if is_rows and mesh is not None:
            from torch.distributed.tensor import DTensor

            shape = (height,) + tuple(leaf.shape[1:])
            leaf = DTensor.from_local(
                leaf.contiguous(), mesh, _placements(mesh), shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        tensors[name] = leaf
    meta = {
        "renderer": renderer_key,
        "frame_number": int(frame_number),
        "treedef": desc,
        "extra": extra or {},
        "state_keys": sorted(state) if isinstance(state, dict) else None,
        "rows": [n for n, r in zip(names, rows) if r],
        "height": height,
    }
    if params is not None:
        meta["params"] = _params_meta(params)
    group = None if mesh is None else _mesh_group(mesh)
    rank0 = mesh is None or dist.get_rank(group) == 0
    if rank0:
        directory.mkdir(parents=True, exist_ok=True)
        (directory / "meta.json").write_text(json.dumps(meta))
    kwargs = dict(checkpoint_id=str(directory), process_group=group,
                  no_dist=mesh is None)
    if wait:
        dcp.save({"state": tensors}, **kwargs)
        return _Pending()
    return _Pending(dcp.async_save({"state": tensors}, **kwargs))


def load_sharded(directory, state_example=None, mesh=None, device=None):
    """Read a :func:`save_sharded` directory → (renderer_key, state,
    frame_number, meta).  With ``mesh``, every rank of it reads its own
    block of rows of each row leaf (over ``data``; any number of ranks,
    not only the number that saved), as ``parallel.shard.place_state``
    would place them, and every other leaf whole; without, one process
    reads the whole state, on ``device`` (default: the card; with a mesh,
    its device type).  ``state_example``: accepted for ``vpt_tpu``'s
    signature; the structure comes from ``meta.json``."""
    import pathlib

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    del state_example
    directory = pathlib.Path(directory).absolute()
    meta = json.loads((directory / "meta.json").read_text())
    reader = dcp.FileSystemReader(str(directory))
    saved = reader.read_metadata().state_dict_metadata
    if mesh is not None:
        device = torch.device(mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = resolve_device(device)
    names = meta["state_keys"] or ["state"]
    tensors = {}
    for name in names:
        info = saved[f"state.{name}"]
        shape = tuple(info.size)
        dtype = info.properties.dtype
        if mesh is not None and name in meta["rows"]:
            from torch.distributed.tensor import DTensor

            from ..parallel.mesh import block_of

            r0, r1 = block_of(shape[0], mesh)
            local = torch.zeros((r1 - r0,) + shape[1:], dtype=dtype,
                                device=device)
            tensors[name] = DTensor.from_local(
                local, mesh, _placements(mesh), shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        else:
            tensors[name] = torch.zeros(shape, dtype=dtype, device=device)
    dcp.load({"state": tensors}, storage_reader=reader,
             process_group=None if mesh is None else _mesh_group(mesh),
             no_dist=mesh is None)
    leaves = {name: (t.to_local() if hasattr(t, "to_local") else t)
              for name, t in tensors.items()}
    state = leaves if meta["state_keys"] else leaves["state"]
    return meta["renderer"], state, meta["frame_number"], meta


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
