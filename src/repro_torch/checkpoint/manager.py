"""Atomic checkpoints of tensor trees, in the port.

The port's copy of ``repro.checkpoint.manager``, with the same on-disk
layout, so either package restores the other's checkpoints:

* **Atomicity** — a checkpoint is written into ``step_<n>.tmp-<...>``, every
  array and the manifest fsync'd, then renamed to ``step_<n>``
  (``step_XXXXXXXX/manifest.json`` + ``arr_XXXXX.npy``).  A crash mid-write
  leaves a ``.tmp`` directory that :func:`latest_step` ignores and the next
  save removes; the previous complete checkpoint is never touched.
* **Keys** — a leaf's key is its path in the tree, the reference's
  ``jax.tree_util`` spelling: a dict key as its string, a sequence index as
  its integer, joined by ``/`` (dict keys sorted).  The manifests of the
  two packages are equal for the same tree.
* **Tensors** leave the device through ``.cpu().numpy()``; a bf16 leaf is
  stored as its raw int16 view with ``"bfloat16"`` recorded as its dtype.
  :func:`restore` puts each array on the device (and in the dtype) of the
  target tree's leaf; with ``shardings`` (the elastic re-shard) each rank
  gets its slice of every leaf (``parallel.sharding.shard_tree``), cut on
  the host leaf by leaf.
* **Under a mesh** (``save(..., shardings=)``, a tree of this rank's
  shards) every leaf is gathered to its logical shape on rank 0, one leaf
  at a time and every rank in one order; rank 0 writes, atomically as above, and the
  other ranks wait at a barrier until the checkpoint is complete.  A
  checkpoint is the same whatever mesh saved it, so it restores onto any
  other mesh, or onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "manifest_extra", "CheckpointManager"]

_MANIFEST = "manifest.json"


def _walk(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in the
    reference's order (dict keys sorted); None is an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _name(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict:
    return {_name(path): leaf for path, leaf in _walk(tree)}


def _to_numpy(leaf):
    """(array, dtype name) of one leaf; bf16 leaves travel as int16 raws."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flat_shardings(tree, shardings) -> dict:
    """key -> the NamedSharding of each leaf of ``tree`` (None where the
    shardings tree, a prefix of ``tree``'s, gives none)."""
    from repro_torch.parallel.sharding import NamedSharding

    out = {}

    def walk(node, shard, prefix):
        if shard is None or isinstance(shard, NamedSharding):
            for path, _ in _walk(node, prefix):
                out[_name(path)] = shard
        elif isinstance(node, dict):
            for key in node:
                walk(node[key], shard[key], prefix + (key,))
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, shard[i], prefix + (i,))
        elif node is not None:
            raise TypeError(f"shardings node {shard!r} over the leaf {_name(prefix)}")

    walk(tree, shardings, ())
    return out


def _mesh_of(shardings):
    """The mesh of the first NamedSharding in a shardings tree, or None."""
    if shardings is None:
        return None
    if hasattr(shardings, "mesh") and hasattr(shardings, "spec"):
        return shardings.mesh
    subs = shardings.values() if isinstance(shardings, dict) else (
        shardings if isinstance(shardings, (list, tuple)) else ())
    return next((m for m in map(_mesh_of, subs) if m is not None), None)


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None,
         shardings: Optional[Any] = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step_<step>``.

    ``shardings`` (a NamedSharding tree on a mesh with ranks, the one
    ``tree``'s shards were cut by): every rank calls this; each leaf is
    gathered to its logical shape, rank 0 writes and the others wait at a
    barrier."""
    from repro_torch.parallel.sharding import unshard_leaf

    final = os.path.join(directory, f"step_{step:08d}")
    flat = sorted(_flatten(tree).items())
    by_key = _flat_shardings(tree, shardings) if shardings is not None else {}
    mesh = _mesh_of(shardings)

    def whole(key, leaf):
        sharding = by_key.get(key)
        return leaf if sharding is None else unshard_leaf(leaf, sharding, root=True)

    if mesh is not None and mesh.rank != 0:
        for key, leaf in flat:
            whole(key, leaf)  # this rank's part of each gather
        torch.distributed.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    try:
        names = {}
        for i, (key, leaf) in enumerate(flat):
            fname = f"arr_{i:05d}.npy"
            arr, dtype = _to_numpy(whole(key, leaf))
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            names[key] = {"file": fname, "dtype": dtype, "shape": list(arr.shape)}
            del arr
        manifest = {"step": step, "arrays": names, "extra": extra or {}}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # remove stale temp directories of crashed writers
    for d in os.listdir(directory):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    if mesh is not None:
        torch.distributed.barrier()  # the checkpoint is complete for every rank
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and ".tmp" not in d:
            if os.path.exists(os.path.join(directory, d, _MANIFEST)):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like, sharding=None):
    """One stored array as a leaf like the target's: a tensor on the target
    tensor's device and in its dtype, else a numpy array; with
    ``sharding``, this rank's slice of it (cut on the host, marked)."""
    from repro_torch.parallel.sharding import carry_marks, shard_tree

    arr = np.array(arr, order="C")  # keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if sharding is not None:
        t = shard_tree(t, sharding)
    if isinstance(like, torch.Tensor):
        return carry_marks(t, t.to(like.device, like.dtype))
    return t.numpy() if dtype != "bfloat16" else t


def _local_shape(shape, sharding) -> list:
    """The shape of one rank's shard of a ``shape`` leaf under ``sharding``
    (the drop rule of ``sharding.local_dim``)."""
    from repro_torch.parallel.sharding import local_dim

    spec = tuple(sharding.spec) + (None,) * len(shape)
    return [local_dim(n, sharding.mesh, spec[d]) for d, n in enumerate(shape)]


def _rebuild(tree, loaded: dict, prefix=()):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], loaded, prefix + (key,)) for key in tree}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(sub, loaded, prefix + (i,)) for i, sub in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return None if tree is None else loaded[_name(prefix)]


def restore(directory: str, step: int, target_tree: Any,
            shardings: Optional[Any] = None) -> Any:
    """Load checkpoint ``step`` into the structure of ``target_tree``; each
    leaf lands on its target leaf's device and dtype.

    ``shardings``: a tree of ``parallel.sharding.NamedSharding`` (the
    structure of ``target_tree``, or a prefix of it; from
    ``tree_shardings`` / ``column_parallel_shardings`` on a mesh with
    ranks): the elastic re-shard, each leaf restored as this rank's slice
    of it, cut on the host one leaf at a time.  ``target_tree`` then holds
    the logical (whole) shapes the checkpoint was saved at, or this rank's
    shards of them."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_target = _flatten(target_tree)
    by_key = _flat_shardings(target_tree, shardings) if shardings is not None else {}
    loaded = {}
    for key, meta in manifest["arrays"].items():
        if key not in flat_target:
            raise KeyError(f"checkpoint key {key!r} missing from target tree")
        arr = np.load(os.path.join(path, meta["file"]))
        want = list(np.shape(flat_target[key]))
        sharding = by_key.get(key)
        if list(arr.shape) != want and (
                sharding is None or _local_shape(arr.shape, sharding) != want):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != target {tuple(want)}")
        loaded[key] = _from_numpy(arr, meta["dtype"], flat_target[key], sharding)
        del arr
    missing = set(flat_target) - set(loaded)
    if missing:
        raise KeyError(f"target keys missing from checkpoint: {sorted(missing)[:5]}")
    return _rebuild(target_tree, loaded)


def manifest_extra(directory: str, step: int) -> dict:
    """The ``extra`` metadata dict stored with checkpoint ``step`` (a
    serving replica's in-flight session snapshots, a train loop's
    settings): :func:`restore` rebuilds only the arrays."""
    path = os.path.join(directory, f"step_{step:08d}", _MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    return manifest.get("extra") or {}


class CheckpointManager:
    """Keep-last-N rotation + auto-resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree, extra: Optional[dict] = None,
             shardings: Optional[Any] = None) -> str:
        """:func:`save`; under a mesh (``shardings``) only rank 0 rotates."""
        path = save(self.directory, step, tree, extra, shardings)
        mesh = _mesh_of(shardings)
        if mesh is None or mesh.rank == 0:
            self._gc()
        return path

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and ".tmp" not in d
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, target_tree, shardings=None):
        step = self.latest()
        if step is None:
            return None, None
        return step, restore(self.directory, step, target_tree, shardings)

    def latest_extra(self):
        """(step, extra dict) of the newest checkpoint, or (None, None)."""
        step = self.latest()
        if step is None:
            return None, None
        return step, manifest_extra(self.directory, step)
