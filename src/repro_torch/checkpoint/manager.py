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
  gets its slice of every leaf (``parallel.sharding.shard_tree``).
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


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    try:
        flat = _flatten(tree)
        names = {}
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            fname = f"arr_{i:05d}.npy"
            arr, dtype = _to_numpy(leaf)
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            names[key] = {"file": fname, "dtype": dtype, "shape": list(arr.shape)}
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


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """One stored array as a leaf like the target's: a tensor on the target
    tensor's device and in its dtype, else a numpy array."""
    arr = np.array(arr, order="C")  # keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(like.device, like.dtype)
    return t.numpy() if dtype != "bfloat16" else t


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
    of it.  ``target_tree`` then holds the logical (whole) shapes the
    checkpoint was saved at."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_target = _flatten(target_tree)
    loaded = {}
    for key, meta in manifest["arrays"].items():
        if key not in flat_target:
            raise KeyError(f"checkpoint key {key!r} missing from target tree")
        arr = np.load(os.path.join(path, meta["file"]))
        want = list(np.shape(flat_target[key]))
        if list(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != target {tuple(want)}")
        loaded[key] = _from_numpy(arr, meta["dtype"], flat_target[key])
    missing = set(flat_target) - set(loaded)
    if missing:
        raise KeyError(f"target keys missing from checkpoint: {sorted(missing)[:5]}")
    tree = _rebuild(target_tree, loaded)
    if shardings is None:
        return tree
    from repro_torch.parallel.sharding import shard_tree

    return shard_tree(tree, shardings)


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

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        path = save(self.directory, step, tree, extra)
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
