"""Meshes and ranks on ``torch.distributed``.

The port's copy of ``repro.launch.mesh``.  The reference's mesh is a grid of
devices that one program spans (GSPMD); the port's ranks are processes,
each running the same program on its own shard, with explicit collectives
(SPMD with one controller per rank).  A :class:`Mesh` names the axes and
their sizes; once :meth:`Mesh.init_groups` has run inside a process group
it also holds one process group per axis and this rank's coordinates.  A
mesh without groups is a layout only: the planners accept it (that is how
:func:`make_production_mesh`'s (16, 16) and (2, 16, 16) shapes serve
``local_gemm_shape`` without 256 ranks), the collectives do not.
:meth:`Mesh.recording` makes a layout act as one of its ranks with no
process group: the op analyzer's recording rank, whose collectives are
recorded, not issued.

Topology of the reference's production meshes (TPU v5e):
  * single pod: (16, 16)  axes ("data", "model")          = 256 chips
  * multi-pod:  (2, 16, 16) axes ("pod", "data", "model") = 512 chips

:func:`spawn_ranks` is the one launcher: tests, ``serve --shards`` and
``chip_smoke.py`` start their ranks through it.
"""
from __future__ import annotations

import math
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_test_mesh",
    "train_mesh",
    "mesh_name",
    "mesh_chips",
    "gemm_partition",
    "spawn_ranks",
]

#: the backend name of a recording rank (:meth:`Mesh.recording`)
RECORDING = "record"

#: seconds to wait for the reports still in flight once a rank has died or
#: failed (the others may be blocked in a collective it never joins)
_REPORT_GRACE_S = 3.0


class Mesh:
    """Named mesh axes and their sizes; with :meth:`init_groups`, also one
    process group per axis and this rank's coordinates.

    ``shape`` maps axis name -> size (``mesh.shape["model"]``), as the
    reference's mesh does; ranks are laid out row-major over the axes in
    order, so rank ``r`` sits at ``np.unravel_index(r, sizes)``.
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]) -> None:
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh sizes {tuple(sizes)} do not match axes "
                             f"{tuple(axis_names)}")
        if any(int(s) < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {tuple(sizes)}")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names, sizes)}
        self.rank: Optional[int] = None
        self.coords: dict = {}  # axis -> this rank's index along it
        self.groups: dict = {}  # axis -> process group of this rank's line
        self.members: dict = {}  # axis -> the global ranks of that line, in order
        self.backend: Optional[str] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def has_groups(self) -> bool:
        return self.rank is not None

    def __repr__(self) -> str:
        where = "" if self.rank is None else f", rank={self.rank}"
        if self.is_recording:
            where += ", recording"
        return f"Mesh({self.shape}{where})"

    def init_groups(self) -> "Mesh":
        """Make one process group per axis line (every rank calls this, in
        the same order) and record this rank's coordinates.  Needs an
        initialized default process group whose world size is the mesh's."""
        if not dist.is_initialized():
            raise RuntimeError("Mesh.init_groups needs torch.distributed initialized")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the process "
                             f"group has {world}")
        self._place(dist.get_rank(), dist.get_backend(), dist.new_group)
        return self

    def recording(self, rank: int = 0) -> "Mesh":
        """This layout acting as rank ``rank`` with no process group: its
        coordinates and axis lines are set, so the planners, ``shard_tree``
        and the train step's checks see a rank, while every collective is
        recorded instead of issued (backend "record",
        ``sharding.record_collectives``).  It runs on fake tensors only
        (``core/op_analysis.py``); nothing of ``torch.distributed`` is
        initialized."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on mesh {self.shape}")
        mesh = Mesh([self.shape[a] for a in self.axis_names], self.axis_names)
        mesh._place(rank, RECORDING, None)
        return mesh

    @property
    def is_recording(self) -> bool:
        return self.backend == RECORDING

    def _place(self, rank: int, backend: str, new_group) -> None:
        """This rank's coordinates and axis lines; with ``new_group``, one
        process group per line (every rank creates every group, in one
        order)."""
        sizes = tuple(self.shape[a] for a in self.axis_names)
        grid = np.arange(self.size).reshape(sizes)
        self.rank = rank
        here = np.unravel_index(self.rank, sizes)
        self.coords = {a: int(c) for a, c in zip(self.axis_names, here)}
        self.backend = backend
        for i, a in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
            for line in lines:
                ranks = [int(r) for r in line]
                group = new_group(ranks) if new_group and len(ranks) > 1 else None
                if self.rank in ranks:
                    self.groups[a] = group
                    self.members[a] = ranks


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production topology, as a layout (no ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's shrunken CI topology, as a layout: (2, 2) over
    ("data", "model"), or (2, 2, 2) with "pod"."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def train_mesh(ranks: int, multi_pod: bool = False, *, model: int = 1) -> Mesh:
    """The training mesh the port maps the reference's production meshes
    onto, as a layout (each rank calls :meth:`Mesh.init_groups` on it):
    ("data", "model") = (ranks / model, model), or with ``multi_pod``
    ("pod", "data", "model") = (2, ranks / (2 · model), model).  The data
    axes carry ``TRAIN_RULES``' batch and FSDP (pod x data is hybrid), the
    "model" axis its tensor parallelism with sequence-parallel
    activations.  Raises when the counts do not divide."""
    if ranks < 1 or model < 1 or ranks % model or (multi_pod and (ranks // model) % 2):
        raise ValueError(f"a training mesh of {ranks} ranks with a 'model' axis of {model}: "
                         f"want ranks a multiple of model"
                         + (", and an even count of data ranks (multi-pod)" if multi_pod
                            else ""))
    if multi_pod:
        return Mesh((2, ranks // (2 * model), model), ("pod", "data", "model"))
    return Mesh((ranks // model, model), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def mesh_chips(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def gemm_partition(mesh):
    """The canonical GEMM sharding on this mesh: M over the data-ish axes
    ("pod", "data"), N over "model", K unsharded; the default partition of
    ``Engine.plan_gemm`` / ``plan_conv`` under a mesh."""
    from repro_torch.parallel.sharding import PartitionSpec as P

    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    model = "model" if "model" in mesh.axis_names else None
    if len(data) == 1:
        data = data[0]
    return P(data or None, model)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _host(out):
    """A rank's result made safe to return across processes: tensors become
    numpy arrays (bf16 as f32, which is exact)."""
    if isinstance(out, torch.Tensor):
        t = out.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)) and not hasattr(out, "_fields"):
        return type(out)(_host(v) for v in out)
    return out


def _rank_main(fn, rank: int, world: int, init: str, device: str, backend: str,
               results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # ranks share the host's cores
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        results.put((rank, True, _host(fn(rank, world, dev))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, device, backend: Optional[str] = None,
                timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, world, device)`` in ``world`` fresh processes joined by
    ``torch.distributed``; returns the ranks' results in rank order (tensors
    as numpy arrays).

    Rendezvous goes through a ``file://`` store in a new temporary
    directory, so concurrent callers never collide on a port.  ``device``
    "cpu" runs every rank on the host over ``gloo``; "cuda" gives rank r the
    card r over NCCL when each rank has a card of its own, and otherwise
    puts the ranks on the visible cards in turn (all on ``cuda:0`` on a
    one-card machine) over ``gloo``, whose collectives the port stages
    through the host; the kernels are built here first, once, from the
    checkout's sources, so no two ranks build the same library.
    ``backend`` overrides the choice ("nccl" needs a card per rank).
    ``fn`` must be picklable (a module-level function, or a
    ``functools.partial`` of one); its arguments travel by pickling, CUDA
    tensors by IPC handle.  ``timeout`` (seconds) bounds the wait for the
    ranks' results.

    Every rank is joined.  A rank that raises makes this raise with that
    rank's traceback, after the other ranks are stopped; a rank that dies
    without reporting raises with its exit code.
    """
    import torch.multiprocessing as mp

    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards == 0:
        raise RuntimeError("spawn_ranks(device='cuda') needs a CUDA card")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and world <= cards else "gloo"
    if backend == "nccl" and (dev.type != "cuda" or world > cards):
        raise ValueError(f"NCCL needs a card per rank: {world} ranks, {cards} cards")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")

    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()

    def rank_device(r):
        return "cpu" if dev.type == "cpu" else f"cuda:{r % cards}"

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, rank_device(r), backend, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed, dead_at = {}, {}, {}
        begun = time.monotonic()
        first_failure = None
        try:
            while len(got) + len(failed) < world:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                    (got if ok else failed)[rank] = out
                except queue_mod.Empty:
                    pass
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in got or r in failed or p.exitcode is None:
                        continue
                    # a report written just before the exit may still be in flight
                    if now - dead_at.setdefault(r, now) > _REPORT_GRACE_S:
                        failed[r] = f"exited with code {p.exitcode} and no report"
                if failed and first_failure is None:
                    first_failure = now
                if first_failure is not None and now - first_failure > _REPORT_GRACE_S:
                    break  # the rest wait in a collective that cannot complete
                if timeout is not None and now - begun > timeout:
                    failed[-1] = f"the ranks did not finish in {timeout} s"
                    break
        finally:
            if failed:
                for p in procs:
                    if p.is_alive():
                        p.kill()
            for p in procs:
                p.join()
    if failed:
        lines = "\n".join(f"rank {r}: {text}" for r, text in sorted(failed.items()))
        raise RuntimeError(f"{len(failed)} of {world} ranks failed:\n{lines}")
    return [got[r] for r in range(world)]
