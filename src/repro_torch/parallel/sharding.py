"""Logical-axis sharding on ``torch.distributed``: rules, local shapes, the
H-slab halo exchange, and the collectives at the model's seams.

The port's copy of ``repro.parallel.sharding``.  The rule tables, the drop
rule, the local-shape planners and the spatial halo planner are the
reference's, as pure Python.  Execution differs: the reference annotates a
global program and lets GSPMD place the data; here each rank is a process
that holds its own shard, and the collectives are explicit.

* **Placement specs.** :func:`logical_to_spec`, :func:`tree_shardings` and
  :func:`column_parallel_shardings` return :class:`PartitionSpec` /
  :class:`NamedSharding` values of this module: per dim, the mesh axis (or
  tuple of axes) it shards over.  :func:`shard_tree` slices a tree to the
  calling rank's shard.
* **Shard marks.** A sliced leaf, and every GEMM output computed from a
  column shard, carries a mark on the tensor object: which dims are shards,
  over which axis, and their logical size.  A GEMM whose contraction dim
  is a shard on both operands (a row-parallel weight) leaves a partial-sum
  mark instead: the output is this rank's term of a sum over those axes.
  :func:`constrain` resolves the marks a tensor carries against the spec
  the active rules give it: a partial sum is reduce-scattered onto the dim
  the rules shard over its axis (all-reduced where none does), a marked dim
  the rules keep whole is all-gathered, and, under sequence-parallel rules
  (``TRAIN_RULES``' ``seq_act`` over a "model" axis above 1), a whole dim
  the rules shard is cut to this rank's shard.  Without a mesh it is a
  no-op.  The engine gathers a marked contraction dim before a GEMM whose
  weight holds that dim whole (column-parallel decode, ``DECODE_RULES``),
  gathers a row dim that shards over the axis the weight's columns shard
  over, and cuts a whole contraction dim to a row-parallel weight's shard.
  :func:`split_last` / :func:`merge_last` carry a column mark into heads
  and back, gathering half a head whole.
* **Training seams** (``TRAIN_RULES``: data-parallel, FSDP, pod x data and
  tensor parallelism with sequence-parallel activations).  Every seam is
  an autograd function whose backward is its forward's adjoint under the
  port's convention: a rank's loss is its part of the global loss, and the
  gradient a rank holds for a replicated value is its part of the sum.
  An all-gather's backward is the reduce-scatter (a sum), a
  reduce-scatter's the all-gather, an all-reduce's the all-reduce, a cut's
  the zero-padded gradient.  :func:`gather_fsdp` gathers a layer's FSDP
  shards (dims that shard over a batch axis) at the point of use through
  :func:`fsdp_gather`; :func:`gather_params` does so over other axes (a
  head whose vocab the sequence's axis must leave whole, an SSD block's
  per-channel leaves); :func:`grad_all_reduce` sums the grads of the leaves
  an axis of the loss replicates (every leaf "model" replicates too: its
  inputs were the rank's part); :func:`psum` sums a value that carries no
  gradient (a mask count, a metric).  Reductions run in f32.
  :data:`SEAM_COUNTS` counts every seam's collectives by (seam, pass, axis).
* **Serving seams** (``SERVE_RULES``: heads over "model", the decode KV
  ring's sequence over "model", ``seq_kv``).  :func:`ring_owner` says which
  rank holds a ring slot (a rank holds its :func:`local_rows` of the
  slots); a decode step attends over its own slots and merges the ranks'
  partial softmaxes with :func:`softmax_combine` (an all-reduce max of the
  row maxima, a rescale, one all-reduce sum of denominators and
  accumulators packed together).  A row-parallel projection's partial sum
  (``mark_partial``, in f32) is reduced by the seam that reads it.
* **Spatial seams.** :func:`halo_exchange` and :func:`mask_slab_rows` take
  the slab-major layout ``(S, N, lx, W, C)``.  With ``axis=None`` they run
  the reference's slab-major simulation on one device (``torch.roll`` and
  the edge mask); over a mesh axis each rank holds its own slab
  ``(1, N, lx, W, C)`` and sends only its ``up`` / ``dn`` rows to its
  neighbours, with zeros at the mesh edges.

Under ``gloo`` the collectives stage CUDA tensors through the host (gloo
takes no CUDA tensor for send / recv); every collective moves bytes, so
int16 raws and bf16 go through unchanged.  On a recording rank
(``launch/mesh.py:Mesh.recording``, no process group) the helpers that
call ``torch.distributed`` record each collective instead
(:func:`record_collectives`: kind, seam, axis, group size, result bytes)
and return a fake tensor of the result's shape; ``core/op_analysis.py``
counts a step so.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

__all__ = [
    "ShardingRules",
    "TRAIN_RULES",
    "SERVE_RULES",
    "DECODE_RULES",
    "PartitionSpec",
    "NamedSharding",
    "SpatialHalo",
    "column_parallel_shardings",
    "is_axes_leaf",
    "use_mesh",
    "mesh_state",
    "use_mesh_state",
    "active_mesh",
    "active_rules",
    "axis_size",
    "local_dim",
    "local_gemm_shape",
    "local_conv_shapes",
    "logical_to_spec",
    "constrain",
    "constrain_slabs",
    "named_sharding",
    "tree_shardings",
    "shard_tree",
    "subtree",
    "plan_spatial_halo",
    "spatial_shards",
    "halo_exchange",
    "mask_slab_rows",
    "spatial_halo_bytes",
    "spatial_gather_bytes",
    "shard_marks",
    "mark_shard",
    "carry_marks",
    "replicated",
    "gather",
    "fsdp_gather",
    "gather_fsdp",
    "grad_all_reduce",
    "psum",
    "SEAM_COUNTS",
    "collective_counts",
    "partial_axes",
    "mark_partial",
    "mark_axes",
    "take_shard",
    "split_last",
    "merge_last",
    "embedding_lookup",
    "gather_params",
    "seq_parallel_axes",
    "loss_axes",
    "batch_axes",
    "split_batch_axes",
    "microbatch_rows",
    "axis_coord",
    "local_rows",
    "batch_split",
    "active_batch_split",
    "mesh_over",
    "Collective",
    "record_collectives",
    "LayoutRefused",
    "partial_dtype",
    "ring_owner",
    "softmax_combine",
]

MeshAxes = Union[str, tuple, None]


class LayoutRefused(ValueError):
    """A sharding layout that the port's step does not run, by design (each
    case stands in ROADMAP.md's queue 3, "Differences by design"); the
    dry-run records it as its cell's ``analysis_refused``."""


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name -> mesh axis (or tuple, or None)."""

    rules: tuple = ()

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def with_overrides(self, **overrides) -> "ShardingRules":
        kept = tuple((k, v) for k, v in self.rules if k not in overrides)
        return ShardingRules(rules=kept + tuple(overrides.items()))


def _mk(rules: dict) -> ShardingRules:
    return ShardingRules(rules=tuple(rules.items()))


#: Training: FSDP over "data" + TP over "model"; batch over every data-ish axis.
TRAIN_RULES = _mk(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "seq_act": "model",
        "seq_kv": "model",
        "embed": "data",
        "embed_tp": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "expert_cap": None,
        "ssm_inner": "model",
        "rec": "model",
        "rec_in": None,
        "conv_io": None,
        "state": None,
        "ctx": None,
        "act_heads": "model",
        "act_embed": None,
    }
)

#: Serving: params replicated over "data" (no FSDP), TP over "model";
#: batch over data axes.
SERVE_RULES = _mk(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "seq_act": None,
        "seq_kv": "model",
        "embed": None,
        "embed_tp": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "expert_cap": None,
        "ssm_inner": "model",
        "rec": "model",
        "rec_in": None,
        "conv_io": None,
        "state": None,
        "ctx": None,
        "act_heads": "model",
        "act_embed": None,
    }
)

#: Bitwise-reproducible tensor-parallel decode: params column-parallel only
#: (each weight split along the columns it produces, see
#: :func:`column_parallel_shardings`), activations gathered back to whole at
#: the seams between GEMMs, so every contraction keeps its full K extent and
#: its single-device reduction order.  Batch (the per-slot KV cache's slot
#: dim) shards over the data-ish axes; vocab stays sharded until the logits
#: are gathered for sampling.
DECODE_RULES = _mk(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "seq_act": None,
        "seq_kv": None,
        "embed": None,
        "embed_tp": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "qkv": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": None,
        "expert_mlp": None,
        "expert_cap": None,
        "ssm_inner": None,
        "rec": None,
        "rec_in": None,
        "conv_io": None,
        "state": None,
        "ctx": None,
        "act_heads": None,
        "act_embed": None,
    }
)


class PartitionSpec(tuple):
    """Per dim, the mesh axis (or tuple of axes, or None) it shards over;
    trailing Nones are implicit.  A tuple, so it compares with ``==``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A placement: a :class:`PartitionSpec` on a mesh."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple:
        """One device's shard of a tensor of ``global_shape`` under this
        placement, as ``jax.sharding.NamedSharding.shard_shape``: each dim
        divided by the size of the mesh axes its spec names (raises where
        it does not divide)."""
        out = list(global_shape)
        for d, axes in enumerate(tuple(self.spec)):
            n = _axis_size(self.mesh, _present_axes(self.mesh, axes))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(global_shape)} does not split over "
                                 f"{axes!r} ({n} ways)")
            out[d] //= n
        return tuple(out)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[ShardingRules] = None
        self.batch_split: int = 1
        self.recording: Optional[list] = None  # record_collectives' list
        self.seam: str = ""  # the seam a recording rank's next collectives run


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: ShardingRules):
    """Activate a mesh + rule table for :func:`constrain`, the seams and the
    engine's shard-local planning."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def mesh_state() -> tuple:
    """The active (mesh, rules, batch split) of this thread, for
    :func:`use_mesh_state` to enter elsewhere: the autograd engine runs a
    CUDA backward, and the regions it recomputes, on a thread of its own,
    where :func:`use_mesh`'s thread-local state is not set."""
    return _CTX.mesh, _CTX.rules, _CTX.batch_split


@contextlib.contextmanager
def use_mesh_state(state: tuple):
    """Enter a :func:`mesh_state` (restoring this thread's on exit)."""
    prev = mesh_state()
    _CTX.mesh, _CTX.rules, _CTX.batch_split = state
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.batch_split = prev


def active_mesh():
    return _CTX.mesh


def active_rules() -> Optional[ShardingRules]:
    return _CTX.rules


@contextlib.contextmanager
def batch_split(factor: int):
    """Declare that the rows of the GEMMs issued inside are this rank's
    ``1 / factor`` of the logical batch (a data-sharded decode step), so the
    engine plans them with the logical batch's reduction order."""
    prev = _CTX.batch_split
    _CTX.batch_split = int(factor)
    try:
        yield
    finally:
        _CTX.batch_split = prev


def active_batch_split() -> int:
    return _CTX.batch_split


def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _present_axes(mesh, axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes the given mesh does not have, collapsing a surviving
    1-tuple to its string: the one drop rule, shared by
    :func:`logical_to_spec` and the local-shape planners."""
    if axes is None or mesh is None:
        return None
    present = set(mesh.axis_names)
    if isinstance(axes, str):
        return axes if axes in present else None
    kept = tuple(a for a in axes if a in present)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def axis_size(mesh, axes: MeshAxes) -> int:
    """Total shard count over ``axes``, ignoring axes the mesh lacks."""
    return _axis_size(mesh, _present_axes(mesh, axes))


def local_dim(dim: int, mesh, axes: MeshAxes) -> int:
    """Per-shard extent of ``dim`` sharded over ``axes``: a dim that does not
    divide the shard count stays replicated (returns ``dim``), the rule
    :func:`column_parallel_shardings` applies to the weights."""
    s = axis_size(mesh, axes)
    if s <= 1 or dim < s or dim % s:
        return dim
    return dim // s


def _resolve_partition(mesh, partition):
    if partition is not None:
        return partition
    from repro_torch.launch.mesh import gemm_partition

    return gemm_partition(mesh)


def local_gemm_shape(m: int, n: int, k: int, *, mesh, partition=None) -> tuple:
    """Per-shard (m, n, k) of a logical GEMM under a mesh partition over
    (M, N[, K]) (default: :func:`repro_torch.launch.mesh.gemm_partition`)."""
    partition = _resolve_partition(mesh, partition)
    axes = tuple(partition) + (None,) * (3 - len(tuple(partition)))
    return tuple(local_dim(d, mesh, a) for d, a in zip((m, n, k), axes[:3]))


def local_conv_shapes(x_shape, w_shape, *, mesh, partition=None,
                      spatial=None, stride: int = 1, padding: int = 0):
    """Per-shard (NHWC x, KKIO w) of a conv layer under a mesh partition:
    batch over the partition's M axes, Cout over its N axes; or, with
    ``spatial`` (a shard count, a mesh axis name or a :class:`SpatialHalo`),
    the halo-augmented H slab window each shard convolves, W pre-padded."""
    n, h, w, c = x_shape
    kh, kw, cin, cout = w_shape
    if spatial is not None:
        hs = spatial if isinstance(spatial, SpatialHalo) else plan_spatial_halo(
            h, kh, stride, padding, *spatial_shards(spatial, mesh)
        )
        return (n, hs.win, w + 2 * padding, c), w_shape
    p = tuple(_resolve_partition(mesh, partition)) + (None, None)
    batch_axes, cout_axes = p[0], p[1]
    return (
        (local_dim(n, mesh, batch_axes), h, w, c),
        (kh, kw, cin, local_dim(cout, mesh, cout_axes)),
    )


# ---------------------------------------------------------------------------
# spatial (H) sharding with halo exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpatialHalo:
    """Plan for one spatially-sharded conv / pool layer seam.

    Each of ``shards`` shards owns a contiguous H slab of the activation in
    the slab-major layout ``(S, N, lx, W, C)``: buffer row ``r`` of slab
    ``s`` holds global row ``s·lx + r`` (zero beyond the global extent).
    Before the op each shard receives ``up`` rows from the shard above and
    ``dn`` rows from the shard below, and slices its ``win``-row input
    window at ``offsets[s]`` inside the extended buffer.  Zero fill at the
    mesh edges doubles as the conv's H zero padding (``pad`` is re-applied
    to W explicitly).
    """

    shards: int
    axis: Optional[str]
    h: int
    ho: int
    lx: int
    lo: int
    win: int
    up: int
    dn: int
    offsets: tuple
    valid_out: tuple
    pad: int

    @property
    def ragged(self) -> bool:
        return any(v != self.lo for v in self.valid_out)


def spatial_shards(spatial, mesh=None) -> tuple:
    """Resolve a ``spatial=`` option to ``(shards, axis_name_or_None)``: an
    int is a plain shard count (slab-major simulation on one device), a str
    the mesh axis whose size is the shard count."""
    if isinstance(spatial, str):
        mesh = mesh if mesh is not None else _CTX.mesh
        if mesh is None or spatial not in mesh.axis_names:
            raise ValueError(
                f"spatial mesh axis {spatial!r} needs an active mesh that "
                f"has it (mesh={None if mesh is None else mesh.axis_names})"
            )
        return int(mesh.shape[spatial]), spatial
    s = int(spatial)
    if s < 1:
        raise ValueError(f"spatial shard count must be >= 1, got {s}")
    return s, None


def plan_spatial_halo(
    h: int, kh: int, stride: int, pad: int, shards: int,
    axis: Optional[str] = None, lx: Optional[int] = None,
) -> SpatialHalo:
    """Plan the halo exchange for one conv / pool seam (static ints).

    ``h`` rows arrive as ``shards`` slabs of ``lx`` buffer rows (default
    ceil-div; chained calls pass ``lx=prev.lo``).  Shard ``s`` computes
    output rows ``[s·lo, s·lo + lo)``; ``up`` / ``dn`` are the worst-case
    rows its window reaches into the neighbour slabs (``kh − stride`` at an
    aligned seam).  Raises when a slab is too thin to serve its neighbour's
    halo from one hop away.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if h < 1 or kh < 1 or stride < 1 or pad < 0:
        raise ValueError(f"bad conv geometry h={h} kh={kh} stride={stride} pad={pad}")
    ho = (h + 2 * pad - kh) // stride + 1
    if ho < 1:
        raise ValueError(f"conv produces no output rows (h={h}, kh={kh}, pad={pad})")
    lx = -(-h // shards) if lx is None else int(lx)
    if lx * shards < h:
        raise ValueError(f"slab layout lx={lx} x {shards} shards cannot hold h={h}")
    lo = -(-ho // shards)
    win = (lo - 1) * stride + kh
    up = dn = 0
    offsets, valid_out = [], []
    for s in range(shards):
        g = s * lo * stride - pad  # global row of this shard's window start
        up = max(up, s * lx - g)
        dn = max(dn, (g + win) - (s + 1) * lx)
        offsets.append(g - s * lx)  # relative to own slab start; += up below
        valid_out.append(max(0, min(lo, ho - s * lo)))
    up, dn = max(0, up), max(0, dn)
    if up > lx or dn > lx:
        raise ValueError(
            f"spatial halo needs {up}/{dn} rows from a {lx}-row neighbor "
            f"slab: h={h} is too thin for {shards} shards at kh={kh}, "
            f"stride={stride} (halo exchange is single-hop)"
        )
    return SpatialHalo(
        shards=shards, axis=axis, h=h, ho=ho, lx=lx, lo=lo, win=win,
        up=up, dn=dn, offsets=tuple(o + up for o in offsets),
        valid_out=tuple(valid_out), pad=pad,
    )


def mesh_over(axis: Optional[str]):
    """The active mesh when ``axis`` is one of its axes (each rank then holds
    its own slab; a layout-only mesh raises), else None (the one-device
    simulation)."""
    mesh = _CTX.mesh
    if axis is None or mesh is None or axis not in mesh.axis_names:
        return None
    if not mesh.has_groups:
        raise ValueError(f"spatial axis {axis!r}: the mesh {mesh} is a layout only "
                         f"(no process groups); run it under spawn_ranks")
    return mesh


def _window(ext: torch.Tensor, offsets: Sequence[int], win: int) -> torch.Tensor:
    """Each slab's ``win`` rows from its offset in the extended buffer."""
    if len(set(offsets)) == 1:
        o = offsets[0]
        return ext[:, :, o:o + win]
    rows = (torch.as_tensor(offsets, device=ext.device)[:, None]
            + torch.arange(win, device=ext.device)[None, :])
    idx = rows[:, None, :, None, None].expand(-1, ext.shape[1], -1, *ext.shape[3:])
    return torch.gather(ext, 2, idx)


def halo_exchange(v: torch.Tensor, hs: SpatialHalo) -> torch.Tensor:
    """The neighbour exchange + window select of one spatial seam:
    slab-major ``v`` -> the per-shard input windows ``(S, N, win, W, C)``.

    Only the ``up`` / ``dn`` halo rows move between shards; the mesh-edge
    shards receive zeros, which doubles as the conv's H zero padding.  On a
    mesh axis ``v`` is this rank's slab ``(1, N, lx, W, C)`` and so is the
    window returned.
    """
    mesh = mesh_over(hs.axis)
    lead = 1 if mesh is not None else hs.shards
    if v.ndim != 5 or v.shape[0] != lead or v.shape[2] != hs.lx:
        raise ValueError(f"expected slab-major (S={lead}, N, lx={hs.lx}, W, C), "
                         f"got {tuple(v.shape)}")
    if mesh is not None:
        s = mesh.coords[hs.axis]
        above, below = _exchange_rows(v, hs, mesh, s)
        parts = ([above] if hs.up else []) + [v] + ([below] if hs.dn else [])
        ext = torch.cat(parts, dim=2) if len(parts) > 1 else v
        return _window(ext, (hs.offsets[s],), hs.win)
    sidx = torch.arange(hs.shards, device=v.device).reshape(-1, 1, 1, 1, 1)
    parts = []
    if hs.up:
        above = torch.roll(v, 1, dims=0)[:, :, hs.lx - hs.up:]
        parts.append(torch.where(sidx > 0, above, torch.zeros_like(above)))
    parts.append(v)
    if hs.dn:
        below = torch.roll(v, -1, dims=0)[:, :, :hs.dn]
        parts.append(torch.where(sidx < hs.shards - 1, below, torch.zeros_like(below)))
    ext = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return _window(ext, hs.offsets, hs.win)


def mask_slab_rows(v: torch.Tensor, hs: SpatialHalo) -> torch.Tensor:
    """Zero the ragged tail shard's invalid output rows (the slab invariant:
    buffer rows beyond the global extent hold zeros, so the next seam's
    zero fill and halo reads stay exact).  On a mesh axis ``v`` is this
    rank's ``(1, N, lo, W, C)``."""
    if not hs.ragged:
        return v
    mesh = mesh_over(hs.axis)
    valid = hs.valid_out if mesh is None else (hs.valid_out[mesh.coords[hs.axis]],)
    rows = torch.arange(hs.lo, device=v.device).reshape(1, 1, -1, 1, 1)
    ok = rows < torch.as_tensor(valid, device=v.device).reshape(-1, 1, 1, 1, 1)
    return torch.where(ok, v, torch.zeros_like(v))


def constrain_slabs(v: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Keep a slab-major array's slab dim sharded over ``axis``: on a mesh
    axis this rank holds exactly its own slab, which is checked; without a
    mesh (or with ``axis`` absent from it) a no-op."""
    if mesh_over(axis) is not None and v.shape[0] != 1:
        raise ValueError(f"a rank holds one slab over {axis!r}, got {v.shape[0]}")
    return v


def spatial_halo_bytes(hs: SpatialHalo, n: int, w: int, c: int,
                       itemsize: int) -> int:
    """Modeled bytes the halo exchange moves between shards for one seam:
    every interior seam carries ``up`` rows downward and ``dn`` rows upward,
    each a full-width (N, rows, W, C) strip."""
    return (hs.shards - 1) * (hs.up + hs.dn) * n * w * c * itemsize


def spatial_gather_bytes(h: int, n: int, w: int, c: int, shards: int,
                         itemsize: int) -> int:
    """Modeled bytes of the alternative the halo exchange replaces: a ring
    all-gather of the whole (N, H, W, C) activation onto every shard before
    each conv ((S−1)/S of the tensor received per shard, S shards)."""
    return (shards - 1) * n * h * w * c * itemsize


# ---------------------------------------------------------------------------
# placement specs
# ---------------------------------------------------------------------------


def logical_to_spec(
    logical: Sequence[Optional[str]],
    *,
    mesh=None,
    rules: Optional[ShardingRules] = None,
    dim_sizes: Optional[Sequence[int]] = None,
    require_divisible: bool = False,
) -> PartitionSpec:
    """Translate logical axis names to a :class:`PartitionSpec`.  With
    ``dim_sizes``, a mapping whose dim is smaller than, or does not divide,
    the mesh axis product is dropped (replicated): the module's one drop
    rule, shared with :func:`local_dim`.  A mesh axis is used at most once
    (its leftmost use is kept).  ``require_divisible`` is accepted for the
    reference's signature; divisibility is always enforced."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if rules is None:
        return P()
    out = []
    for i, name in enumerate(logical):
        axes = rules.get(name)
        if axes is not None and mesh is not None:
            axes = _present_axes(mesh, axes)
        if axes is not None and mesh is not None and dim_sizes is not None:
            s = _axis_size(mesh, axes)
            if dim_sizes[i] < s or dim_sizes[i] % s:
                axes = None
        out.append(axes)
    seen: set = set()
    for i, axes in enumerate(out):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        kept = tuple(a for a in tup if a not in seen)
        seen.update(kept)
        if not kept:
            out[i] = None
        elif len(kept) == 1:
            out[i] = kept[0]
        else:
            out[i] = kept
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def named_sharding(mesh, rules: ShardingRules, logical: Sequence[Optional[str]],
                   dim_sizes: Optional[Sequence[int]] = None,
                   require_divisible: bool = False) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(
        logical, mesh=mesh, rules=rules, dim_sizes=dim_sizes,
        require_divisible=require_divisible))


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: None or a tuple of names / Nones."""
    return x is None or (
        isinstance(x, tuple)
        and len(x) > 0
        and all(e is None or isinstance(e, str) for e in x)
    )


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def _map_axes(fn, axes_tree, tree):
    """fn(axes_leaf, leaf) over an axes tree and a parallel tree (dicts,
    tuples, lists), axes leaves not traversed."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], tree[k]) for k in axes_tree}
    if isinstance(axes_tree, (tuple, list)):
        return _seq(axes_tree, [_map_axes(fn, a, t) for a, t in zip(axes_tree, tree)])
    raise TypeError(f"bad axes tree node {axes_tree!r}")


def _seq(like, items: list):
    """``items`` as a sequence of ``like``'s type (a NamedTuple by position)."""
    return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)


def tree_shardings(mesh, rules: ShardingRules, shapes_tree, axes_tree):
    """A :class:`NamedSharding` tree from a tree of shaped leaves (tensors,
    QTensors, anything with ``.shape``) and a parallel tree of logical-axes
    tuples (None leaf => replicated)."""

    def one(axes_leaf, shape_leaf):
        if axes_leaf is None:
            return NamedSharding(mesh, P())
        return named_sharding(mesh, rules, axes_leaf, dim_sizes=_shape(shape_leaf),
                              require_divisible=True)

    return _map_axes(one, axes_tree, shapes_tree)


def column_parallel_shardings(mesh, rules: ShardingRules, params_tree, axes_tree):
    """Param shardings that keep every GEMM contraction shard-local: each
    logical-axes leaf is masked down to its final (output / N) dim before
    it resolves against ``rules`` (wq ("embed", "qkv") becomes (None,
    "qkv")), so a parameter is only ever split along the columns it
    produces.  1-D leaves (biases, norm scales) keep their one name."""

    def one(axes_leaf, param_leaf):
        if axes_leaf is None:
            return NamedSharding(mesh, P())
        masked = (None,) * (len(axes_leaf) - 1) + (axes_leaf[-1],)
        return named_sharding(mesh, rules, masked, dim_sizes=_shape(param_leaf),
                              require_divisible=True)

    return _map_axes(one, axes_tree, params_tree)


# ---------------------------------------------------------------------------
# shard marks, slicing and gathers
# ---------------------------------------------------------------------------

_MARK = "_repro_shard"
_PARTIAL = "_repro_partial"
_PARTIAL_DTYPE = "_repro_partial_dtype"


def _raw(x):
    """The tensor of a tensor or a QTensor."""
    return getattr(x, "raw", x)


def shard_marks(x) -> tuple:
    """((dim, axis, logical size), ...) of a tensor or QTensor: its dims that
    hold one rank's shard (dims counted from the end), or ()."""
    return getattr(_raw(x), _MARK, ())


def mark_shard(x, marks: tuple):
    """Record ``marks`` (see :func:`shard_marks`) on ``x``; returns ``x``."""
    t = _raw(x)
    if marks:
        setattr(t, _MARK, tuple(marks))
    elif hasattr(t, _MARK):
        delattr(t, _MARK)
    return x


def partial_axes(x) -> tuple:
    """The mesh axes over which ``x`` is this rank's term of a sum (the
    output of a GEMM that contracted a shard on both operands), or ()."""
    return getattr(_raw(x), _PARTIAL, ())


def partial_dtype(x):
    """The dtype ``x``'s partial sum takes once reduced (``x``'s own unless
    :func:`mark_partial` named another: a kernel's f32 partial of a bf16
    product)."""
    return getattr(_raw(x), _PARTIAL_DTYPE, None) or _raw(x).dtype


def mark_partial(x, axes: tuple, dtype=None):
    """Record that ``x`` is a partial sum over ``axes`` (reduced, it is cast
    to ``dtype``, default its own); returns ``x``."""
    t = _raw(x)
    if axes:
        setattr(t, _PARTIAL, tuple(axes))
        if dtype is not None and dtype != t.dtype:
            setattr(t, _PARTIAL_DTYPE, dtype)
    else:
        for name in (_PARTIAL, _PARTIAL_DTYPE):
            if hasattr(t, name):
                delattr(t, name)
    return x


def carry_marks(src, dst):
    """``dst`` marked as ``src`` is, shards and partial sum (an elementwise
    result, a linear map of a partial sum, a view that keeps the trailing
    dims); returns ``dst``."""
    if _raw(dst) is _raw(src):
        return dst
    marks, part = shard_marks(src), partial_axes(src)
    if marks:
        mark_shard(dst, marks)
    if part:
        mark_partial(dst, part, partial_dtype(src))
    return dst


def mark_axes(x) -> tuple:
    """The mesh axes ``x``'s shard marks name, in mark order."""
    out = []
    for _, axes, _ in shard_marks(x):
        for a in ((axes,) if isinstance(axes, str) else axes):
            if a not in out:
                out.append(a)
    return tuple(out)


def axis_coord(mesh, axes: MeshAxes) -> int:
    """This rank's shard index over ``axes`` (row-major over a tuple)."""
    axes = _present_axes(mesh, axes)
    if axes is None:
        return 0
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def local_rows(n: int, mesh, axes: MeshAxes) -> tuple:
    """The (lo, hi) rows of an ``n``-row dim this rank holds when the dim
    shards over ``axes`` under the drop rule ((0, n) when it replicates)."""
    ln = local_dim(n, mesh, axes)
    if ln == n:
        return 0, n
    i = axis_coord(mesh, axes)
    return i * ln, (i + 1) * ln


def _slice(leaf, spec: PartitionSpec, mesh):
    t = _raw(leaf)
    nd = t.ndim
    # a marked dim is already this rank's shard (cut as it was drawn, or a
    # prefill's ring filled on its own slots); the others are cut here
    done = {d % nd for d, _, _ in shard_marks(leaf)}
    marks = list(shard_marks(leaf))
    for d, axes in enumerate(tuple(spec)):
        if axes is None or d in done:
            continue
        n = t.shape[d]
        lo, hi = local_rows(n, mesh, axes)
        if (lo, hi) == (0, n):
            continue
        t = t.narrow(d, lo, hi - lo)
        marks.append((d - nd, axes, n))
    if t is _raw(leaf):
        return leaf
    t = t.contiguous()
    out = type(leaf)(t, leaf.fmt) if hasattr(leaf, "fmt") else t
    return mark_shard(out, tuple(marks))


def shard_tree(tree, shardings):
    """``tree`` sliced to the calling rank's shard of each leaf, per a
    parallel :class:`NamedSharding` tree (from :func:`tree_shardings` or
    :func:`column_parallel_shardings`); sliced leaves are contiguous and
    carry their shard marks (a None sharding leaves its subtree as it is,
    and so does a leaf that already carries marks: it is a shard).  The
    mesh must have process groups."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        if not shardings.mesh.has_groups:
            raise ValueError(f"shard_tree needs a mesh with ranks, got {shardings.mesh}")
        if tree is None or (isinstance(tree, (dict, tuple, list)) and not shardings.spec):
            return tree  # a replicated subtree (a None axes leaf over it)
        return _slice(tree, shardings.spec, shardings.mesh)
    if isinstance(shardings, dict):
        return {k: shard_tree(tree[k], shardings[k]) for k in shardings}
    if isinstance(shardings, (tuple, list)):
        return _seq(shardings, [shard_tree(t, s) for t, s in zip(tree, shardings)])
    raise TypeError(f"bad shardings node {shardings!r}")


def subtree(shardings, key):
    """The shardings of ``key``'s subtree of a :class:`NamedSharding` tree:
    a replicated sharding over a whole subtree (a None axes leaf) covers
    each of its children; None stays None."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return shardings
    return shardings[key]


def unshard_leaf(leaf, sharding: NamedSharding, root: bool = False):
    """``leaf``, one rank's shard cut by ``sharding``, gathered to its
    logical shape over the axes the sharding names (unmarked; every rank
    calls it, in one order: it is a collective per sharded dim).
    ``root``: gathered onto rank 0 only (a checkpoint's writer), None on
    the other ranks."""
    mesh = sharding.mesh
    t = _raw(leaf)
    for d, axes in enumerate(tuple(sharding.spec)):
        for a in reversed(_axes_tuple(mesh, axes)):  # innermost axis first
            if t is None:
                return None  # this rank's part is on its way to rank 0
            t = _gather_many([t], [d], a, mesh, root=root)[0]
    if t is None or t is _raw(leaf):
        return None if t is None else leaf
    return type(leaf)(t, leaf.fmt) if hasattr(leaf, "fmt") else t


def _host_staged(mesh) -> bool:
    return mesh.backend == "gloo"


def _buffer(shape, dtype, device, mesh) -> torch.Tensor:
    """An empty buffer for a collective: on ``device``, or in pinned host
    memory where gloo stages a CUDA tensor (the copies to and from it then
    run at the link's rate; the caching host allocator keeps it)."""
    if _host_staged(mesh) and torch.device(device).type == "cuda":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def _recording(mesh) -> bool:
    """Whether ``mesh`` is a recording rank (``Mesh.recording``)."""
    return getattr(mesh, "is_recording", False)


def _group(mesh, axis: str):
    """The process group of this rank's line over ``axis``; None for an
    axis of size 1 (nothing to move); on a recording rank, the axis name."""
    if _recording(mesh):
        return axis if mesh.shape[axis] > 1 else None
    return mesh.groups.get(axis)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a recording rank: its kind (the reference's HLO
    name: "all-gather", "reduce-scatter", "all-reduce",
    "collective-permute"; "gather" onto one rank), the seam and pass that
    ran it ("act_gather.fwd"; "halo"), the mesh axis, the group's size and
    the bytes of its result (what ``core/roofline.py``'s ring model
    takes)."""

    kind: str
    seam: str
    axis: str
    group: int
    bytes: int


@contextlib.contextmanager
def record_collectives():
    """Yields the list that a recording rank's collectives are appended to,
    in issue order, while the block runs (:class:`Collective`)."""
    prev = (_CTX.recording, _CTX.seam)
    _CTX.recording, _CTX.seam = [], ""
    try:
        yield _CTX.recording
    finally:
        _CTX.recording, _CTX.seam = prev


def _record(kind: str, axis: str, mesh, src, result, seam: Optional[str] = None) -> None:
    """A recording rank's collective, in place of issuing it: ``src`` is
    what it would send and ``result`` what it would receive (or the
    result's bytes), both fake tensors: a real tensor raises, so no step
    computes on the zeros a recording rank returns."""
    from torch._subclasses.fake_tensor import FakeTensor

    if not isinstance(src, FakeTensor) or not isinstance(result, (FakeTensor, int)):
        raise ValueError(f"a recording rank ({mesh}) runs on fake tensors only: its "
                         f"collectives return made-up data (core/op_analysis.py)")
    if _CTX.recording is None:
        raise RuntimeError(f"a recording rank's {kind} over {axis!r} outside "
                           f"record_collectives()")
    size = result if isinstance(result, int) else result.numel() * result.element_size()
    _CTX.recording.append(Collective(kind, _CTX.seam if seam is None else seam, axis,
                                     mesh.shape[axis], size))


def _gather_many(ts: Sequence[torch.Tensor], dims: Sequence[int], axis: str,
                 mesh, root: bool = False) -> list:
    """All-gather each tensor of ``ts`` along its dim of ``dims`` over one
    mesh axis, in coordinate order, as one collective: every rank's shards
    travel as one buffer of bytes (any dtypes).  ``root``: gather onto the
    axis's coordinate 0 only; the other ranks get Nones."""
    group = _group(mesh, axis)
    if group is None:  # a size-1 axis
        return list(ts)
    n = mesh.shape[axis]
    moved = [t.movedim(d, 0).contiguous() for t, d in zip(ts, dims)]
    dev = moved[0].device
    flat = torch.cat([m.reshape(-1).view(torch.uint8) for m in moved])
    src = _staged(flat, mesh)
    if root and mesh.coords[axis] != 0:
        if _recording(mesh):
            _record("gather", axis, mesh, src, n * src.numel())
        else:
            dist.gather(src, None, dst=mesh.members[axis][0], group=group)
        return [None] * len(moved)
    whole = _buffer((n, flat.numel()), torch.uint8, dev, mesh)
    if _recording(mesh):
        _record("gather" if root else "all-gather", axis, mesh, src, whole)
    elif root:
        dist.gather(src, list(whole.unbind(0)), dst=mesh.members[axis][0], group=group)
    elif _host_staged(mesh):
        dist.all_gather(list(whole.unbind(0)), src, group=group)
    else:  # NCCL gathers straight into the one buffer (inside a CUDA graph too)
        dist.all_gather_into_tensor(whole, src, group=group)
    whole = whole.to(dev)
    out, off = [], 0
    for m, d in zip(moved, dims):
        nb = m.numel() * m.element_size()
        piece = whole[:, off:off + nb].contiguous().view(m.dtype)
        out.append(piece.reshape(n * m.shape[0], *m.shape[1:]).movedim(0, d).contiguous())
        off += nb
    return out  # the kernels read dense operands


def gather(x, dim: int, axes: MeshAxes, mesh=None):
    """All-gather a tensor or QTensor along ``dim`` over ``axes`` (a tuple
    is gathered innermost axis first, the inverse of :func:`local_rows`);
    the result carries ``x``'s other marks.  Both go through the
    activation seam (autograd: the backward reduce-scatters the gradient;
    a QTensor's raws carry none)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("gather: no active mesh (run the step under use_mesh)")
    axes = _present_axes(mesh, axes)
    if axes is None:
        return x
    t = _raw(x)
    d = dim % t.ndim
    marks = tuple(mk for mk in shard_marks(x) if mk[0] % t.ndim != d)
    live = _axes_tuple(mesh, axes)
    if live:
        t = _AllGather.apply("act_gather", (d,), live, mesh, t)[0]
    out = type(x)(t, x.fmt) if hasattr(x, "fmt") and t is not _raw(x) else (
        x if t is _raw(x) else t)
    return mark_shard(out, marks)


def take_shard(x, dim: int, axes: MeshAxes, mesh=None):
    """A whole tensor cut to this rank's shard of ``dim`` over ``axes`` (the
    drop rule: a dim that does not divide stays whole) and marked: the seam
    that puts a whole activation onto the rules' shard.  Autograd's
    backward of the cut is the zero-padded gradient (the rank's part)."""
    mesh = mesh or _CTX.mesh
    nd = x.ndim
    d = dim % nd
    n = x.shape[d]
    lo, hi = local_rows(n, mesh, axes)
    if (lo, hi) == (0, n):
        return x
    _count("act_slice", "fwd", _axes_tuple(mesh, axes))
    out = x.narrow(d, lo, hi - lo)
    marks = tuple(mk for mk in shard_marks(x) if mk[0] % nd != d) + ((d - nd, axes, n),)
    return mark_shard(out, marks)


def seq_parallel_axes(mesh=None, rules: Optional[ShardingRules] = None) -> tuple:
    """The mesh axes, of size above 1 and not a batch axis, over which the
    rules shard the residual stream's sequence (``seq_act``): the axes on
    which :func:`constrain` cuts a whole activation onto its shard.  () under
    column-parallel decode rules and on a training mesh whose "model" is 1."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return ()
    batch = set(batch_axes(mesh, rules))
    return tuple(a for a in _axes_tuple(mesh, rules.get("seq_act")) if a not in batch)


def loss_axes(mesh=None, rules: Optional[ShardingRules] = None) -> tuple:
    """The mesh axes a rank's loss is a part over: the batch axes, then the
    sequence-parallel ones (:func:`seq_parallel_axes`)."""
    return batch_axes(mesh, rules) + seq_parallel_axes(mesh, rules)


def constrain(x, *logical: Optional[str]):
    """The seam between GEMMs: resolve the marks of ``x`` against the spec
    the active rules give ``logical`` (the drop rule at the logical sizes,
    each mesh axis used once, leftmost first).  In order: a partial sum is
    reduce-scattered onto the dim the rules shard over its axis, or
    all-reduced where no dim takes it; a marked dim the rules do not shard
    so is all-gathered; under sequence-parallel rules a whole dim the rules
    shard over a sequence-parallel axis is cut to this rank's shard.  The
    batch axes are the data pipeline's: a rank's rows stay its own.  No-op
    without a mesh."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return x
    cut = seq_parallel_axes()
    if not (shard_marks(x) or partial_axes(x) or cut):
        return x
    nd = _raw(x).ndim
    if len(logical) != nd:
        raise ValueError(f"constrain: {len(logical)} logical names for a {nd}-d tensor")
    sizes = list(_raw(x).shape)
    for d, _, full in shard_marks(x):
        sizes[d] = full
    spec = tuple(logical_to_spec(logical, dim_sizes=sizes)) + (None,) * nd
    batch = set(batch_axes())
    want = [tuple(a for a in _axes_tuple(mesh, spec[d]) if a not in batch)
            for d in range(nd)]
    for a in partial_axes(x):
        marked = {d % nd for d, _, _ in shard_marks(x)}
        onto = [d for d in range(nd) if want[d] == (a,) and d not in marked]
        x = _scatter_partial(x, onto[0], a) if onto else _reduce_partial(x, (a,))
    for d, axes, _ in shard_marks(x):
        if _present_axes(mesh, spec[d % nd]) != _present_axes(mesh, axes):
            x = gather(x, d, axes)
    if cut:
        marked = {d % nd for d, _, _ in shard_marks(x)}
        for d in range(nd):
            if want[d] and d not in marked and set(want[d]) <= set(cut):
                x = take_shard(x, d, want[d][0] if len(want[d]) == 1 else want[d])
    return x


def replicated(x, dims: Optional[Sequence[int]] = None):
    """``x`` with every marked dim gathered (the whole logical tensor), or
    only the marked dims among ``dims`` (counted from the end)."""
    for d, axes, _ in shard_marks(x):
        if dims is None or d in dims:
            x = gather(x, d, axes)
    return x


def split_last(x, n: int, *logical: Optional[str]):
    """``x`` (..., n·k) split into (..., n, k) groups (heads) through the seam
    ``logical`` names for the split view: a column shard of whole groups
    stays this rank's groups when the rules shard the group dim over its
    axis at the group count ``n`` (the drop rule sees ``n``, not n·k);
    otherwise (half a group a rank, or groups the rules keep whole) the
    columns are gathered first."""
    nd = x.ndim
    last = [mk for mk in shard_marks(x) if mk[0] % nd == nd - 1]
    if last and _CTX.mesh is not None:
        _, axes, full = last[0]
        k = full // n
        sizes = list(x.shape[:-1]) + [n, k]
        for d, _, size in shard_marks(x):
            if d % nd != nd - 1:
                sizes[d % nd] = size
        spec = tuple(logical_to_spec(logical, dim_sizes=sizes)) + (None,) * (nd + 1)
        if _present_axes(_CTX.mesh, spec[nd - 1]) == _present_axes(_CTX.mesh, axes) \
                and x.shape[-1] % k == 0:
            y = x.reshape(*x.shape[:-1], x.shape[-1] // k, k)
            marks = tuple((-2, a, n) if d % nd == nd - 1 else (d - 1, a, size)
                          for d, a, size in shard_marks(x))
            return mark_shard(y, marks)
        x = gather(x, -1, axes)
    y = x.reshape(*x.shape[:-1], n, x.shape[-1] // n)
    marks = tuple((d - 1, a, size) for d, a, size in shard_marks(x))
    return constrain(mark_shard(y, marks), *logical)


def merge_last(x):
    """The inverse of :func:`split_last`: (..., n, k) -> (..., n·k), a group
    dim's mark carried onto the merged columns."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    k = x.shape[-1]
    marks = tuple((-1, a, size * k) if d % x.ndim == x.ndim - 2 else (d + 1, a, size)
                  for d, a, size in shard_marks(x) if d % x.ndim != x.ndim - 1)
    return mark_shard(y, marks)


def embedding_lookup(table, ids):
    """``table[ids]``; on a rank that holds a vocab shard of the table (its
    dim 0 marked), the masked lookup of this rank's vocab range, marked a
    partial sum over the vocab's axes: each position has exactly one
    non-zero term, so the summed lookup equals the whole table's.  A table
    cut along its embedding dim (``embed`` over a mesh axis) gives rows
    marked on their last dim, gathered by the seam that reads them."""
    vocab = [mk for mk in shard_marks(table) if mk[0] % table.ndim == 0]
    if not vocab or _CTX.mesh is None:
        cols = tuple((-1, a, n) for d, a, n in shard_marks(table) if d % table.ndim == 1)
        return mark_shard(table[ids], cols)
    _, axes, full = vocab[0]
    lo, hi = local_rows(full, _CTX.mesh, axes)
    local = ids - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    out = rows * inside[..., None].to(rows.dtype)
    return mark_partial(out, _axes_tuple(_CTX.mesh, axes))


def _exchange_rows(v: torch.Tensor, hs: SpatialHalo, mesh, s: int) -> tuple:
    """One rank's halo receive: (the ``up`` rows of the slab above, the
    ``dn`` rows of the slab below), zeros at the mesh edges; sends its own
    last ``up`` rows down the axis and first ``dn`` rows up it."""
    members = mesh.members[hs.axis]
    group = _group(mesh, hs.axis)
    stage = _host_staged(mesh) and v.device.type == "cuda"
    where = torch.device("cpu") if stage else v.device

    def send_recv(rows_out, to, frm, rows):
        want = list(v.shape)
        want[2] = rows
        recv = torch.zeros(want, dtype=v.dtype, device=where)
        if _recording(mesh):
            if to is not None or frm is not None:  # each rank's halo rows, one step
                _record("collective-permute", hs.axis, mesh, rows_out, recv, seam="halo")
            return recv
        ops = []
        if to is not None:
            send = rows_out.to(where).contiguous()  # only the halo rows move
            ops.append(dist.P2POp(dist.isend, send.view(torch.uint8).reshape(-1),
                                  members[to], group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv.view(torch.uint8).reshape(-1),
                                  members[frm], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv.to(v.device)

    last = hs.shards - 1
    above = below = None
    if hs.up:
        above = send_recv(v[:, :, hs.lx - hs.up:], s + 1 if s < last else None,
                          s - 1 if s > 0 else None, hs.up)
    if hs.dn:
        below = send_recv(v[:, :, :hs.dn], s - 1 if s > 0 else None,
                          s + 1 if s < last else None, hs.dn)
    return above, below


# ---------------------------------------------------------------------------
# training seams: data-parallel, FSDP, pod x data (HSDP) and tensor-parallel
# training with sequence-parallel activations
# ---------------------------------------------------------------------------


def _axes_tuple(mesh, axes: MeshAxes) -> tuple:
    """``axes`` as a tuple of the mesh's axes that it names and whose size
    exceeds 1 (the axes a collective over ``axes`` has to cross)."""
    axes = _present_axes(mesh, axes)
    if axes is None:
        return ()
    return tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if mesh.shape[a] > 1)


def batch_axes(mesh=None, rules: Optional[ShardingRules] = None) -> tuple:
    """The mesh axes, of size above 1, that the rules' "batch" shards over
    (the active mesh and rules by default; () without them)."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return ()
    return _axes_tuple(mesh, rules.get("batch"))


def split_batch_axes() -> tuple:
    """The active batch axes when this rank's rows are a part of the logical
    batch (a :func:`batch_split` above 1), else (): where a global mean
    needs its count summed across ranks."""
    if _CTX.mesh is None or _CTX.batch_split <= 1:
        return ()
    return batch_axes()


def microbatch_rows(n: int, accum: int, mesh, axes: MeshAxes) -> list:
    """The rows of an ``n``-row batch that this rank holds when the batch
    runs as ``accum`` microbatches (its rows split in order) and each
    microbatch shards over ``axes``: this rank's rows of microbatch 0, then
    of microbatch 1, and so on.  Split in order again, a rank's rows give it
    its part of each of the logical microbatches.  Raises when a
    microbatch does not split evenly over the shards (training would count
    a replicated row once on every rank)."""
    shards = axis_size(mesh, axes)
    if n % accum or (n // accum) % shards:
        raise ValueError(f"a batch of {n} rows in {accum} microbatches does not split "
                         f"over the {shards} shards of {axes!r}: want rows a multiple of "
                         f"{accum * shards}")
    mb = n // accum
    lo, hi = local_rows(mb, mesh, axes) if shards > 1 else (0, mb)
    return [i * mb + r for i in range(accum) for r in range(lo, hi)]


def _staged(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where the mesh's backend takes it: a pinned host copy under
    gloo."""
    if not (_host_staged(mesh) and t.device.type == "cuda"):
        return t
    buf = _buffer(t.shape, t.dtype, t.device, mesh)
    buf.copy_(t)
    return buf


def _all_reduce_f32(t: torch.Tensor, axes: tuple, mesh, op=None) -> torch.Tensor:
    """The sum of ``t`` over ``axes`` (one all-reduce an axis), in f32, on
    ``t``'s device; ``op`` another reduction (``dist.ReduceOp.MAX``)."""
    if not axes:
        return t.to(torch.float32)
    buf = _staged(t.to(torch.float32), mesh).contiguous()
    if buf is t:
        buf = buf.clone()
    for a in axes:
        if _recording(mesh):
            _record("all-reduce", a, mesh, buf, buf)
        elif op is None:
            dist.all_reduce(buf, group=mesh.groups[a])
        else:
            dist.all_reduce(buf, op=op, group=mesh.groups[a])
    return buf.to(t.device)


def ring_owner(slot: torch.Tensor, c: int, mesh, axes: MeshAxes) -> torch.Tensor:
    """The shard index over ``axes`` of the rank that holds ring slot
    ``slot`` (slot = pos % ``c``, a tensor) of a ``c``-slot ring whose
    sequence shards over ``axes`` (``seq_kv``: a rank holds the slots
    :func:`local_rows` gives it); 0 where the ring is whole (the drop rule).
    A position is written only by its owner."""
    lo, hi = local_rows(c, mesh, axes)
    if (lo, hi) == (0, c):
        return torch.zeros_like(slot)
    return torch.div(slot, hi - lo, rounding_mode="floor")


def softmax_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, axes: MeshAxes,
                    mesh=None) -> torch.Tensor:
    """The softmax-weighted sum of rows split over the ranks of ``axes``
    (flash-decoding's merge): each rank gives its row maxima ``m`` (-1e30
    where it holds no unmasked entry), its denominators ``l`` (sum of
    exp(s - m) over its unmasked entries, 0 where none) and its unnormalised
    accumulators ``acc`` (``l``'s shape + (D,)), in f32.  One all-reduce max
    of ``m``, a rescale by exp(m - max) (0 for a rank whose entries are all
    masked, never NaN), one all-reduce sum of (``l``, ``acc``) packed in one
    buffer; returns acc / max(l, 1e-30) in f32.  Counted in
    :data:`SEAM_COUNTS` as ("kv_max", "fwd") and ("kv_sum", "fwd") an axis."""
    mesh = mesh or _CTX.mesh
    live = () if mesh is None else _axes_tuple(mesh, axes)
    m, l, acc = (t.to(torch.float32) for t in (m, l, acc))
    if live:
        _count("kv_max", "fwd", live)
        top = _all_reduce_f32(m, live, mesh, op=dist.ReduceOp.MAX)
        scale = torch.exp(m - top)
        packed = torch.cat([(l * scale).reshape(-1), (acc * scale[..., None]).reshape(-1)])
        _count("kv_sum", "fwd", live)
        packed = _all_reduce_f32(packed, live, mesh)
        l, acc = packed[:l.numel()].view(l.shape), packed[l.numel():].view(acc.shape)
    return acc / torch.clamp(l, min=1e-30)[..., None]


#: the reduce-scatter collective (gloo and NCCL): ``reduce_scatter_single``
#: where torch has it (2.13, which deprecates the older name), else
#: ``reduce_scatter_tensor`` (2.11)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _reduce_scatter_many(gs: Sequence[torch.Tensor], dims: Sequence[int], axis: str,
                         mesh) -> list:
    """Sum each tensor of ``gs`` (f32) over one mesh axis and keep this
    rank's slice of its dim of ``dims`` (coordinate order, the inverse of
    :func:`_gather_many`), as one collective: rank r's input row holds the
    r-th slice of every tensor."""
    group = _group(mesh, axis)
    if group is None:
        return list(gs)
    n = mesh.shape[axis]
    moved = [g.movedim(d, 0) for g, d in zip(gs, dims)]
    for m in moved:
        if m.shape[0] % n:
            raise ValueError(f"reduce-scatter of {m.shape[0]} rows over {n} shards")
    parts = [m.reshape(n, -1) for m in moved]
    src = _staged(torch.cat(parts, dim=1).reshape(-1), mesh)
    dev = gs[0].device
    out = _buffer((src.numel() // n,), src.dtype, dev, mesh)
    if _recording(mesh):
        _record("reduce-scatter", axis, mesh, src, out)
    else:
        _reduce_scatter(out, src, group=group)
    out = out.to(dev)
    pieces = out.split([p.shape[1] for p in parts])
    return [piece.view(m.shape[0] // n, *m.shape[1:]).movedim(0, d).contiguous()
            for piece, m, d in zip(pieces, moved, dims)]


#: the collectives the seams ran, by (seam, pass, mesh axis): seams
#: "act_gather" (an activation all-gathered), "act_scatter" (a partial sum
#: reduce-scattered onto a shard), "act_all_reduce", "act_slice" (a whole
#: activation cut to its shard: no collective), "param_gather" (a weight's
#: shards gathered at the point of use), "grad_all_reduce", "psum"; pass
#: "fwd" or "bwd" (an all-gather's backward is a reduce-scatter, and so on);
#: a decode step over a sequence-sharded ring adds "kv_max" and "kv_sum"
#: (:func:`softmax_combine`'s two all-reduces)
SEAM_COUNTS: collections.Counter = collections.Counter()

#: the collective each (seam, pass) runs (act_slice runs none)
_COLLECTIVE = {("act_gather", "fwd"): "all_gather", ("act_gather", "bwd"): "reduce_scatter",
               ("param_gather", "fwd"): "all_gather",
               ("param_gather", "bwd"): "reduce_scatter",
               ("act_scatter", "fwd"): "reduce_scatter", ("act_scatter", "bwd"): "all_gather",
               ("act_all_reduce", "fwd"): "all_reduce", ("act_all_reduce", "bwd"): "all_reduce",
               ("grad_all_reduce", "fwd"): "all_reduce", ("psum", "fwd"): "all_reduce",
               ("kv_max", "fwd"): "all_reduce", ("kv_sum", "fwd"): "all_reduce"}


def _count(seam: str, phase: str, axes: tuple) -> None:
    for a in axes:
        SEAM_COUNTS[(seam, phase, a)] += 1
    if _CTX.recording is not None:
        _CTX.seam = f"{seam}.{phase}"  # names the collectives that follow


def collective_counts(counts=None) -> dict:
    """{collective kind: {mesh axis: count}} of :data:`SEAM_COUNTS` (or of
    ``counts``): all-gathers, reduce-scatters and all-reduces, forward and
    backward together."""
    out: dict = {}
    for (seam, phase, axis), n in (counts or SEAM_COUNTS).items():
        kind = _COLLECTIVE.get((seam, phase))
        if kind is not None and n:
            out.setdefault(kind, {})
            out[kind][axis] = out[kind].get(axis, 0) + n
    return out


class _AllGather(torch.autograd.Function):
    """All-gather shards over mesh axes (innermost first), one collective an
    axis for all of them; the backward sums each whole tensor's gradient
    over the same axes in f32 and keeps this rank's shard of it (outermost
    first), in the shard's dtype.  ``seam`` names it in
    :data:`SEAM_COUNTS`."""

    @staticmethod
    def forward(ctx, seam: str, dims: tuple, axes: tuple, mesh, *shards):
        ctx.seam, ctx.dims, ctx.axes, ctx.mesh = seam, dims, axes, mesh
        _count(seam, "fwd", axes)
        ts = list(shards)
        for a in reversed(axes):
            ts = _gather_many(ts, dims, a, mesh)
        return tuple(ts)

    @staticmethod
    def backward(ctx, *grads):
        _count(ctx.seam, "bwd", ctx.axes)
        gs = [g.to(torch.float32) for g in grads]
        for a in ctx.axes:
            gs = _reduce_scatter_many(gs, ctx.dims, a, ctx.mesh)
        return (None, None, None, None, *(g.to(w.dtype) for g, w in zip(gs, grads)))


class _ReduceScatter(torch.autograd.Function):
    """A partial sum summed over mesh axes in f32 (outermost first), this
    rank's slice of ``dim`` kept, in the input's dtype; the backward
    all-gathers the gradient (innermost first)."""

    @staticmethod
    def forward(ctx, dim: int, axes: tuple, mesh, x):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        _count("act_scatter", "fwd", axes)
        g = x.to(torch.float32)
        for a in axes:
            g = _reduce_scatter_many([g], [dim], a, mesh)[0]
        return g.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        _count("act_scatter", "bwd", ctx.axes)
        gs = [grad.contiguous()]
        for a in reversed(ctx.axes):
            gs = _gather_many(gs, [ctx.dim], a, ctx.mesh)
        return None, None, None, gs[0]


class _AllReduce(torch.autograd.Function):
    """A partial sum summed over mesh axes in f32, whole on every rank, in
    the input's dtype; the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, axes: tuple, mesh, x):
        ctx.axes, ctx.mesh = axes, mesh
        _count("act_all_reduce", "fwd", axes)
        return _all_reduce_f32(x, axes, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        _count("act_all_reduce", "bwd", ctx.axes)
        return None, None, _all_reduce_f32(grad, ctx.axes, ctx.mesh).to(grad.dtype)


def _scatter_partial(x, dim: int, axis: str):
    """The partial sum ``x`` reduce-scattered over ``axis`` onto ``dim`` (a
    shard mark there; its other partial axes kept)."""
    mesh = _CTX.mesh
    nd = x.ndim
    d = dim % nd
    n = x.shape[d]
    out = _ReduceScatter.apply(d, _axes_tuple(mesh, axis), mesh, x)
    rest = tuple(a for a in partial_axes(x) if a != axis)
    out = out if rest else out.to(partial_dtype(x))  # summed whole: its own dtype
    mark_partial(out, rest, partial_dtype(x))
    return mark_shard(out, shard_marks(x) + ((d - nd, axis, n),))


def _reduce_partial(x, axes: tuple, mesh=None):
    """The partial sum ``x`` all-reduced over ``axes`` (its marks kept; in
    f32, then in the dtype :func:`partial_dtype` names once no partial axis
    is left)."""
    mesh = mesh or _CTX.mesh
    out = _AllReduce.apply(_axes_tuple(mesh, axes), mesh, x)
    rest = tuple(a for a in partial_axes(x) if a not in axes)
    out = out if rest else out.to(partial_dtype(x))
    mark_partial(out, rest, partial_dtype(x))
    return mark_shard(out, shard_marks(x))


def _fsdp_gather_many(shards: list, dims: list, axes: MeshAxes, mesh) -> list:
    """:func:`fsdp_gather` of several shards over the same ``axes``, one
    collective an axis each way; each result keeps its shard's other
    marks."""
    live = _axes_tuple(mesh, axes)
    dims = [d % t.ndim for t, d in zip(shards, dims)]
    marks = [tuple(mk for mk in shard_marks(t) if mk[0] % t.ndim != d)
             for t, d in zip(shards, dims)]
    if not live:
        return list(shards)
    out = _AllGather.apply("param_gather", tuple(dims), live, mesh, *shards)
    return [mark_shard(t, m) for t, m in zip(out, marks)]


def fsdp_gather(shard: torch.Tensor, dim: int, axes: MeshAxes, mesh=None) -> torch.Tensor:
    """The whole tensor of ``shard`` along ``dim`` over ``axes``, as an
    autograd seam: its backward reduce-scatters (sums) the gradient back to
    this rank's shard.  The result keeps ``shard``'s other marks."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("fsdp_gather: no active mesh (run the step under use_mesh)")
    return _fsdp_gather_many([shard], [dim], axes, mesh)[0]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _seq(tree, [_map_leaves(fn, v) for v in tree])
    return None if tree is None else fn(tree)


def gather_fsdp(tree):
    """``tree`` (a layer's parameters, or one of them) with every dim whose
    shard marks name a batch axis of the active rules gathered through
    :func:`fsdp_gather`: the FSDP shards (``TRAIN_RULES``' "embed" over
    "data"), the leaves of one set of axes in one collective.  Called where
    the parameters are used, inside a recomputed region, so a gathered
    weight lives only there.  Dims sharded over other axes (the tensor
    parallelism of "model") stay as they are; no-op without a mesh."""
    return gather_params(tree, batch_axes())


def gather_params(tree, axes: Optional[tuple] = None):
    """``tree`` with every dim whose shard marks name one of ``axes`` (every
    marked axis when None) gathered through :func:`fsdp_gather`, the leaves
    of one set of axes in one collective (backward: the reduce-scatter)."""
    if _CTX.mesh is None:
        return tree
    axes = None if axes is None else set(axes)
    if axes is not None and not axes:
        return tree
    leaves = []
    _map_leaves(leaves.append, tree)

    def dim_to_gather(x):
        return next(((d, a) for d, a, _ in shard_marks(x)
                     if axes is None or axes & set((a,) if isinstance(a, str) else a)),
                    None)

    while True:  # a leaf with two such dims goes round twice
        todo = {}
        for i, x in enumerate(leaves):
            found = dim_to_gather(x)
            if found is not None:
                todo.setdefault(found[1], []).append((i, found[0]))
        if not todo:
            break
        for a, items in todo.items():
            got = _fsdp_gather_many([leaves[i] for i, _ in items], [d for _, d in items],
                                    a, _CTX.mesh)
            for (i, _), t in zip(items, got):
                leaves[i] = t
    it = iter(leaves)
    return _map_leaves(lambda _: next(it), tree)


#: f32 bytes a bucket of :func:`grad_all_reduce` holds (one collective each)
_BUCKET_BYTES = 1 << 28


def grad_all_reduce(tree, axes: MeshAxes, mesh=None):
    """A gradient tree with each leaf summed, in f32, over the axes of
    ``axes`` (the loss's axes, :func:`loss_axes`) that its shard marks do
    not name: the leaves those axes replicate (every leaf under data
    parallelism; the norms, the biases and the "pod" axis under FSDP; under
    tensor parallelism every leaf "model" replicates: the norm scales, the
    router, an SSD's ``A_log`` / ``D`` / ``dt_bias``, each rank's grad a part
    computed from its shard of the sequence or of the work).  A leaf's
    gathered dims were summed already, by :func:`fsdp_gather`'s backward.
    Leaves go in buckets of like axes, one collective an axis each; each
    comes back in its dtype, marks kept."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return tree
    want = _axes_tuple(mesh, axes)
    if not want:
        return tree
    leaves = []
    _map_leaves(leaves.append, tree)
    plan = {}
    for i, g in enumerate(leaves):
        red = tuple(a for a in want if a not in mark_axes(g))
        if red:
            plan.setdefault(red, []).append(i)
    out = list(leaves)
    for red, idx in plan.items():
        bucket, size = [], 0
        for n, i in enumerate(idx):
            bucket.append(i)
            size += 4 * leaves[i].numel()
            if size >= _BUCKET_BYTES or n == len(idx) - 1:
                flat = torch.cat([leaves[j].reshape(-1).to(torch.float32) for j in bucket])
                _count("grad_all_reduce", "fwd", red)
                flat = _all_reduce_f32(flat, red, mesh)
                for j, part in zip(bucket, flat.split([leaves[j].numel() for j in bucket])):
                    g = leaves[j]
                    out[j] = carry_marks(g, part.view(g.shape).to(g.dtype))
                bucket, size = [], 0
    it = iter(out)
    return _map_leaves(lambda _: next(it), tree)


def psum(t: torch.Tensor, axes: MeshAxes, mesh=None) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, in f32, with no gradient: a count or
    a metric that every rank then holds whole."""
    mesh = mesh or _CTX.mesh
    live = () if mesh is None else _axes_tuple(mesh, axes)
    _count("psum", "fwd", live)
    return _all_reduce_f32(t.detach(), live, mesh)
