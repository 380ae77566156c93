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
  over which axis, and their logical size.  :func:`constrain` reads it: it
  all-gathers the marked dims that the active rules replicate and keeps the
  others, and is a no-op without a mesh.  The engine gathers a marked
  contraction dim before a GEMM whose weight holds that dim whole, so every
  contraction stays shard-local (column-parallel decode, ``DECODE_RULES``).
* **Spatial seams.** :func:`halo_exchange` and :func:`mask_slab_rows` take
  the slab-major layout ``(S, N, lx, W, C)``.  With ``axis=None`` they run
  the reference's slab-major simulation on one device (``torch.roll`` and
  the edge mask); over a mesh axis each rank holds its own slab
  ``(1, N, lx, W, C)`` and sends only its ``up`` / ``dn`` rows to its
  neighbours, with zeros at the mesh edges.

Under ``gloo`` the collectives stage CUDA tensors through the host (gloo
takes no CUDA tensor for send / recv); every collective moves bytes, so
int16 raws and bf16 go through unchanged.
"""
from __future__ import annotations

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
    "axis_coord",
    "local_rows",
    "batch_split",
    "active_batch_split",
    "mesh_over",
]

MeshAxes = Union[str, tuple, None]


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


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[ShardingRules] = None
        self.batch_split: int = 1


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
        return type(axes_tree)(_map_axes(fn, a, t) for a, t in zip(axes_tree, tree))
    raise TypeError(f"bad axes tree node {axes_tree!r}")


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


def carry_marks(src, dst):
    """``dst`` marked as ``src`` is (an elementwise result, a view that
    keeps the trailing dims); returns ``dst``."""
    marks = shard_marks(src)
    if marks and _raw(dst) is not _raw(src):
        mark_shard(dst, marks)
    return dst


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
    marks = []
    t = _raw(leaf)
    nd = t.ndim
    for d, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        n = t.shape[d]
        lo, hi = local_rows(n, mesh, axes)
        if (lo, hi) == (0, n):
            continue
        t = t.narrow(d, lo, hi - lo)
        marks.append((d - nd, axes, n))
    t = t.contiguous()
    out = type(leaf)(t, leaf.fmt) if t is not _raw(leaf) and hasattr(leaf, "fmt") else (
        leaf if t is _raw(leaf) else t)
    return mark_shard(out, tuple(marks))


def shard_tree(tree, shardings):
    """``tree`` sliced to the calling rank's shard of each leaf, per a
    parallel :class:`NamedSharding` tree (from :func:`tree_shardings` or
    :func:`column_parallel_shardings`); sliced leaves are contiguous and
    carry their shard marks (a None sharding leaves its subtree as it is).
    The mesh must have process groups."""
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
        return type(shardings)(shard_tree(t, s) for t, s in zip(tree, shardings))
    raise TypeError(f"bad shardings node {shardings!r}")


def _host_staged(mesh) -> bool:
    return mesh.backend == "gloo"


def _gather_one(t: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """All-gather ``t`` along ``dim`` over one mesh axis, in coordinate order."""
    group = mesh.groups.get(axis)
    if group is None:  # a size-1 axis
        return t
    n = mesh.shape[axis]
    moved = t.movedim(dim, 0).contiguous()
    dev = moved.device
    src = moved.cpu() if _host_staged(mesh) and dev.type == "cuda" else moved
    flat = src.reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(bufs, flat, group=group)
    parts = [b.view(src.dtype).reshape(src.shape) for b in bufs]
    out = torch.cat(parts, dim=0).to(dev)
    return out.movedim(0, dim).contiguous()  # the kernels read dense operands


def gather(x, dim: int, axes: MeshAxes, mesh=None):
    """All-gather a tensor or QTensor along ``dim`` over ``axes`` (a tuple
    is gathered innermost axis first, the inverse of :func:`local_rows`);
    the result carries ``x``'s other marks."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("gather: no active mesh (run the step under use_mesh)")
    axes = _present_axes(mesh, axes)
    if axes is None:
        return x
    t = _raw(x)
    d = dim % t.ndim
    marks = tuple(mk for mk in shard_marks(x) if mk[0] % t.ndim != d)
    for a in reversed((axes,) if isinstance(axes, str) else axes):
        t = _gather_one(t, d, a, mesh)
    out = type(x)(t, x.fmt) if hasattr(x, "fmt") else t
    return mark_shard(out, marks)


def constrain(x, *logical: Optional[str]):
    """The seam between GEMMs: all-gather the dims of ``x`` that hold a
    shard (its marks) where the active rules replicate them; dims the rules
    shard over the same axes stay as they are.  No-op without a mesh."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    marks = shard_marks(x)
    if not marks:
        return x
    nd = _raw(x).ndim
    if len(logical) != nd:
        raise ValueError(f"constrain: {len(logical)} logical names for a {nd}-d tensor")
    sizes = list(_raw(x).shape)
    for d, _, full in marks:
        sizes[d] = full
    spec = tuple(logical_to_spec(logical, dim_sizes=sizes)) + (None,) * nd
    for d, axes, _ in marks:
        if _present_axes(_CTX.mesh, spec[d % nd]) != _present_axes(_CTX.mesh, axes):
            x = gather(x, d, axes)
    return x


def replicated(x):
    """``x`` with every marked dim gathered (the whole logical tensor)."""
    for d, axes, _ in shard_marks(x):
        x = gather(x, d, axes)
    return x


def _exchange_rows(v: torch.Tensor, hs: SpatialHalo, mesh, s: int) -> tuple:
    """One rank's halo receive: (the ``up`` rows of the slab above, the
    ``dn`` rows of the slab below), zeros at the mesh edges; sends its own
    last ``up`` rows down the axis and first ``dn`` rows up it."""
    members = mesh.members[hs.axis]
    group = mesh.groups[hs.axis]
    stage = _host_staged(mesh) and v.device.type == "cuda"
    where = torch.device("cpu") if stage else v.device

    def send_recv(rows_out, to, frm, rows):
        want = list(v.shape)
        want[2] = rows
        recv = torch.zeros(want, dtype=v.dtype, device=where)
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
