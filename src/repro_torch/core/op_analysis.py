"""Op-level step analyzer: one rank's flops, bytes and collectives, counted
on fake tensors (no card, no compile, no process group).

The port's counterpart of ``repro.core.hlo_analysis``.  The reference walks
the compiled HLO of a jitted step; the port has no HLO, so
:func:`analyze_step` runs the step itself, eagerly, under
``FakeTensorMode`` (shapes and dtypes, no storage) and a dispatch mode that
sees every aten op, the backward's included:

  * **flops** — matmul-class ops only (mm, addmm, bmm, baddbmm,
    convolution, the fused attention ops), by ``torch.utils.flop_counter``'s
    formulas: 2 x result elements x contracted elements.  Elementwise flops
    are ignored, as the reference ignores them.
  * **bytes** — per materializing op: operand bytes + result bytes (an
    operand broadcast by a zero stride counts its stored elements once).
    Views (view, reshape of a contiguous tensor, expand, permute,
    transpose, slice, select, alias, detach) and empty allocations count
    nothing.  An in-place write into a slice (``index_copy_``,
    ``index_put_``: a cache update) counts twice the update's bytes, and a
    gather (indexing, ``embedding``, ``index_select``) twice its result's,
    the reference's ``dynamic-update-slice`` and ``gather`` rules.  The
    bytes are those of the aten ops as eager PyTorch runs them, unfused: an
    upper estimate of the HBM traffic of the ``torch`` template, where the
    reference counts XLA's fused ops.
  * **collectives** — what the step would issue on a recording rank
    (``launch/mesh.py:Mesh.recording``, ``parallel/sharding.py``): kind,
    seam, mesh axis, group size and result bytes; wire bytes by
    ``core/roofline.py``'s ring model.

Bytes are kept by aten op (``bytes_by_kind``) and by group
(``bytes_by_group``): "gemm", "attention" (the score / value math of
``models/attention.py``), "norm", "softmax", "rope", "elementwise",
"copy" and "other".  A forward op's group is that of the model function
it runs in; a backward op takes the group of the forward op whose
gradient it computes.

The reference's while-loop trip counts have no counterpart (eager code
runs every layer), nor do its static collective counts or its shadow-bf16
pass.  The step runs on the ``torch`` template: the ``cuda`` and ``q16``
templates launch kernels through ``ctypes``, which fake tensors cannot
reach, so :func:`analyze_step` refuses them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import sys
import threading
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_map

from repro_torch.core.roofline import collective_stats, wire_bytes
from repro_torch.parallel import sharding as sh

__all__ = ["OpStats", "analyze_step", "GROUPS"]

GROUPS = ("gemm", "attention", "norm", "softmax", "rope", "elementwise", "copy", "other")

#: aten ops that alias their input without being marked a view
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh", "lift_fresh_copy"}
#: allocations that neither read nor write memory
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_local_scalar_dense", "set_", "resize_"}
#: ops that write their result and read no tensor operand's data
_WRITE_ONLY = {"zeros", "ones", "full", "arange", "scalar_tensor", "zeros_like", "ones_like",
               "full_like", "new_zeros", "new_ones", "new_full", "fill_", "zero_"}
#: in-place writes into a slice: (op, index of the update operand)
_UPDATE = {"index_copy_": 3, "index_put_": 2, "index_add_": 3, "scatter_": 3,
           "scatter_add_": 3, "index_copy": 3, "index_put": 2}
#: gathers: each reads only the region it returns
_GATHER = {"index", "index_select", "gather", "embedding"}
_SOFTMAX = {"_softmax", "_softmax_backward_data", "_log_softmax",
            "_log_softmax_backward_data"}
_COPY = {"clone", "copy_", "_to_copy", "cat", "stack", "constant_pad_nd", "roll", "flip",
         "repeat", "contiguous", "_unsafe_index"} | set(_UPDATE) | _GATHER | _WRITE_ONLY
#: the autograd node metadata key that carries a forward op's group
_GROUP_KEY = "repro_op_group"


@dataclasses.dataclass
class OpStats:
    """One rank's counts of one step (see the module docstring).
    ``collectives`` holds the recording's entries in issue order
    (``sharding.Collective``); ``seam_counts`` the step's
    ``sharding.SEAM_COUNTS`` ticks."""

    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_group: Dict[str, float] = dataclasses.field(default_factory=dict)
    top_dots: List[dict] = dataclasses.field(default_factory=list)
    top_colls: List[dict] = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    seam_counts: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def finalize(self, top: int = 12) -> "OpStats":
        self.top_dots = sorted(self.top_dots, key=lambda d: -d["flops"])[:top]
        self.top_colls = sorted(self.top_colls, key=lambda d: -d["wire_bytes"])[:top]
        return self

    def add_collectives(self, collectives) -> None:
        """The recorded collectives' wire bytes by the ring model."""
        self.collectives = list(collectives)
        st = collective_stats(self.collectives)
        self.wire_bytes = st.wire_bytes
        self.coll_counts = dict(st.counts)
        self.coll_bytes = dict(st.by_op_bytes)
        self.top_colls = [{"wire_bytes": wire_bytes(c.kind, c.bytes, c.group), "op": c.kind,
                           "seam": c.seam, "axis": c.axis, "group": c.group,
                           "result_bytes": c.bytes, "mult": 1} for c in self.collectives]


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes a kernel reads of ``t``: its elements, a broadcast dim (stride
    0) counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs (a tensor, or tuples,
    lists and dicts of them, two levels deep as aten's schemas allow)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for x in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list, dict)):
            out.extend(_tensors(x))
    return out


def _code_groups() -> dict:
    """{code object: group} of the model functions a forward op's group is
    read from."""
    from repro_torch.models import attention, layers

    return {layers.rms_norm.__code__: "norm", layers.layer_norm.__code__: "norm",
            layers.apply_rope.__code__: "rope", attention._sdpa_dense.__code__: "attention",
            attention._sdpa_ring_shard.__code__: "attention",
            attention._online_softmax_chunked.__code__: "attention",
            attention._sdpa_chunked.__code__: "attention"}


def _frame_group(codes: dict, depth: int = 24) -> Optional[str]:
    f = sys._getframe(2)
    while f is not None and depth:
        g = codes.get(f.f_code)
        if g is not None:
            return g
        f, depth = f.f_back, depth - 1
    return None


class _Stamp(torch.overrides.TorchFunctionMode):
    """Stamps each autograd node made inside a grouped model function with
    that group, so its backward ops are counted under it."""

    def __init__(self, codes: dict):
        super().__init__()
        self.codes = codes

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled() and isinstance(out, (torch.Tensor, tuple, list)):
            nodes = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
            if nodes:
                g = _frame_group(self.codes)
                if g is not None:
                    for n in nodes:
                        n.metadata.setdefault(_GROUP_KEY, g)
        return out


class _Count(TorchDispatchMode):
    """Counts every aten op that reaches it (see the module docstring)."""

    def __init__(self, stats: OpStats, codes: dict, recorded: list):
        super().__init__()
        self.stats, self.codes, self.recorded = stats, codes, recorded
        self.flops = flop_registry
        self.by_kind = collections.Counter()
        self.by_group = collections.Counter()
        self.paused = False
        self.replays: dict = {}  # see _replayed

    def snapshot(self) -> tuple:
        st = self.stats
        return (st.flops, st.bytes, st.ops, len(st.top_dots), collections.Counter(self.by_kind),
                collections.Counter(self.by_group), len(self.recorded),
                collections.Counter(sh.SEAM_COUNTS))

    def delta(self, snap: tuple) -> tuple:
        st = self.stats
        return (st.flops - snap[0], st.bytes - snap[1], st.ops - snap[2],
                st.top_dots[snap[3]:], self.by_kind - snap[4], self.by_group - snap[5],
                self.recorded[snap[6]:], sh.SEAM_COUNTS - snap[7])

    def replay(self, delta: tuple) -> None:
        """Count once more what :meth:`delta` found: ops, recorded
        collectives and seam ticks."""
        st = self.stats
        st.flops += delta[0]
        st.bytes += delta[1]
        st.ops += delta[2]
        st.top_dots.extend(delta[3])
        self.by_kind.update(delta[4])
        self.by_group.update(delta[5])
        self.recorded.extend(delta[6])
        sh.SEAM_COUNTS.update(delta[7])

    def _group(self, name: str, func, flops: float) -> str:
        node = torch._C._current_autograd_node()
        ctx = (node.metadata.get(_GROUP_KEY) if node is not None
               else _frame_group(self.codes, depth=24))
        if flops:
            return "attention" if ctx == "attention" else "gemm"
        if name in _SOFTMAX:
            return "softmax"
        if ctx is not None:
            return ctx
        if name in _COPY:
            return "copy"
        if torch.Tag.pointwise in func.tags:
            return "elementwise"
        return "other"

    def _bytes(self, name: str, func, args, kwargs, out) -> int:
        if func.is_view or name in _VIEWS or name in _NO_BYTES:
            return 0
        outs = _tensors(out) if isinstance(out, (torch.Tensor, tuple, list)) else []
        if not outs:
            return 0  # a metadata query (a device, a size)
        result = sum(_nbytes(t) for t in outs)
        if name in _WRITE_ONLY:
            return result
        if name in _UPDATE:
            upd = args[_UPDATE[name]] if len(args) > _UPDATE[name] else None
            return 2 * _nbytes(upd) if isinstance(upd, torch.Tensor) else result
        if name in _GATHER:
            return 2 * result
        ins = _tensors((args, kwargs))
        if name == "copy_":
            return _read_bytes(args[1]) + result
        return sum(_read_bytes(t) for t in ins) + result

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func.namespace != "aten":  # prim: a device or size query
            return out
        name = func.overloadpacket.__name__
        st = self.stats
        st.ops += 1
        formula = self.flops.get(func.overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula else 0.0
        b = self._bytes(name, func, args, kwargs, out)
        if not (flops or b):
            return out
        group = self._group(name, func, flops)
        if flops:
            st.flops += flops
            res = _tensors(out)[0]
            st.top_dots.append({"flops": flops, "op": f"aten.{name}",
                                "result": f"{str(res.dtype).removeprefix('torch.')}"
                                          f"{list(res.shape)}",
                                "operands": [list(t.shape) for t in _tensors(args)],
                                "group": group, "mult": 1})
        st.bytes += b
        self.by_kind[name] += b
        self.by_group[group] += b
        return out


_ACTIVE = threading.local()


def _signature(tree) -> tuple:
    """The shapes, strides, dtypes and shard marks of a tree's tensors and
    its other leaves: what a replayed call's ops depend on."""
    from torch.utils._pytree import tree_flatten

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.stride(), x.dtype, sh.shard_marks(x), sh.partial_axes(x))
        try:
            hash(x)
            return x
        except TypeError:  # a template: the same object
            return ("id", id(x))

    leaves, spec = tree_flatten(tree)
    return str(spec), tuple(map(leaf, leaves))


def _replayed(fn, replayable):
    """``fn`` under an analysis: a call that repeats one already counted
    (:func:`_signature` of its arguments, the active mesh and rules equal)
    counts that call's ops, collectives and seam ticks again and returns
    new empty tensors shaped and marked as that call's results, instead of
    dispatching its ops once more.  The functions replayed
    (:func:`_replaying`) compute nothing from their inputs' values, so the
    counts are those of running them.  ``replayable(*args)`` says whether
    a call may be replayed; outside an analysis, ``fn`` itself."""
    @functools.wraps(fn)
    def run(*args, **kw):
        counter = getattr(_ACTIVE, "counter", None)
        if counter is None or not replayable(*args):
            return fn(*args, **kw)
        mesh, rules, split = sh.mesh_state()
        key = (fn.__qualname__, _signature((args, kw)), id(mesh), rules, split)
        if key in counter.replays:
            delta, out = counter.replays[key]
            counter.replay(delta)
            counter.paused = True
            try:
                return tree_map(_fresh, out)
            finally:
                counter.paused = False
        snap = counter.snapshot()
        out = fn(*args, **kw)
        counter.replays[key] = (counter.delta(snap), out)
        return out

    return run


def _fresh(t):
    """A new empty tensor shaped and marked as ``t`` (other leaves as they
    are)."""
    if not isinstance(t, torch.Tensor):
        return t
    return sh.carry_marks(t, torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                                                 device=t.device))


def _no_grad_operands(*args) -> bool:
    return not any(isinstance(t, torch.Tensor) and t.requires_grad for t in args)


@contextlib.contextmanager
def _replaying(counter):
    """While the block runs, on this thread, count into ``counter`` with two
    functions replayed (:func:`_replayed`): the chunked attention's online
    softmax (``models/attention.py``) when no operand requires grad (a long
    prefill's layers repeat one call of tens of thousands of ops each), and
    a train step's loss and grads of one microbatch (``launch/steps.py``:
    the ``accum`` microbatches of a step are alike, as the reference's
    accumulation loop repeats one body)."""
    from repro_torch.launch import steps
    from repro_torch.models import attention

    saved = (attention._online_softmax_chunked, steps._loss_and_grads)
    prev = getattr(_ACTIVE, "counter", None)
    attention._online_softmax_chunked = _replayed(saved[0], _no_grad_operands)
    steps._loss_and_grads = _replayed(saved[1], lambda *a: True)
    _ACTIVE.counter = counter
    try:
        yield
    finally:
        _ACTIVE.counter = prev
        attention._online_softmax_chunked, steps._loss_and_grads = saved


def _fake_like(mode, t):
    """``t`` (real or another mode's fake) as a fake tensor of ``mode``, its
    shard marks carried."""
    with mode:
        f = torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=t.dtype,
                                device=t.device)
    f.requires_grad_(t.requires_grad)
    return sh.carry_marks(t, f)


@contextlib.contextmanager
def _seams_kept():
    """``sharding.SEAM_COUNTS`` as it was when the block ends; yields the
    ticks made inside it."""
    saved = collections.Counter(sh.SEAM_COUNTS)
    sh.SEAM_COUNTS.clear()
    ticks: dict = {}
    try:
        yield ticks
    finally:
        ticks.update(sh.SEAM_COUNTS)
        sh.SEAM_COUNTS.clear()
        sh.SEAM_COUNTS.update(saved)


def analyze_step(step_fn, *args, tpl, mesh=None, rules=None, top: int = 12) -> OpStats:
    """Count one call of ``step_fn(*args)`` on fake tensors: its flops, bytes
    by aten op and by group, and, on a recording rank, its collectives.

    ``args`` are the step's argument trees; each tensor (real, or fake of
    any mode) goes in as a fake tensor of the analysis's own mode, its
    shard marks carried (a recording rank's shards: ``sharding.shard_tree``
    on ``mesh.recording()``).  ``tpl`` is the template the step runs on; it
    must be the ``torch`` backend.  With ``mesh`` (``rules`` default the
    active ones) the step runs under ``use_mesh`` and ``batch_split`` over
    the rules' batch axes, as ``launch/steps.py`` runs a train step; a
    mesh with ranks must be a recording rank.  ``sharding.SEAM_COUNTS`` and
    the kernels' launch counts are left as they were; the step's seam ticks
    are in ``seam_counts``.  A call repeated inside the step is counted
    once and replayed (:func:`_replaying`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build

    backend = tpl.config.backend
    if backend != "torch":
        raise ValueError(
            f"analyze_step counts the 'torch' template (plain aten ops, the reference's "
            f"'xla' backend); a {backend!r} template launches kernels through ctypes, "
            f"which fake tensors cannot reach")
    if mesh is not None and mesh.has_groups and not mesh.is_recording:
        raise ValueError(f"analyze_step runs on a recording rank (Mesh.recording()); "
                         f"{mesh} issues real collectives")
    rules = rules or sh.active_rules()
    launches = dict(_build.launches)
    stats = OpStats()
    codes = _code_groups()
    mode = FakeTensorMode()
    fake = tree_map(lambda x: _fake_like(mode, x) if isinstance(x, torch.Tensor) else x,
                    args)
    with contextlib.ExitStack() as stack:
        ticks = stack.enter_context(_seams_kept())
        recorded = stack.enter_context(sh.record_collectives())
        if mesh is not None:
            stack.enter_context(sh.use_mesh(mesh, rules))
            stack.enter_context(sh.batch_split(sh.axis_size(mesh, sh.batch_axes())))
        stack.enter_context(mode)
        counter = _Count(stats, codes, recorded)
        stack.enter_context(_Stamp(codes))
        stack.enter_context(counter)
        stack.enter_context(_replaying(counter))
        step_fn(*fake)
    if dict(_build.launches) != launches:
        raise RuntimeError("analyze_step: the step launched a kernel")
    stats.seam_counts = dict(ticks)
    stats.bytes_by_kind = dict(counter.by_kind)
    stats.bytes_by_group = {g: counter.by_group.get(g, 0) for g in GROUPS}
    stats.add_collectives(recorded)
    return stats.finalize(top)
