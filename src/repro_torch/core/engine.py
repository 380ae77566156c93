"""The execution-plan engine: plan-then-execute for the unified compute unit.

The port's copy of ``repro.core.engine``:

* :class:`PlanRegistry` — memoized DSE choices (GEMM plans per kernel and
  direct-conv configurations) per (shape, spec), with hit and miss
  counters, so a test can assert that a repeated shape costs one search;
  and the precision DSE's per-layer pins (:class:`PrecisionChoice`, keyed
  by (network, layer, spec)), which a warm calibration replays with no
  forward.  Every entry carries ``source`` provenance (``"analytic"`` or
  ``"measured"``; a measured entry outranks an analytic one in every
  merge).  :meth:`PlanRegistry.measure_and_pin` times the top-K legal plans
  of a GEMM kernel (on the card: its hand-written kernel under CUDA events)
  and pins the fastest.
* The JSON plan store: :meth:`PlanRegistry.save` / :meth:`~PlanRegistry.load`
  and, over every per-spec registry, :func:`save_plan_store` (a flock'd
  read-merge-write, staged and fsync'd), :func:`load_plan_store` and
  :func:`warm_start_plan_store`, at ``$REPRO_TORCH_PLAN_STORE`` by default.
  Its schema is the port's own (format ``"repro-torch-plan-store"``, version
  1): the reference's sections and fields, plus each GEMM entry's kernel,
  dtype or operand widths, route and splits, each conv choice's route
  fields, and spec documents tagged with their kind (``"gpu"`` or
  ``"tpu"``).  A reference store is rejected, never read by accident.
* :class:`GemmPlan` / :class:`ConvPlan` — per-layer plans: the conv route
  (direct CUDA conv or im2col GEMM), τ, the Cin chunk and tiles of the
  direct route, the GEMM tile (and, for the float GEMM, its route).
* :class:`Engine` — runs plans on three backends: ``"cuda"`` (the
  hand-written kernels, the analog of ``pallas``), ``"q16"`` (the
  fixed-point kernels, grid-resident on QTensor operands) and ``"torch"``
  (plain tensor ops, the analog of ``xla``).  Its counters keep the
  reference's names, with ``gemm_cuda`` for ``gemm_pallas`` and
  ``conv_torch`` for ``conv_xla``.
* The serve scheduler's bucket ladder: :func:`bucket_for`,
  :func:`batch_rungs` and :meth:`Engine.plan_gemm_ladder`, exactly the
  reference's.
* Sharding (``repro_torch.parallel.sharding``): ``plan_gemm(mesh=)`` and
  ``plan_conv(mesh=)`` plan a layer's local (per-shard) shape;
  ``plan_conv(spatial=)`` plans an H-slab seam (:attr:`ConvPlan.halo`),
  which :meth:`Engine.conv2d` runs through the halo exchange.  A rank's
  GEMM on a column shard of its weight (a shard-marked ``w``) plans its
  local shape with the logical shape's k order, so a float result is the
  unsharded one bit for bit, and its output carries the shard mark; a
  shard-marked contraction dim of ``x`` is gathered first.  A local float
  plan is keyed by its logical shape as well (the store's ``"logical"``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import math
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch.parallel import sharding as sh

from . import dse
from .quantization import (
    NumericsPolicy,
    QFormat,
    QTensor,
    calibrate_format,
    dequantize,
    fake_quant_fmt,
    quantize,
    quantize_qtensor,
)
from .tiling import H100, GpuSpec, MatmulBlock, Spec, TpuSpec, clamp_block

__all__ = [
    "PLAN_STORE_ENV",
    "PLAN_STORE_FORMAT",
    "PLAN_STORE_VERSION",
    "PlanRegistry",
    "PlanStoreError",
    "PrecisionChoice",
    "ConvPlan",
    "GemmPlan",
    "Engine",
    "batch_rungs",
    "bucket_for",
    "default_plan_store_path",
    "load_plan_store",
    "plan_cache_for",
    "plan_store_stats",
    "register_plan_store",
    "reset_plan_caches",
    "save_plan_store",
    "validate_policy",
    "warm_start_plan_store",
]


def bucket_for(length: int, ladder: Sequence[int]) -> Optional[int]:
    """The bucket-ladder rule: the smallest ladder entry >= length.

    The serve scheduler pads every prefill up to a rung of a small ladder so
    the engine sees a handful of fixed GEMM shapes, each planned once,
    instead of one shape per prompt length.  None when the length exceeds
    every rung (the request cannot be admitted at this ladder).
    """
    if length < 0:
        raise ValueError(f"negative length {length}")
    best = None
    for rung in ladder:
        if rung >= length and (best is None or rung < best):
            best = rung
    return best


def batch_rungs(slots: int) -> tuple:
    """Batch-size ladder for coalesced (B, L) prefill launches: powers of two
    up to ``slots`` plus ``slots`` itself.  A tick's pending prefills for one
    rung are padded up to the smallest batch rung >= their count, so the
    engine sees |batch_rungs| x |ladder| prefill shapes in all."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    rungs = set()
    b = 1
    while b < slots:
        rungs.add(b)
        b *= 2
    rungs.add(slots)
    return tuple(sorted(rungs))


# ---------------------------------------------------------------------------
# plan registry (memoized DSE, persistent + measured-time overwrite)
# ---------------------------------------------------------------------------

#: the port's own store format: its GEMM keys, plans and specs carry fields
#: the reference's lack, so it never reads (or is read as) a reference store
PLAN_STORE_FORMAT = "repro-torch-plan-store"
PLAN_STORE_VERSION = 1
#: env var naming the default plan-store path: the serve driver and the
#: soak benchmarks warm-start from it and write new plans back
PLAN_STORE_ENV = "REPRO_TORCH_PLAN_STORE"

_SPEC_KINDS = {"gpu": GpuSpec, "tpu": TpuSpec}
GEMM_KERNELS = ("matmul_fp", "matmul_q16")


class PlanStoreError(ValueError):
    """A plan store file is unreadable, corrupted, version-mismatched or of
    another format."""


@dataclasses.dataclass(frozen=True)
class PrecisionChoice:
    """One pinned per-layer activation grid (the precision DSE's output).

    ``fmt`` is the layer's *input* activation format (the int8 rung or the
    network's base int16 grid); ``drift`` the measured solo-flip argmax
    agreement that justified it (None for a pin not from a sweep).
    """

    fmt: QFormat
    drift: Optional[float] = None


def _lists(v):
    return [_lists(x) for x in v] if isinstance(v, (tuple, list)) else v


def _tuples(v):
    """JSON lists back into tuples, all the way down: a spec built from
    lists would be unhashable and unequal to its own constant."""
    return tuple(_tuples(x) for x in v) if isinstance(v, (tuple, list)) else v


def _spec_to_doc(spec: Spec) -> dict:
    kind = next(k for k, cls in _SPEC_KINDS.items() if isinstance(spec, cls))
    return {"kind": kind, **{k: _lists(v) for k, v in dataclasses.asdict(spec).items()}}


def _spec_from_doc(doc: dict) -> Spec:
    if not isinstance(doc, dict):
        raise PlanStoreError(f"bad spec document {doc!r}")
    fields = dict(doc)
    kind = fields.pop("kind", None)
    cls = _SPEC_KINDS.get(kind)
    if cls is None:
        raise PlanStoreError(f"unknown spec kind {kind!r} in plan store")
    try:
        return cls(**{k: _tuples(v) for k, v in fields.items()})
    except TypeError as err:
        raise PlanStoreError(f"unrecognized {cls.__name__} fields in plan store: "
                             f"{err}") from err


def _gemm_key(kernel: str, m: int, n: int, k: int, spec: Spec, dtype_bytes: int,
              xbits: int, wbits: int, logical: tuple = ()) -> tuple:
    """The registry key of one GEMM call: the float GEMM plans from the
    dtype, the q16 GEMM from its operands' widths.  A shard's local call
    is keyed by its logical shape too: the float plan keeps that shape's k
    order, and either kernel's local entries stay apart from the shapes
    planned as themselves (``gemm_shapes``)."""
    tail = (tuple(logical),) if logical else ()
    if kernel == "matmul_fp":
        return (kernel, m, n, k, dtype_bytes, *tail, spec)
    if kernel == "matmul_q16":
        return (kernel, m, n, k, xbits, wbits, *tail, spec)
    raise ValueError(f"no GEMM kernel {kernel!r}")


def _key_logical(key: tuple) -> tuple:
    """The logical shape a local plan's key holds, else ()."""
    return key[-2] if len(key) == (7 if key[0] == "matmul_fp" else 8) else ()


def _time_plans(m: int, n: int, k: int, candidates, *, kernel: str, dtype_bytes: int,
                xbits: int, wbits: int, reps: int, device) -> list:
    """Each candidate's mean seconds per call on seeded random operands.  On
    a CUDA device: the hand-written kernel on the plan's route, one untimed
    launch, then ``reps`` launches between CUDA events.  On the CPU: the
    plain version under ``time.perf_counter`` (the mechanism, not a
    measurement of any plan)."""
    from repro_torch.kernels import matmul_fp as kfp
    from repro_torch.kernels import matmul_q16 as kq
    from repro_torch.kernels import ops as kops

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    if kernel == "matmul_fp":
        dtype = {4: torch.float32, 2: torch.bfloat16}[dtype_bytes]
        x = (torch.randn((m, k), generator=gen) * 0.3).to(dev, dtype)
        w = (torch.randn((k, n), generator=gen) * 0.3).to(dev, dtype)
        if dev.type == "cuda":
            def run(blk):
                return kops.matmul_fp(x, w, block=blk)
        else:
            def run(blk):
                return kfp.matmul_fp_plain(x, w)
    else:
        def raws(shape, bits):
            dt = {8: torch.int8, 16: torch.int16}[bits]
            info = torch.iinfo(dt)
            return torch.randint(info.min, info.max + 1, shape, generator=gen).to(dev, dt)

        x, w = raws((m, k), xbits), raws((k, n), wbits)
        if dev.type == "cuda":
            def run(blk):
                return kops.matmul_q16(x, w, block=blk)
        else:
            def run(blk):
                return kq.matmul_q16_plain(x, w, None, shift=14, bias_shift=14,
                                           raw_min=-32768, raw_max=32767,
                                           out_dtype=torch.int16)
    times = []
    for blk in candidates:
        run(blk)  # builds / first-touches outside the timed region
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(reps):
                run(blk)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                run(blk)
            times.append((time.perf_counter() - t0) / reps)
    return times


class PlanRegistry:
    """Memoized DSE selection: GEMM blocks, direct-conv configurations and
    per-layer precision pins.

    ``misses`` counts searches actually run, ``hits`` lookups served from
    the registry: a repeated shape costs exactly one search for the
    registry's lifetime, or none once loaded from a store (:meth:`load`) or
    pinned by :meth:`measure_and_pin`.  Every entry carries ``source``
    provenance: ``"analytic"`` (the planner's score) or ``"measured"``
    (timed launches; a precision pin from a drift sweep).
    """

    def __init__(self) -> None:
        self._blocks: dict = {}
        self._conv_tiles: dict = {}
        self._precision: dict = {}
        self._block_src: dict = {}
        self._conv_src: dict = {}
        self._prec_src: dict = {}
        self.hits = 0
        self.misses = 0
        #: the last :meth:`measure_and_pin`'s timings: [(plan, seconds)]
        self.last_measurement: list = []

    def block_for(self, m: int, n: int, k: int, spec: Spec = H100, *,
                  kernel: str = "matmul_q16", dtype_bytes: int = 4, xbits: int = 16,
                  wbits: int = 16, logical: tuple = ()) -> MatmulBlock:
        """The memoized GEMM plan of one kernel for one call.  The key holds
        the kernel: the float GEMM ("matmul_fp") plans a route from the
        dtype as well (:func:`dse.default_fp_block_for`; ``logical``, a
        shard's logical (m, n, k), keeps that shape's k order), the q16 GEMM
        ("matmul_q16") from its operands' widths ``xbits`` / ``wbits``, 8 or
        16, whose limb products shape its tensor-core tile
        (:func:`dse.default_q16_block_for`)."""
        if tuple(logical) == (m, n, k):
            logical = ()
        key = _gemm_key(kernel, m, n, k, spec, dtype_bytes, xbits, wbits, logical)
        blk = self._blocks.get(key)
        if blk is None:
            self.misses += 1
            if kernel == "matmul_fp":
                blk = dse.default_fp_block_for(m, n, k, spec, dtype_bytes=dtype_bytes,
                                               logical=logical)
            else:  # exact under any split: a local call plans as its own shape
                blk = dse.default_q16_block_for(m, n, k, spec, xbits=xbits, wbits=wbits)
            self._blocks[key] = blk
            self._block_src[key] = "analytic"
        else:
            self.hits += 1
        return blk

    def conv_tile_for(
        self,
        hp: int, wp: int, cin: int, kh: int, kw: int, ho: int, wo: int,
        cout: int, stride: int, in_bytes: int, spec: Spec = H100,
    ):
        """Memoized :func:`dse.default_conv_tile_for` (None = no fit cached)."""
        key = (hp, wp, cin, kh, kw, ho, wo, cout, stride, in_bytes, spec)
        if key in self._conv_tiles:
            self.hits += 1
            return self._conv_tiles[key]
        self.misses += 1
        choice = dse.default_conv_tile_for(
            hp, wp, cin, kh, kw, ho, wo, cout, stride, spec, in_bytes
        )
        self._conv_tiles[key] = choice
        self._conv_src[key] = "analytic"
        return choice

    # -- per-layer precision pins (the drift-aware DSE) ------------------------

    def precision_for(self, net: str, layer: str, spec: Spec = H100
                      ) -> Optional[PrecisionChoice]:
        """The pinned activation grid of one named layer, or None.

        A found pin counts as a hit; a miss is *not* counted here: the
        precision search is a whole-network drift sweep, so its misses are
        charged by :meth:`pin_precision` when the sweep ran
        (``searched=True``).  A warm call replays every layer as hits with
        zero misses.
        """
        ent = self._precision.get((net, layer, spec))
        if ent is not None:
            self.hits += 1
        return ent

    def pin_precision(self, net: str, layer: str, fmt: QFormat, *,
                      drift: Optional[float] = None, spec: Spec = H100,
                      source: str = "measured", searched: bool = True) -> PrecisionChoice:
        """Record one layer's chosen grid (``source="measured"``: the choice
        came from a drift sweep, not from an analytic model)."""
        if searched:
            self.misses += 1
        choice = PrecisionChoice(fmt=fmt, drift=drift)
        key = (net, layer, spec)
        self._precision[key] = choice
        self._prec_src[key] = source
        return choice

    def precision_plan(self, net: str, spec: Spec = H100) -> dict:
        """Every pinned (layer -> QFormat) choice of one network; counts
        nothing (an inspection helper)."""
        return {key[1]: ent.fmt for key, ent in self._precision.items()
                if key[0] == net and key[2] == spec}

    # -- measured-time autotune ------------------------------------------------

    def measure_and_pin(self, m: int, n: int, k: int, spec: Spec = H100, *,
                        kernel: str = "matmul_fp", dtype_bytes: int = 4, xbits: int = 16,
                        wbits: int = 16, candidates: Optional[Sequence[MatmulBlock]] = None,
                        top_k: int = 3, reps: int = 2, device="cuda") -> MatmulBlock:
        """Time the top-K legal plans of ``kernel`` for one call
        (:func:`dse.explore_gemm_plans`, or ``candidates``) with real
        launches and pin the fastest under :meth:`block_for`'s key with
        ``source="measured"``.

        On a CUDA ``device`` each plan launches the hand-written kernel on
        its route, timed with CUDA events after one untimed launch; on the
        CPU the plain version runs under ``time.perf_counter`` (the
        reference's ``interpret=True``: the mechanism, measure, pick, pin
        and persist, ships; the numbers mean nothing).  The timings stay in
        :attr:`last_measurement`.
        """
        if candidates is None:
            candidates = dse.explore_gemm_plans(m, n, k, spec, kernel=kernel,
                                                dtype_bytes=dtype_bytes, xbits=xbits,
                                                wbits=wbits, top=top_k)
        if not candidates:
            candidates = [clamp_block(m, n, k, MatmulBlock(128, 128, 128), spec)]
        times = _time_plans(m, n, k, candidates, kernel=kernel, dtype_bytes=dtype_bytes,
                            xbits=xbits, wbits=wbits, reps=reps, device=device)
        self.last_measurement = list(zip(candidates, times))
        best = min(self.last_measurement, key=lambda ct: ct[1])[0]
        key = _gemm_key(kernel, m, n, k, spec, dtype_bytes, xbits, wbits)
        self._blocks[key] = best
        self._block_src[key] = "measured"
        return best

    # -- provenance / stats ----------------------------------------------------

    def source_for(self, m: int, n: int, k: int, spec: Spec = H100, *,
                   kernel: str = "matmul_q16", dtype_bytes: int = 4, xbits: int = 16,
                   wbits: int = 16) -> Optional[str]:
        """The provenance of one GEMM entry (:meth:`block_for`'s key), or None."""
        return self._block_src.get(_gemm_key(kernel, m, n, k, spec, dtype_bytes, xbits,
                                             wbits))

    def stats(self) -> dict:
        """Entry counts by kind, the counters, and the measured entries."""
        measured = sum(1 for src in (*self._block_src.values(), *self._conv_src.values(),
                                     *self._prec_src.values()) if src == "measured")
        return {
            "gemm_blocks": len(self._blocks),
            "conv_tiles": len(self._conv_tiles),
            "precision": len(self._precision),
            "hits": self.hits,
            "misses": self.misses,
            "measured": measured,
        }

    @contextlib.contextmanager
    def scope(self, into: Optional[dict] = None):
        """Yield a dict that holds, on exit, the hit/miss delta of the
        with-block (also added into ``into`` when given)."""
        delta = {"hits": 0, "misses": 0}
        h0, m0 = self.hits, self.misses
        try:
            yield delta
        finally:
            delta["hits"] = self.hits - h0
            delta["misses"] = self.misses - m0
            if into is not None:
                into["hits"] = into.get("hits", 0) + delta["hits"]
                into["misses"] = into.get("misses", 0) + delta["misses"]

    def __len__(self) -> int:
        return len(self._blocks) + len(self._conv_tiles) + len(self._precision)

    def clear(self) -> None:
        for d in (self._blocks, self._conv_tiles, self._precision, self._block_src,
                  self._conv_src, self._prec_src):
            d.clear()
        self.hits = 0
        self.misses = 0

    # -- serialization ---------------------------------------------------------

    def to_doc(self) -> dict:
        """The registry as a versioned, JSON-serializable document."""
        specs: list = []
        spec_ix: dict = {}

        def six(spec) -> int:
            if spec not in spec_ix:
                spec_ix[spec] = len(specs)
                specs.append(_spec_to_doc(spec))
            return spec_ix[spec]

        def order(key):  # a deterministic artifact: by spec, then by key
            return (repr(key[-1]), key[:-1])

        gemm = []
        for key, blk in sorted(self._blocks.items(), key=lambda kv: order(kv[0])):
            kernel, m, n, k = key[:4]
            widths = ({"dtype_bytes": key[4]} if kernel == "matmul_fp"
                      else {"xbits": key[4], "wbits": key[5]})
            logical = _key_logical(key)
            gemm.append({"spec": six(key[-1]), "kernel": kernel, "key": [m, n, k], **widths,
                         **({"logical": list(logical)} if logical else {}),
                         "block": [blk.bm, blk.bn, blk.bk], "route": blk.route,
                         "splits": blk.splits,
                         "source": self._block_src.get(key, "analytic")})
        conv = [
            {
                "spec": six(key[-1]),
                "key": list(key[:-1]),
                "choice": None if choice is None else dse.conv_choice_to_doc(choice),
                "source": self._conv_src.get(key, "analytic"),
            }
            for key, choice in sorted(self._conv_tiles.items(), key=lambda kv: order(kv[0]))
        ]
        precision = [
            {
                "spec": six(key[-1]),
                "key": list(key[:-1]),  # [net, layer]
                "fmt": [ent.fmt.int_bits, ent.fmt.frac_bits, ent.fmt.total_bits],
                "drift": ent.drift,
                "source": self._prec_src.get(key, "measured"),
            }
            for key, ent in sorted(self._precision.items(), key=lambda kv: order(kv[0]))
        ]
        return {"format": PLAN_STORE_FORMAT, "version": PLAN_STORE_VERSION, "specs": specs,
                "gemm": gemm, "conv": conv, "precision": precision}

    def merge_doc(self, doc: dict) -> int:
        """Merge a :meth:`to_doc` document into this registry.

        Loaded entries count as neither hits nor misses (a later lookup of a
        loaded entry is a hit) and overwrite existing ones, except that a
        measured entry is never replaced by an analytic one.  Returns the
        number of entries merged; raises :class:`PlanStoreError` on another
        format (the reference's store included), another version, or any
        structural fault, and then merges nothing.
        """
        blocks: dict = {}
        block_src: dict = {}
        conv_tiles: dict = {}
        conv_src: dict = {}
        precision: dict = {}
        prec_src: dict = {}
        try:
            if doc.get("format") != PLAN_STORE_FORMAT:
                raise PlanStoreError(f"not a plan store of this package (format="
                                     f"{doc.get('format')!r}, want {PLAN_STORE_FORMAT!r})")
            if doc.get("version") != PLAN_STORE_VERSION:
                raise PlanStoreError(f"plan store version {doc.get('version')!r} does not "
                                     f"match this build's version {PLAN_STORE_VERSION}")
            specs = [_spec_from_doc(d) for d in doc["specs"]]

            def spec_at(ix):
                if not isinstance(ix, int) or not 0 <= ix < len(specs):
                    raise PlanStoreError(f"bad spec index {ix!r}")
                return specs[ix]

            for e in doc["gemm"]:
                if len(e["key"]) != 3 or len(e["block"]) != 3:
                    raise PlanStoreError(f"bad gemm entry: key={e['key']!r} "
                                         f"block={e['block']!r}")
                kernel = e["kernel"]
                if kernel == "matmul_fp":
                    widths = (int(e["dtype_bytes"]), 0, 0)
                elif kernel == "matmul_q16":
                    widths = (0, int(e["xbits"]), int(e["wbits"]))
                    if not set(widths[1:]) <= {8, 16}:
                        raise PlanStoreError(f"bad q16 widths {widths[1:]!r}")
                else:
                    raise PlanStoreError(f"bad gemm kernel {kernel!r}")
                m, nn, k = (int(v) for v in e["key"])
                logical = tuple(int(v) for v in e.get("logical", ()))
                if logical and len(logical) != 3:
                    raise PlanStoreError(f"bad gemm logical shape {logical!r}")
                key = _gemm_key(kernel, m, nn, k, spec_at(e["spec"]), *widths, logical)
                blocks[key] = MatmulBlock(*(int(v) for v in e["block"]),
                                          route=str(e["route"]), splits=int(e["splits"]))
                block_src[key] = str(e.get("source", "analytic"))
            for e in doc["conv"]:
                key = tuple(int(v) for v in e["key"]) + (spec_at(e["spec"]),)
                if len(key) != 11:
                    raise PlanStoreError(f"bad conv key of length {len(key)}")
                choice = e["choice"]
                conv_tiles[key] = None if choice is None else dse.conv_choice_from_doc(choice)
                conv_src[key] = str(e.get("source", "analytic"))
            for e in doc["precision"]:
                if len(e["key"]) != 2 or len(e["fmt"]) != 3:
                    raise PlanStoreError(f"bad precision entry: key={e['key']!r} "
                                         f"fmt={e['fmt']!r}")
                net, layer = (str(v) for v in e["key"])
                key = (net, layer, spec_at(e["spec"]))
                ib, fb, tb = (int(v) for v in e["fmt"])
                drift = e.get("drift")
                precision[key] = PrecisionChoice(fmt=QFormat(ib, fb, tb),
                                                 drift=None if drift is None else float(drift))
                prec_src[key] = str(e.get("source", "measured"))
        except PlanStoreError:
            raise
        except (AttributeError, KeyError, IndexError, TypeError, ValueError) as err:
            raise PlanStoreError(f"corrupted plan store: {err!r}") from err
        # commit only after the whole document validated: a rejected store
        # never leaves a half-merged registry behind
        self._merge_entries(self._blocks, self._block_src, blocks, block_src)
        self._merge_entries(self._conv_tiles, self._conv_src, conv_tiles, conv_src)
        self._merge_entries(self._precision, self._prec_src, precision, prec_src)
        return len(blocks) + len(conv_tiles) + len(precision)

    @staticmethod
    def _merge_entries(dst_vals: dict, dst_src: dict, vals: dict, srcs: dict) -> None:
        """Merge entry maps; an existing *measured* entry outranks an
        incoming analytic one (a concurrent analytic writer never silently
        downgrades a timed pin)."""
        for key, val in vals.items():
            src = srcs.get(key, "analytic")
            if dst_src.get(key) == "measured" and src != "measured":
                continue
            dst_vals[key] = val
            dst_src[key] = src

    def merge_from(self, other: "PlanRegistry", spec: Optional[Spec] = None) -> None:
        """Copy ``other``'s entries into this registry (incoming wins, except
        over a measured entry); ``spec`` restricts the copy to one hardware
        spec's entries.  Counters are untouched: merges are not lookups."""
        def of(entries):
            return {k: v for k, v in entries.items() if spec is None or k[-1] == spec}

        self._merge_entries(self._blocks, self._block_src, of(other._blocks),
                            other._block_src)
        self._merge_entries(self._conv_tiles, self._conv_src, of(other._conv_tiles),
                            other._conv_src)
        self._merge_entries(self._precision, self._prec_src, of(other._precision),
                            other._prec_src)

    def specs(self) -> set:
        """The distinct hardware specs this registry holds entries for."""
        return {key[-1] for d in (self._blocks, self._conv_tiles, self._precision)
                for key in d}

    def gemm_shapes(self, spec: Spec = H100) -> list:
        """The distinct (m, n, k) GEMM shapes planned for ``spec`` as
        themselves (not as a shard's local shape), sorted."""
        return sorted({key[1:4] for key in self._blocks
                       if key[-1] == spec and not _key_logical(key)})

    def save(self, path: str) -> str:
        """Write the registry as versioned JSON, stage then commit: the temp
        file ``{path}.tmp.{pid}`` is fsync'd before the ``os.replace``, and
        the directory after it.  A crash before the rename leaves the old
        store untouched (and a stale temp file, which the next
        :func:`save_plan_store` removes under its lock)."""
        doc = self.to_doc()
        tmp = f"{path}.tmp.{os.getpid()}"
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:  # make the rename itself durable
            dfd = os.open(parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return path

    def load(self, path: str) -> int:
        """Merge a persisted store into this registry; returns entries loaded."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as err:
            raise PlanStoreError(f"cannot read plan store {path!r}: {err}") from err
        except json.JSONDecodeError as err:
            raise PlanStoreError(f"corrupted plan store {path!r}: {err}") from err
        if not isinstance(doc, dict):
            raise PlanStoreError(f"corrupted plan store {path!r}: not a JSON object")
        return self.merge_doc(doc)


_REGISTRIES: dict = {}


def plan_cache_for(spec: Spec = H100) -> PlanRegistry:
    """The registry shared by every engine planning for ``spec``."""
    reg = _REGISTRIES.get(spec)
    if reg is None:
        reg = _REGISTRIES[spec] = PlanRegistry()
    return reg


_EXTRA_PLAN_STORES: list = []


def register_plan_store(store) -> None:
    """Register a derived memo (anything with ``clear()``) to be emptied by
    :func:`reset_plan_caches`; registering the same object twice is a no-op."""
    if not any(s is store for s in _EXTRA_PLAN_STORES):
        _EXTRA_PLAN_STORES.append(store)


def reset_plan_caches() -> None:
    """Drop every cached plan, in place, and every registered derived memo
    (the scheduler's compiled steps hold templates whose plans just went)."""
    for reg in _REGISTRIES.values():
        reg.clear()
    for store in _EXTRA_PLAN_STORES:
        store.clear()


# ---------------------------------------------------------------------------
# the persisted plan store (every per-spec registry <-> one JSON file)
# ---------------------------------------------------------------------------


def default_plan_store_path() -> Optional[str]:
    """The ``REPRO_TORCH_PLAN_STORE`` path, or None when unset or empty."""
    return os.environ.get(PLAN_STORE_ENV) or None


@contextlib.contextmanager
def _store_write_lock(path: str):
    """Serialize the read-merge-write save cycle across processes sharing one
    store with an advisory flock on ``{path}.lock`` (the OS drops it when a
    holder dies).  Without fcntl the save is the unserialized atomic write."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX platforms
        yield
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(f"{path}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _store_path(path: Optional[str]) -> str:
    path = path or default_plan_store_path()
    if path is None:
        raise ValueError(f"no plan-store path given and {PLAN_STORE_ENV} is unset")
    return path


def save_plan_store(path: Optional[str] = None) -> str:
    """Write every process-global registry into one JSON store.

    Under the lock, the entries already on disk are merged in first (this
    process's entries win, except over a measured one), so writers sharing
    a store add to rather than overwrite each other's plans; an unusable
    file on disk is replaced.  Temp files of writers that died between
    staging and commit are removed."""
    path = _store_path(path)
    with _store_write_lock(path):
        merged = PlanRegistry()
        if os.path.exists(path):
            try:
                merged.load(path)
            except PlanStoreError:
                pass
        for reg in _REGISTRIES.values():
            merged.merge_from(reg)
        out = merged.save(path)
        # every writer stages under this lock, so any temp sibling seen here
        # is an orphan
        for stale in glob.glob(f"{path}.tmp.*"):
            try:
                os.unlink(stale)
            except OSError:
                pass
        return out


def load_plan_store(path: Optional[str] = None, *, missing_ok: bool = False) -> int:
    """Load a store into the per-spec global registries; returns the entries
    loaded (0 when ``missing_ok`` and the file does not exist)."""
    path = _store_path(path)
    if missing_ok and not os.path.exists(path):
        return 0
    stage = PlanRegistry()
    n = stage.load(path)
    for spec in stage.specs():
        plan_cache_for(spec).merge_from(stage, spec)
    return n


def warm_start_plan_store(path: Optional[str] = None) -> tuple:
    """Warm start from ``path`` (default ``$REPRO_TORCH_PLAN_STORE``) when it
    exists: (path, entries loaded), or (None, 0) when no store is named.
    An unusable store (corrupt, another version, a reference store) warns
    and cold-starts: a warm-start cache is never a startup failure
    (:func:`load_plan_store` stays strict)."""
    path = path or default_plan_store_path()
    if path is None:
        return None, 0
    try:
        return path, load_plan_store(path, missing_ok=True)
    except PlanStoreError as err:
        import warnings

        warnings.warn(f"ignoring unusable plan store {path!r}: {err}")
        return path, 0


def plan_store_stats() -> dict:
    """:meth:`PlanRegistry.stats` summed over every per-spec registry."""
    total = dict.fromkeys(("gemm_blocks", "conv_tiles", "precision", "hits", "misses",
                           "measured"), 0)
    for reg in _REGISTRIES.values():
        for k, v in reg.stats().items():
            total[k] += v
    return total


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Pre-resolved plan for one GEMM shape (block None on the torch backend).

    (m, n, k) is the shape the kernel executes: under a mesh the local
    per-shard shape, and ``logical`` the global shape it came from (empty
    when planned unsharded or the mesh splits nothing)."""

    m: int
    n: int
    k: int
    block: Optional[MatmulBlock]
    logical: tuple = ()


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Pre-resolved plan for one conv layer.

    route: "direct" (CUDA direct conv), "im2col" (GEMM route) or "torch".
    tau: output channels per block of the direct route (0 on GEMM routes).
    cin_chunk: Cin the direct kernel stages per step (0: the kernel's
        largest fitting chunk; under a TpuSpec plan, no chunk).
    tile_rows / tile_cols: each block's output tile (0 = the kernel's own
        default); halo_mode: "none" | "two_block" | "dma".
    vmem_bytes: on-chip working set of the route (shared memory per block
        under a GpuSpec).
    conv_route: the direct conv's route under a GpuSpec (``CONV_ROUTES``:
        "cudacore" or "tc", for float and fixed point alike; "" otherwise).
        Route "tc" walks sub-tiles of sub_rows x sub_cols pixels and cuts its
        Cin chunks ``splits`` ways.
    halo: a cross-shard spatial seam (a ``SpatialHalo``): the layer runs per
        H slab in the slab-major (S, N, lx, W, C) layout through
        :meth:`Engine._conv2d_spatial`; ``pad`` is then 0 (the exchange's
        zero fill is the H padding, and W is pre-padded by ``halo.pad``).
    """

    route: str
    stride: int
    pad: int
    tau: int
    block: Optional[MatmulBlock]
    gemm: tuple
    vmem_bytes: int
    tile_rows: int = 0
    spatial_tiles: int = 1
    tile_cols: int = 0
    col_tiles: int = 1
    halo_mode: str = "none"
    cin_chunk: int = 0
    conv_route: str = ""
    splits: int = 1
    sub_rows: int = 0
    sub_cols: int = 0
    halo: Optional[object] = None  # SpatialHalo


def _resolve_pad(padding, kh: int) -> int:
    if isinstance(padding, int):
        return padding
    return {"SAME": kh // 2, "VALID": 0}[padding]


def validate_policy(config, policy: Optional[NumericsPolicy]) -> NumericsPolicy:
    """A quantized policy runs only on the q16 backend; returns the resolved
    policy (float when ``None``)."""
    policy = policy or NumericsPolicy("float")
    if policy.quantized and config.backend != "q16":
        raise ValueError(
            f"NumericsPolicy({policy.name!r}) requires the 'q16' backend, but "
            f"the template is configured with backend={config.backend!r}"
        )
    return policy


class Engine:
    """Executes GEMM / conv plans for one template configuration.

    Holds the shared plan registry and per-engine counters
    (``counters["conv_direct"]`` etc.).
    """

    def __init__(self, config=None, plan_cache: Optional[PlanRegistry] = None) -> None:
        if config is None:
            from .template import TemplateConfig

            config = TemplateConfig()
        self.config = config
        self.plan_cache = plan_cache if plan_cache is not None else plan_cache_for(config.hw)
        self.counters: collections.Counter = collections.Counter()
        # (id(params), policy) -> (params, qparams): weights are quantized
        # once per (param tree, policy); the strong ref prevents id reuse
        self._qparam_cache: dict = {}
        self._calibrating = False
        self._act_maxabs = 0.0

    # -- device --------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    def _check_device(self, *values) -> None:
        """Every operand lies on the configured device: a CUDA template never
        runs plain versions on CPU tensors it was handed by mistake."""
        for v in values:
            t = v.raw if isinstance(v, QTensor) else v
            if t is not None and t.device.type != self.device.type:
                raise ValueError(
                    f"operand on {t.device}, but the template runs on "
                    f"{self.config.device!r}"
                )

    # -- planning ------------------------------------------------------------

    def block_for(self, m: int, n: int, k: int, *, dtype=torch.float32, xbits: int = 16,
                  wbits: int = 16, logical: tuple = ()) -> MatmulBlock:
        """The GEMM plan for one call: config override or cached DSE.  The
        cuda backend plans the float GEMM (its route follows m and
        ``dtype``; ``logical``, a shard's logical shape, fixes its k
        order), the q16 backend the fixed-point GEMM (its route follows
        m, its tile the raws' widths ``xbits`` / ``wbits``; the default,
        16 and 16, plans a tile every width mix takes)."""
        if self.config.block is not None:
            return clamp_block(m, n, k, self.config.block, self.config.hw)
        if self.config.backend == "cuda":
            return self.plan_cache.block_for(
                m, n, k, self.config.hw, kernel="matmul_fp",
                dtype_bytes=torch.finfo(dtype).bits // 8, logical=logical)
        return self.plan_cache.block_for(m, n, k, self.config.hw, xbits=xbits, wbits=wbits,
                                         logical=logical)

    def measure_and_pin(self, m: int, n: int, k: int, *, dtype=torch.float32,
                        xbits: int = 16, wbits: int = 16, **kw) -> MatmulBlock:
        """Measured-time autotune for this engine's spec and GEMM kernel
        (the cuda backend's float GEMM at ``dtype``, the q16 backend's at the
        widths) on its device: :meth:`PlanRegistry.measure_and_pin`, pinned
        under the key :meth:`block_for` reads."""
        kernel = "matmul_fp" if self.config.backend == "cuda" else "matmul_q16"
        return self.plan_cache.measure_and_pin(
            m, n, k, self.config.hw, kernel=kernel,
            dtype_bytes=torch.finfo(dtype).bits // 8, xbits=xbits, wbits=wbits,
            device=self.device, **kw)

    def plan_gemm(self, m: int, n: int, k: int, *, mesh=None,
                  partition=None) -> GemmPlan:
        """Plan one GEMM; with ``mesh`` (and optionally a partition over
        (M, N[, K]); default ``launch.mesh.gemm_partition``) the local
        per-shard shape, with the logical shape's k order (a float plan is
        keyed by both)."""
        logical = ()
        if mesh is not None:
            local = sh.local_gemm_shape(m, n, k, mesh=mesh, partition=partition)
            if local != (m, n, k):
                logical = (m, n, k)
            m, n, k = local
        block = (None if self.config.backend == "torch"
                 else self.block_for(m, n, k, logical=logical))
        return GemmPlan(m=m, n=n, k=k, block=block, logical=logical)

    def plan_gemm_ladder(self, ladder: Sequence[int], n: int, k: int, *,
                         batches: Sequence[int] = (1,), mesh=None,
                         partition=None) -> dict:
        """Plan one GEMM per (batch rung x bucket-ladder rung) product, M =
        batch * rung at fixed N / K: the scheduler's warm-up primitive, so
        every bucket's shape is in the registry before traffic arrives.
        Returns {M: plan}."""
        ms = sorted({int(b) * int(m) for b in batches for m in ladder})
        return {m: self.plan_gemm(m, n, k, mesh=mesh, partition=partition) for m in ms}

    def plan_conv(
        self, x_shape, w_shape, *, stride: int = 1, padding=0,
        route: Optional[str] = None, mesh=None, partition=None, spatial=None,
    ) -> ConvPlan:
        """Pick the kernel route for one conv layer.

        Direct route: the DSE (memoized in the registry) picks the
        configuration for the spec — under H100 the conv's route (a float
        conv with Cin and Cout multiples of 8, or a fixed-point one with Cin
        a multiple of 16 and Cout of 8, on the tensor cores, every other on
        the CUDA cores), τ, the Cin chunk and, on the tensor-core route, the
        sub-tile; this adds that route's Cin split for the batch.
        When no configuration fits, the layer takes the im2col GEMM route
        with a planned tile.  ``route`` forces a route.  With ``mesh`` the
        layer's local shard is planned (batch over the partition's M axes,
        Cout over its N axes).

        ``spatial`` (a shard count, a mesh axis name, or a chained
        ``SpatialHalo``) plans the H-slab partition instead: the kernel runs
        at the halo-augmented ``win``-row window with the padding folded
        into the exchange's zero fill, and the plan carries the seam in
        ``plan.halo``; batch and Cout stay whole, so ``partition`` does not
        apply.
        """
        if spatial is not None:
            n, h, wd, cin = x_shape
            kh = w_shape[0]
            pad = _resolve_pad(padding, kh)
            hs = spatial if isinstance(spatial, sh.SpatialHalo) else sh.plan_spatial_halo(
                h, kh, stride, pad, *sh.spatial_shards(spatial, mesh))
            inner = self.plan_conv((n, hs.win, wd + 2 * pad, cin), w_shape,
                                   stride=stride, padding=0, route=route)
            return dataclasses.replace(inner, halo=hs)
        if mesh is not None:
            x_shape, w_shape = sh.local_conv_shapes(x_shape, w_shape, mesh=mesh,
                                                    partition=partition)
        n, h, wd, cin = x_shape
        kh, kw, _, cout = w_shape
        pad = _resolve_pad(padding, kh)
        hp, wp = h + 2 * pad, wd + 2 * pad
        ho = (hp - kh) // stride + 1
        wo = (wp - kw) // stride + 1
        gemm = (n * ho * wo, cout, cin * kh * kw)
        backend = self.config.backend
        if backend == "torch" or route == "torch":
            return ConvPlan("torch", stride, pad, 0, None, gemm, 0)
        if route != "im2col":
            in_bytes = (self.config.qformat.total_bits // 8) if backend == "q16" else 4
            choice = self.plan_cache.conv_tile_for(
                hp, wp, cin, kh, kw, ho, wo, cout, stride, in_bytes, self.config.hw
            )
            if choice is not None:
                tile_rows = 0 if choice.tile_rows >= ho else choice.tile_rows
                tile_cols = 0 if (choice.tile_cols or wo) >= wo else choice.tile_cols
                halo_mode = choice.halo_mode or ("two_block" if tile_rows else "none")
                splits = 1
                if choice.route == "tc":
                    blocks = dse.gpu_conv_tc_blocks(n, ho, wo, cout, choice.tau,
                                                    choice.sub_rows, choice.sub_cols)
                    splits = dse.gpu_conv_tc_splits(blocks, cin, self.config.hw,
                                                    choice.cin_chunk)
                return ConvPlan(
                    "direct", stride, pad, choice.tau, None, gemm,
                    choice.vmem_bytes, tile_rows, choice.spatial_tiles,
                    tile_cols, choice.col_tiles, halo_mode, choice.cin_chunk,
                    choice.route, splits, choice.sub_rows, choice.sub_cols,
                )
            if route == "direct":
                raise ValueError(
                    f"direct conv route forced but no configuration for "
                    f"{tuple(x_shape)} fits {self.config.hw.name}"
                )
        block = self.block_for(*gemm)
        return ConvPlan("im2col", stride, pad, 0, block, gemm, block.smem_bytes())

    # -- fixed-point residency (the QTensor plane) ---------------------------

    def quant(self, x, fmt: Optional[QFormat] = None) -> QTensor:
        """Float -> QTensor on the activation grid: a counted island exit.
        During :meth:`calibrate_activation_format` it also records max|x|."""
        if isinstance(x, QTensor):
            return x
        self._check_device(x)
        fmt = fmt or self.config.qformat
        self.counters["quantize_calls"] += 1
        if self._calibrating:
            self._act_maxabs = max(self._act_maxabs, float(x.abs().max()))
        return sh.carry_marks(x, QTensor(quantize(x, fmt), fmt))

    def calibrate_activation_format(self, run, *, total_bits: int = 16) -> QFormat:
        """Run ``run()`` (an eager forward over a calibration batch) with
        every :meth:`quant` site recording the magnitude it snaps, then pick
        the smallest Qm.n covering the observed maximum."""
        self._act_maxabs = 0.0
        self._calibrating = True
        try:
            run()
        finally:
            self._calibrating = False
        return calibrate_format(torch.tensor(self._act_maxabs, dtype=torch.float32),
                                total_bits=total_bits)

    def dequant(self, q, fmt: Optional[QFormat] = None,
                dtype=torch.float32) -> torch.Tensor:
        """QTensor (or raw + fmt) -> float: a counted island entry."""
        self.counters["dequantize_calls"] += 1
        if isinstance(q, QTensor):
            return sh.carry_marks(q, dequantize(q.raw, q.fmt, dtype))
        return sh.carry_marks(q, dequantize(q, fmt or self.config.qformat, dtype))

    def quantize_weight(
        self,
        w: torch.Tensor,
        policy: NumericsPolicy,
        fmt: Optional[QFormat] = None,
        contraction_axes: Optional[tuple] = None,
        fused_bias: bool = False,
        act_fmt: Optional[QFormat] = None,
        total_bits: Optional[int] = None,
    ) -> QTensor:
        """Quantize one persistent weight (per-tensor max-abs by default;
        ``fmt`` pins a format).

        With ``contraction_axes`` the accumulator-headroom rule caps the
        fraction so that ``max|x_raw| · L1`` (L1: the largest per-output sum
        of |w_raw| over the contraction) cannot reach 2^31, with one more
        bit of margin under ``fused_bias``; ``act_fmt`` (default
        ``policy.fmt``) sets ``max|x_raw|``.  L1 is an f32 sum, as in the
        reference, so both packages choose the same formats.
        """
        self.counters["weights_quantized"] += 1
        if fmt is not None:
            return quantize_qtensor(w, fmt)
        if not policy.per_tensor_weights:
            return quantize_qtensor(w, policy.fmt)
        act_fmt = act_fmt or policy.fmt
        total_bits = total_bits or act_fmt.total_bits
        max_frac = None
        if contraction_axes:
            l1 = float(torch.amax(torch.sum(torch.abs(w.to(torch.float32)),
                                            dim=contraction_axes)))
            if l1 > 0:
                budget = float(31 - (act_fmt.total_bits - 1) - (1 if fused_bias else 0))
                max_frac = math.floor(budget - math.log2(l1) - 1e-9)
        wfmt = calibrate_format(w, max_frac=max_frac, total_bits=total_bits)
        return QTensor(quantize(w, wfmt), wfmt)

    def qparams_for(self, params, policy: NumericsPolicy, build):
        """Quantize-once parameter cache keyed by param-tree identity:
        ``build()`` runs on the first call for (params, policy) only."""
        validate_policy(self.config, policy)
        key = (id(params), policy)
        ent = self._qparam_cache.get(key)
        if ent is not None and ent[0] is params:
            self.counters["qparam_cache_hits"] += 1
            return ent[1]
        self.counters["qparam_builds"] += 1
        qp = build()
        self._qparam_cache[key] = (params, qp)
        return qp

    def drop_qparams(self, params, policy: NumericsPolicy) -> bool:
        """Release one cached quantized tree."""
        return self._qparam_cache.pop((id(params), policy), None) is not None

    def _quant_operand(self, v) -> QTensor:
        """QTensor passthrough; float operands are quantized inline (counted)."""
        if isinstance(v, QTensor):
            return v
        return self.quant(v)

    def _qbias_operand(self, bias, acc_frac: int):
        """Quantize the bias if needed and align it onto the accumulator:
        returns (raw_or_None, bias_shift_or_None)."""
        if bias is None:
            return None, None
        bias = self._quant_operand(bias)
        bias_shift = acc_frac - bias.fmt.frac_bits
        if bias_shift < 0:
            raise ValueError(
                f"bias format {bias.fmt.name} is finer than the "
                f"2^-{acc_frac} accumulator grid"
            )
        return bias.raw, bias_shift

    # -- shards: the column-parallel GEMM -------------------------------------

    @staticmethod
    def _shard_operands(x, w) -> tuple:
        """Returns (x, w's column mark or None).  A contraction stays whole:
        an ``x`` whose K dim holds a shard (the product of an elementwise
        op on column-parallel outputs) is gathered when ``w`` holds K whole."""
        xk = [mk for mk in sh.shard_marks(x) if mk[0] == -1]
        wk = [mk for mk in sh.shard_marks(w) if mk[0] == -2]
        if xk and not wk:
            x = sh.gather(x, -1, xk[0][1])
        wn = [mk for mk in sh.shard_marks(w) if mk[0] == -1]
        return x, (wn[0] if wn else None)

    @staticmethod
    def _logical_gemm(m: int, n: int, k: int, wn) -> tuple:
        """The logical (m, n, k) of a rank's local GEMM: n from ``w``'s
        column mark, m from the step's data split (``sharding.batch_split``);
        () when the call is its own logical shape."""
        f = sh.active_batch_split() if sh.active_mesh() is not None else 1
        logical = (m * f, wn[2] if wn else n, k)
        return () if logical == (m, n, k) else logical

    def _qmatmul(self, x, w, *, bias=None, relu: bool = False,
                 out_fmt: Optional[QFormat] = None, wide: bool = False,
                 plan: Optional[GemmPlan] = None):
        """Grid-resident GEMM: QTensor in -> QTensor out, the requantize
        epilogue fused in the kernel (shift = fa + fb - fo).  ``wide=True``
        reads the int32 accumulator out and descales it exactly: the final
        logits island, counted as one dequantize."""
        from repro_torch.kernels import ops as kops

        x = self._quant_operand(x)
        w = self._quant_operand(w)
        x, wn = self._shard_operands(x, w)
        out_fmt = out_fmt or x.fmt
        lead = x.shape[:-1]
        k = x.shape[-1]
        n = w.shape[-1]
        x2 = x.reshape(-1, k)
        m = x2.shape[0]
        acc_frac = x.fmt.frac_bits + w.fmt.frac_bits
        b_raw, bias_shift = self._qbias_operand(bias, acc_frac)
        self.counters["gemm_q16"] += 1
        block = plan.block if plan is not None and plan.block is not None else \
            self.block_for(m, n, k, xbits=8 * x.raw.element_size(),
                           wbits=8 * w.raw.element_size(),
                           logical=self._logical_gemm(m, n, k, wn))
        out = kops.matmul_q16(
            x2.raw, w.raw, bias=b_raw, relu=relu, fmt=out_fmt,
            shift=acc_frac - out_fmt.frac_bits, bias_shift=bias_shift,
            wide=wide, block=block,
        )
        marks = () if wn is None else (wn,)
        if wide:
            self.counters["dequantize_calls"] += 1
            # int32 -> f32 rounds to nearest even and 2^-f is exact: the
            # same bits as the reference's out.astype(f32) * 2.0 ** -acc_frac
            return sh.mark_shard((out.float() * 2.0 ** -acc_frac).reshape(*lead, n), marks)
        return sh.mark_shard(QTensor(out.reshape(*lead, n), out_fmt), marks)

    def _qconv2d(self, x, w, *, stride: int = 1, padding=0, bias=None,
                 relu: bool = False, out_fmt: Optional[QFormat] = None,
                 plan: Optional[ConvPlan] = None) -> QTensor:
        """Grid-resident conv (direct or im2col route per the plan)."""
        from repro_torch.kernels import ops as kops

        x = self._quant_operand(x)
        w = self._quant_operand(w)
        out_fmt = out_fmt or x.fmt
        if plan is not None and plan.halo is not None:
            return self._conv2d_spatial(x, w, bias=bias, relu=relu, qout=out_fmt, plan=plan)
        if plan is None:
            plan = self.plan_conv(x.shape, w.shape, stride=stride, padding=padding)
        if plan.route == "torch":
            raise ValueError("grid-resident conv has no torch route (q16 only)")
        acc_frac = x.fmt.frac_bits + w.fmt.frac_bits
        b_raw, bias_shift = self._qbias_operand(bias, acc_frac)
        self.counters["conv_direct" if plan.route == "direct" else "conv_im2col"] += 1
        out = kops.conv2d_q16(
            x.raw, w.raw, bias=b_raw, stride=plan.stride, padding=plan.pad,
            tau=plan.tau, cin_chunk=plan.cin_chunk, relu=relu, fmt=out_fmt,
            shift=acc_frac - out_fmt.frac_bits, bias_shift=bias_shift,
            route=plan.route, block=plan.block, tile_rows=plan.tile_rows,
            tile_cols=plan.tile_cols, halo_mode=plan.halo_mode,
            conv_route=plan.conv_route or "cudacore", splits=plan.splits,
            sub_rows=plan.sub_rows, sub_cols=plan.sub_cols,
        )
        return QTensor(out, out_fmt)

    # -- execution: GEMM -----------------------------------------------------

    def _torch_epilogue(self, out, bias, relu, qout, dtype):
        out = out.to(dtype)
        if bias is not None:
            out = out + bias.to(dtype)
        if relu:
            out = torch.relu(out)
        if qout is not None:
            out = fake_quant_fmt(out, qout)  # STE: the train path stays differentiable
        return out

    def matmul(self, x, w, *, bias=None, relu: bool = False,
               qout: Optional[QFormat] = None, wide: bool = False,
               plan: Optional[GemmPlan] = None):
        """``x @ w`` with fused epilogue; leading dims of x flatten into M.

        QTensor operands take the grid-resident path.  On the q16 backend
        float operands take the legacy per-op path: quantized and
        dequantized every call, counted so the float round trip is visible.
        """
        self._check_device(x, w, bias)
        if isinstance(x, QTensor) or isinstance(w, QTensor):
            return self._qmatmul(x, w, bias=bias, relu=relu, out_fmt=qout,
                                 wide=wide, plan=plan)
        if x.ndim == 1:
            return self.matmul(x[None, :], w, bias=bias, relu=relu, qout=qout,
                               plan=plan)[0]
        x, wn = self._shard_operands(x, w)
        lead = x.shape[:-1]
        k = x.shape[-1]
        n = w.shape[-1]
        x2 = x.reshape(-1, k)
        m = x2.shape[0]
        backend = self.config.backend
        if backend == "torch":
            out = torch.matmul(x2, w.to(x.dtype))
            out = self._torch_epilogue(out, bias, relu, qout, x.dtype)
        elif backend == "cuda":
            from repro_torch.kernels import ops as kops

            self.counters["gemm_cuda"] += 1
            block = plan.block if plan is not None and plan.block is not None else \
                self.block_for(m, n, k, dtype=x.dtype,
                               logical=self._logical_gemm(m, n, k, wn))
            out = kops.matmul_fp(x2.contiguous(), w, bias=bias, relu=relu,
                                 qout=qout, block=block)
        elif backend == "q16":
            from repro_torch.kernels import ops as kops

            self.counters["gemm_q16"] += 1
            self.counters["quantize_calls"] += 2 if bias is None else 3
            self.counters["dequantize_calls"] += 1
            fmt = self.config.qformat
            block = plan.block if plan is not None and plan.block is not None else \
                self.block_for(m, n, k, xbits=fmt.total_bits, wbits=fmt.total_bits,
                               logical=self._logical_gemm(m, n, k, wn))
            # quantize keeps its input's strides; the kernel takes dense raws
            # (the tied head's w is the embedding table's transposed view)
            qres = kops.matmul_q16(
                quantize(x2, fmt).contiguous(), quantize(w, fmt).contiguous(),
                bias=None if bias is None else quantize(bias, fmt),
                relu=relu, fmt=fmt, block=block,
            )
            out = dequantize(qres, fmt, dtype=x.dtype)
        else:  # pragma: no cover - config validation
            raise ValueError(f"unknown backend {backend!r}")
        return sh.mark_shard(out.reshape(*lead, n), () if wn is None else (wn,))

    def linear(self, x, w, b=None, *, relu: bool = False,
               qout: Optional[QFormat] = None, wide: bool = False,
               plan: Optional[GemmPlan] = None):
        return self.matmul(x, w, bias=b, relu=relu, qout=qout, wide=wide, plan=plan)

    # -- execution: conv -----------------------------------------------------

    def conv2d(self, x, w, *, stride: int = 1, padding=0, bias=None,
               relu: bool = False, qout: Optional[QFormat] = None,
               plan: Optional[ConvPlan] = None):
        """NHWC conv through the planned route, epilogue fused.

        x: (N, H, W, Cin), w: (K, K, Cin, Cout) -> (N, Ho, Wo, Cout).
        QTensor operands take the grid-resident path and return a QTensor.
        """
        from repro_torch.kernels import ops as kops

        self._check_device(x, w, bias)
        if plan is not None and plan.halo is not None and not isinstance(x, QTensor):
            return self._conv2d_spatial(x, w, bias=bias, relu=relu, qout=qout, plan=plan)
        if isinstance(x, QTensor) or isinstance(w, QTensor):
            return self._qconv2d(x, w, stride=stride, padding=padding, bias=bias,
                                 relu=relu, out_fmt=qout, plan=plan)
        kh, kw = w.shape[0], w.shape[1]
        if plan is None:
            plan = self.plan_conv(x.shape, w.shape, stride=stride, padding=padding)
        # the plan is the single source of geometry: stride and pad both
        stride, pad = plan.stride, plan.pad
        backend = self.config.backend
        if plan.route == "torch":
            self.counters["conv_torch"] += 1
            xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
            cols, ho, wo = kops.im2col(xp, kh, kw, stride)
            out = torch.matmul(cols, kops.conv_gemm_weights(w).to(x.dtype))
            out = self._torch_epilogue(out, bias, relu, qout, x.dtype)
            return out.reshape(x.shape[0], ho, wo, -1)
        self.counters["conv_direct" if plan.route == "direct" else "conv_im2col"] += 1
        if backend == "cuda":
            return kops.conv2d(
                x, w, bias=bias, stride=stride, padding=pad, tau=plan.tau,
                cin_chunk=plan.cin_chunk, relu=relu, qout=qout, route=plan.route,
                block=plan.block, tile_rows=plan.tile_rows,
                tile_cols=plan.tile_cols, halo_mode=plan.halo_mode,
                conv_route=plan.conv_route or "cudacore", splits=plan.splits,
                sub_rows=plan.sub_rows, sub_cols=plan.sub_cols,
            )
        if backend != "q16":
            raise ValueError(f"unknown backend {backend!r}")
        # legacy per-op fixed point (see matmul)
        self.counters["quantize_calls"] += 2 if bias is None else 3
        self.counters["dequantize_calls"] += 1
        fmt = self.config.qformat
        qres = kops.conv2d_q16(
            quantize(x, fmt), quantize(w, fmt),
            bias=None if bias is None else quantize(bias, fmt),
            stride=stride, padding=pad, tau=plan.tau, cin_chunk=plan.cin_chunk,
            relu=relu, fmt=fmt, route=plan.route, block=plan.block,
            tile_rows=plan.tile_rows, tile_cols=plan.tile_cols,
            halo_mode=plan.halo_mode, conv_route=plan.conv_route or "cudacore",
            splits=plan.splits, sub_rows=plan.sub_rows, sub_cols=plan.sub_cols,
        )
        return dequantize(qres, fmt, dtype=x.dtype)

    def _conv2d_spatial(self, x, w, *, bias, relu, qout, plan: ConvPlan):
        """One spatially-sharded conv seam.

        ``x`` is slab-major (S, N, lx, W, C), a float tensor or a QTensor;
        on a mesh axis (``plan.halo.axis``) this rank's slab, S = 1.  The
        halo rows come from the neighbour slabs, W is pre-padded by the
        conv's ``pad`` (the H zeros came with the exchange), the slabs fold
        into the batch for the planned kernel, and the slab layout comes
        back with the ragged tail shard's rows past the global extent set
        to zero, so the next seam's halo reads stay exact.  No contraction
        crosses a slab, so every output row is the unsharded kernel's.
        """
        hs = plan.halo
        inner = dataclasses.replace(plan, halo=None)
        self.counters["conv_spatial"] += 1
        quant = isinstance(x, QTensor)
        v = sh.constrain_slabs(x.raw if quant else x, hs.axis)
        ext = sh.halo_exchange(v, hs)  # (S, N, win, W, C)
        if hs.pad:
            ext = torch.nn.functional.pad(ext, (0, 0, hs.pad, hs.pad))
        s, n = ext.shape[0], ext.shape[1]
        flat = ext.reshape(s * n, *ext.shape[2:]).contiguous()  # the kernels read dense
        out = self.conv2d(QTensor(flat, x.fmt) if quant else flat, w, bias=bias,
                          relu=relu, qout=qout, plan=inner)
        qres = isinstance(out, QTensor)
        ov = out.raw if qres else out
        ov = ov.reshape(s, n, *ov.shape[1:])
        ov = sh.constrain_slabs(sh.mask_slab_rows(ov, hs), hs.axis)
        return QTensor(ov, out.fmt) if qres else ov
