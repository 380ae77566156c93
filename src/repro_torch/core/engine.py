"""The execution-plan engine: plan-then-execute for the unified compute unit.

The port's copy of ``repro.core.engine`` for one device:

* :class:`PlanRegistry` — memoized DSE choices (GEMM plans per kernel and
  direct-conv configurations) per (shape, spec), with hit and miss
  counters, so a test can assert that a repeated shape costs one search;
  and the precision DSE's per-layer pins (:class:`PrecisionChoice`, keyed
  by (network, layer, spec)), which a warm calibration replays with no
  forward.  It lives in memory: the reference's JSON plan store and
  ``measure_and_pin`` are ROADMAP queue 1 item 2.
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

Mesh and spatial (H-slab) sharding raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch

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
from .tiling import H100, MatmulBlock, Spec, clamp_block

__all__ = [
    "PlanRegistry",
    "PrecisionChoice",
    "ConvPlan",
    "GemmPlan",
    "Engine",
    "batch_rungs",
    "bucket_for",
    "plan_cache_for",
    "register_plan_store",
    "reset_plan_caches",
    "validate_policy",
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


@dataclasses.dataclass(frozen=True)
class PrecisionChoice:
    """One pinned per-layer activation grid (the precision DSE's output).

    ``fmt`` is the layer's *input* activation format (the int8 rung or the
    network's base int16 grid); ``drift`` the measured solo-flip argmax
    agreement that justified it (None for a pin not from a sweep).
    """

    fmt: QFormat
    drift: Optional[float] = None


class PlanRegistry:
    """Memoized DSE selection: GEMM blocks, direct-conv configurations and
    per-layer precision pins.

    ``misses`` counts searches actually run, ``hits`` lookups served from
    the registry: a repeated shape costs exactly one search for the
    registry's lifetime.  Every precision pin carries ``source`` provenance
    (``"measured"``: from a drift sweep).
    """

    def __init__(self) -> None:
        self._blocks: dict = {}
        self._conv_tiles: dict = {}
        self._precision: dict = {}
        self._prec_src: dict = {}
        self.hits = 0
        self.misses = 0

    def block_for(self, m: int, n: int, k: int, spec: Spec = H100, *,
                  kernel: str = "matmul_q16", dtype_bytes: int = 4, xbits: int = 16,
                  wbits: int = 16) -> MatmulBlock:
        """The memoized GEMM plan of one kernel for one call.  The key holds
        the kernel: the float GEMM ("matmul_fp") plans a route from the
        dtype as well (:func:`dse.default_fp_block_for`), the q16 GEMM
        ("matmul_q16") from its operands' widths ``xbits`` / ``wbits``, 8 or
        16, whose limb products shape its tensor-core tile
        (:func:`dse.default_q16_block_for`)."""
        if kernel == "matmul_fp":
            key = (kernel, m, n, k, dtype_bytes, spec)
        elif kernel == "matmul_q16":
            key = (kernel, m, n, k, xbits, wbits, spec)
        else:
            raise ValueError(f"no GEMM kernel {kernel!r}")
        blk = self._blocks.get(key)
        if blk is None:
            self.misses += 1
            if kernel == "matmul_fp":
                blk = dse.default_fp_block_for(m, n, k, spec, dtype_bytes=dtype_bytes)
            else:
                blk = dse.default_q16_block_for(m, n, k, spec, xbits=xbits, wbits=wbits)
            self._blocks[key] = blk
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

    def stats(self) -> dict:
        """Entry counts by kind, the counters, and the measured pins."""
        return {
            "gemm_blocks": len(self._blocks),
            "conv_tiles": len(self._conv_tiles),
            "precision": len(self._precision),
            "hits": self.hits,
            "misses": self.misses,
            "measured": sum(1 for s in self._prec_src.values() if s == "measured"),
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
        self._blocks.clear()
        self._conv_tiles.clear()
        self._precision.clear()
        self._prec_src.clear()
        self.hits = 0
        self.misses = 0


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


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Pre-resolved plan for one GEMM shape (block None on the torch backend)."""

    m: int
    n: int
    k: int
    block: Optional[MatmulBlock]


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


def _no_sharding(mesh, partition=None, spatial=None) -> None:
    if mesh is not None or partition is not None or spatial is not None:
        raise NotImplementedError(
            "mesh / spatial sharding is not ported yet (single device only)"
        )


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
                  wbits: int = 16) -> MatmulBlock:
        """The GEMM plan for one call: config override or cached DSE.  The
        cuda backend plans the float GEMM (its route follows m and
        ``dtype``), the q16 backend the fixed-point GEMM (its route follows
        m, its tile the raws' widths ``xbits`` / ``wbits``; the default,
        16 and 16, plans a tile every width mix takes)."""
        if self.config.block is not None:
            return clamp_block(m, n, k, self.config.block, self.config.hw)
        if self.config.backend == "cuda":
            return self.plan_cache.block_for(
                m, n, k, self.config.hw, kernel="matmul_fp",
                dtype_bytes=torch.finfo(dtype).bits // 8)
        return self.plan_cache.block_for(m, n, k, self.config.hw, xbits=xbits, wbits=wbits)

    def plan_gemm(self, m: int, n: int, k: int, *, mesh=None,
                  partition=None) -> GemmPlan:
        _no_sharding(mesh, partition)
        block = None if self.config.backend == "torch" else self.block_for(m, n, k)
        return GemmPlan(m=m, n=n, k=k, block=block)

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
        with a planned tile.  ``route`` forces a route.
        """
        _no_sharding(mesh, partition, spatial)
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
        return QTensor(quantize(x, fmt), fmt)

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
            return dequantize(q.raw, q.fmt, dtype)
        return dequantize(q, fmt or self.config.qformat, dtype)

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
                           wbits=8 * w.raw.element_size())
        out = kops.matmul_q16(
            x2.raw, w.raw, bias=b_raw, relu=relu, fmt=out_fmt,
            shift=acc_frac - out_fmt.frac_bits, bias_shift=bias_shift,
            wide=wide, block=block,
        )
        if wide:
            self.counters["dequantize_calls"] += 1
            # int32 -> f32 rounds to nearest even and 2^-f is exact: the
            # same bits as the reference's out.astype(f32) * 2.0 ** -acc_frac
            return (out.float() * 2.0 ** -acc_frac).reshape(*lead, n)
        return QTensor(out.reshape(*lead, n), out_fmt)

    def _qconv2d(self, x, w, *, stride: int = 1, padding=0, bias=None,
                 relu: bool = False, out_fmt: Optional[QFormat] = None,
                 plan: Optional[ConvPlan] = None) -> QTensor:
        """Grid-resident conv (direct or im2col route per the plan)."""
        from repro_torch.kernels import ops as kops

        x = self._quant_operand(x)
        w = self._quant_operand(w)
        out_fmt = out_fmt or x.fmt
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
                self.block_for(m, n, k, dtype=x.dtype)
            out = kops.matmul_fp(x2.contiguous(), w, bias=bias, relu=relu,
                                 qout=qout, block=block)
        elif backend == "q16":
            from repro_torch.kernels import ops as kops

            self.counters["gemm_q16"] += 1
            self.counters["quantize_calls"] += 2 if bias is None else 3
            self.counters["dequantize_calls"] += 1
            fmt = self.config.qformat
            block = plan.block if plan is not None and plan.block is not None else \
                self.block_for(m, n, k, xbits=fmt.total_bits, wbits=fmt.total_bits)
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
        return out.reshape(*lead, n)

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
