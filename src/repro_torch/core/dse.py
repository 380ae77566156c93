"""Design-space exploration (paper §III.E), in the port.

The port's copy of ``repro.core.dse``.  Its FPGA plane and the precision DSE
are the reference's line for line, and held to it with ``==``
(``tests/test_torch_fpga.py``, ``tests/test_torch_precision.py``):

* :func:`explore_board` enumerates (μ, τ, 𝒯, ℭ, λ, Ω) within a board's
  DSP / BRAM / LUT / FF envelope and ranks the fitting template instances
  by modeled GOP/s on a network (``fpga_model``);
* :func:`choose_precision` gives each layer the int8 rung where its
  solo-flip argmax agreement meets the budget, else the base grid;
  :func:`search_precision` measures those drifts, reverts int8 layers until
  the composed network meets the budget and pins the plan in the plan
  registry, from which :func:`pinned_precision` replays it (the shared
  body of ``models/cnn.py:calibrate_cnn_precision`` and
  ``models/transformer.py:calibrate_precision``).

Every device-plane search takes a spec:

* Under a :class:`~repro_torch.core.tiling.TpuSpec` the functions are the
  reference's, line for line: ``explore_tpu_block`` ranks Pallas (bm, bn,
  bk) blocks by a roofline score inside the VMEM budget, and
  ``explore_conv_spatial`` ranks (τ, 𝒯, ℭ, halo_mode) direct-conv configs
  by modeled HBM traffic.  ``tests/test_torch_dse.py`` holds them to the
  reference's choices over the whole zoo.
* Under a :class:`~repro_torch.core.tiling.GpuSpec` the candidates are what
  the CUDA kernels take, and legality is the shared memory they really
  use.  Both GEMMs first pick a route from the shape, then the route's
  tile: the float GEMM from the dtype as well
  (:func:`default_fp_block_for`), the q16 GEMM from its operands' widths
  (:func:`default_q16_block_for`).  The conv picks its route (the tensor
  cores where :func:`gpu_conv_tc_legal` admits the conv, float or fixed
  point, else the CUDA cores), τ and the Cin chunk that
  ``csrc/conv2d.cu`` stages per step; a GPU block always loads exactly its
  own tile's input window (the reference's ``dma`` regime), so the plan
  leaves the output tile to the kernel's default.

Flash attention picks its route from the head dim and the dtype
(:func:`plan_flash`): the tensor cores for the models' head dims, the CUDA
cores for the reduced configs'.

"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

from .fpga_model import Board, LayerSpec, TemplateInstance, evaluate_network
from .tiling import (
    ConvTiling,
    FCTiling,
    GpuSpec,
    MatmulBlock,
    Spec,
    TPU_V5E,
    TpuSpec,
    ceil_div,
    clamp_block,
)

__all__ = [
    "DseResult",
    "ConvTileChoice",
    "FlashPlan",
    "choose_precision",
    "pinned_precision",
    "search_precision",
    "explore_board",
    "explore_tpu_block",
    "explore_conv_spatial",
    "default_block_for",
    "default_fp_block_for",
    "default_q16_block_for",
    "fp_block_legal",
    "q16_block_legal",
    "q16_limb_products",
    "default_conv_tile_for",
    "conv_choice_from_doc",
    "conv_choice_to_doc",
    "explore_gemm_plans",
    "direct_conv_vmem",
    "direct_conv_hbm_traffic",
    "direct_conv_ideal_traffic",
    "direct_conv_input_traffic",
    "gpu_conv_subtile",
    "gpu_conv_smem",
    "gpu_conv_max_chunk",
    "gpu_conv_tc_blocks",
    "gpu_conv_q16_tc_smem",
    "gpu_conv_tc_legal",
    "gpu_conv_tc_smem",
    "gpu_conv_tc_splits",
    "gpu_conv_tc_subtile",
    "gpu_conv_tc_tau",
    "gpu_flash_smem",
    "plan_flash",
]


# ---------------------------------------------------------------------------
# FPGA plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DseResult:
    instance: TemplateInstance
    gops: float
    latency_ms: float

    @property
    def mu(self) -> int:
        return self.instance.conv.mu

    @property
    def tau(self) -> int:
        return self.instance.conv.tau


def explore_board(
    board: Board,
    layers: Sequence[LayerSpec],
    name: str = "net",
    mu_range: Sequence[int] = (4, 8, 12, 16, 20, 24, 28, 32),
    tau_range: Sequence[int] = (8, 12, 16, 20, 24, 30, 36, 44, 55, 64),
    spatial_tiles: Sequence[int] = (13, 14, 26, 27, 28),
    fc_tiles: Sequence[tuple[int, int]] = ((1024, 64), (2048, 128), (4096, 256)),
    top: int = 10,
) -> list[DseResult]:
    """Exhaustive grid search over the template parameter space for a board:
    every fitting instance, ranked by modeled GOP/s on ``layers`` (a stable
    sort, so ties keep the enumeration order)."""
    results: list[DseResult] = []
    for mu, tau in itertools.product(mu_range, tau_range):
        if mu * tau > board.dsp:
            continue
        for t_spatial in spatial_tiles:
            conv = ConvTiling(t_r=t_spatial, t_c=t_spatial, mu=mu, tau=tau)
            for lam, omega in fc_tiles:
                fc = FCTiling(lam=lam, omega=omega, mu=mu, tau=tau)
                inst = TemplateInstance(board=board, conv=conv, fc=fc)
                if not inst.fits():
                    continue
                rep = evaluate_network(name, layers, inst)
                results.append(
                    DseResult(instance=inst, gops=rep.gops, latency_ms=rep.latency_ms)
                )
    results.sort(key=lambda r: -r.gops)
    return results[:top]


# ---------------------------------------------------------------------------
# GEMM blocks
# ---------------------------------------------------------------------------


def _block_score(
    block: MatmulBlock, m: int, n: int, k: int, spec: TpuSpec, dtype_bytes: int = 2
) -> float:
    """Roofline score for one grid step of the tiled matmul (TPU)."""
    ridge = spec.peak_bf16_flops / spec.hbm_bw
    ai = block.arithmetic_intensity(dtype_bytes)
    waste = (
        (m / (max(1, -(-m // block.bm)) * block.bm))
        * (n / (max(1, -(-n // block.bn)) * block.bn))
        * (k / (max(1, -(-k // block.bk)) * block.bk))
    )
    return block.mxu_efficiency(spec) * min(1.0, ai / ridge) * waste


def _gpu_block_score(block: MatmulBlock, m: int, n: int, spec: GpuSpec) -> float:
    """Score of one compiled GEMM tile on the card: the share of computed
    outputs that are real (ragged-edge waste) x the share of SMs the grid
    fills x the tile's operand reuse (bm·bn / (bm + bn), relative to the
    largest compiled tile's)."""
    waste = (m / (ceil_div(m, block.bm) * block.bm)) * (
        n / (ceil_div(n, block.bn) * block.bn)
    )
    blocks = ceil_div(m, block.bm) * ceil_div(n, block.bn)
    fill = min(1.0, blocks / spec.sms)
    reuse = max(bm * bn / (bm + bn) for bm, bn, _ in spec.gemm_tiles)
    return waste * fill * (block.bm * block.bn / (block.bm + block.bn)) / reuse


def explore_tpu_block(
    m: int,
    n: int,
    k: int,
    spec: Spec = TPU_V5E,
    dtype_bytes: int = 2,
    bm_range: Sequence[int] = (128, 256, 512, 1024),
    bn_range: Sequence[int] = (128, 256, 512, 1024, 2048),
    bk_range: Sequence[int] = (128, 256, 512, 1024, 2048),
    top: int = 5,
) -> list[tuple[MatmulBlock, float]]:
    """Enumerate legal blocks for an (m, n, k) GEMM; rank by score.  Under a
    GpuSpec the candidates are the kernel's compiled tiles."""
    out: list[tuple[MatmulBlock, float]] = []
    if isinstance(spec, GpuSpec):
        for bm, bn, bk in spec.gemm_tiles:
            block = MatmulBlock(bm=bm, bn=bn, bk=bk)
            if block.legal(m, n, k, spec):
                out.append((block, _gpu_block_score(block, m, n, spec)))
        out.sort(key=lambda t: (-t[1], -t[0].bm, -t[0].bn))
        return out[:top]
    for bm, bn, bk in itertools.product(bm_range, bn_range, bk_range):
        block = MatmulBlock(bm=bm, bn=bn, bk=bk)
        if not block.legal(m, n, k, spec):
            continue
        out.append((block, _block_score(block, m, n, k, spec, dtype_bytes)))
    out.sort(key=lambda t: -t[1])
    return out[:top]


def default_block_for(m: int, n: int, k: int, spec: Spec = TPU_V5E) -> MatmulBlock:
    """Best-scoring legal block, with a safe fallback for tiny problems."""
    ranked = explore_tpu_block(m, n, k, spec)
    if ranked:
        return ranked[0][0]
    if isinstance(spec, GpuSpec):
        raise ValueError(f"no compiled GEMM tile of {spec.name} is legal")
    return clamp_block(m, n, k, MatmulBlock(128, 128, 128), spec)


#: route "splitk"'s planning targets: a grid of ``_SPLITK_WAVES`` blocks per
#: SM, k slices of at least ``_SPLITK_MIN_SLICE`` rows (a multiple of the
#: header's ``SLICE_ALIGN``, 64) and at most ``_SPLITK_X_BYTES`` of x staged
#: in f32: the room a block keeps for its cross-row sums anyway (the
#: header's ``RED_BYTES``), so x never adds to a block's shared memory
_SPLITK_WAVES = 4
_SPLITK_MIN_SLICE = 128
_SPLITK_X_BYTES = 32 * 1024


def _splitk_block(m: int, n: int, k: int, spec: GpuSpec) -> MatmulBlock:
    """Route "splitk" of either GEMM: pad m to a compiled row count, then cut
    k into as many slices as put about ``_SPLITK_WAVES`` blocks on each SM.
    x is staged in 4-byte values (f32, or int32 for the q16 GEMM)."""
    rows = min(r for r in spec.splitk_rows if r >= m)
    want = max(1, ceil_div(_SPLITK_WAVES * spec.sms, ceil_div(n, spec.splitk_cols)))
    most = _SPLITK_X_BYTES // (4 * rows) // 64 * 64
    piece = max(_SPLITK_MIN_SLICE, ceil_div(ceil_div(k, want), 64) * 64)
    piece = min(piece, most, ceil_div(k, 64) * 64)
    return MatmulBlock(rows, spec.splitk_cols, piece, route="splitk",
                       splits=ceil_div(k, piece))


def _wgmma_block(m: int, n: int, spec: GpuSpec) -> MatmulBlock:
    """Route "wgmma": the compiled tile with the best :func:`_gpu_block_score`
    among ``wgmma_tiles`` (ragged-edge waste, SM fill, operand reuse), the
    wider on a tie."""
    bm, bn, bk = max(spec.wgmma_tiles, key=lambda t: (
        _gpu_block_score(MatmulBlock(*t), m, n, spec), t[1]))
    return MatmulBlock(bm, bn, bk, route="wgmma")


def _local_fp_block(m: int, n: int, k: int, logical: tuple, spec: GpuSpec, *,
                    dtype_bytes: int) -> MatmulBlock:
    """A shard's plan: the logical shape's route and k order, the rest picked
    at the local shape.

    The float GEMM's sums depend on how k is cut: route "splitk" sums its
    ``splits`` slices of ``bk`` rows in slice order, and route "splitk" sizes
    them from n (``want`` blocks per SM), so a column shard planned at its
    own n would cut k finer and sum in another order.  Here the route, ``bk``
    and ``splits`` are the logical plan's; only what leaves the order as it
    is follows the local shape: split-k's padded row count, the output tile
    of "wgmma" / "tile" among the compiled tiles of that ``bk``.  Raises
    when the local shape cannot take the logical route.
    """
    if logical[2] != k:
        raise ValueError(f"a local GEMM keeps its contraction whole: local k={k}, "
                         f"logical {tuple(logical)}")
    want = default_fp_block_for(*logical, spec, dtype_bytes=dtype_bytes)
    if want.route == "splitk":
        rows = min(r for r in spec.splitk_rows if r >= m)
        blk = MatmulBlock(rows, spec.splitk_cols, want.bk, route="splitk",
                          splits=want.splits)
    else:
        tiles = spec.wgmma_tiles if want.route == "wgmma" else spec.gemm_tiles
        same = [MatmulBlock(*t, route=want.route) for t in tiles if t[2] == want.bk]
        ok = [b for b in same
              if fp_block_legal(b, m, n, k, dtype_bytes=dtype_bytes, spec=spec)]
        blk = max(ok, key=lambda b: (_gpu_block_score(b, m, n, spec), b.bn),
                  default=None)
    if blk is None or not fp_block_legal(blk, m, n, k, dtype_bytes=dtype_bytes, spec=spec):
        raise ValueError(f"the local GEMM ({m}, {n}, {k}) cannot keep the k order of "
                         f"its logical plan {want} for {tuple(logical)}")
    return blk


def default_fp_block_for(m: int, n: int, k: int, spec: Spec = TPU_V5E, *,
                         dtype_bytes: int = 4, logical: tuple = ()) -> MatmulBlock:
    """The float GEMM's plan for one call: its route, then the route's tile.

    Under a GpuSpec: m <= ``splitk_max_m`` streams w on route "splitk" (any
    dtype); bf16 (``dtype_bytes`` 2) with any larger m and k, n multiples
    of 8 takes the tensor cores on route "wgmma" (on an H100 it ran ahead of
    the CUDA-core tile from m = 17 up); everything else
    (f32 with larger m, bf16 that TMA cannot address) the block-tiled route
    "tile" with :func:`default_block_for`'s tile.  Every route reads w in
    either layout, (k, n) or the transposed view of an (n, k) matrix, with
    the same plan.  Under a TpuSpec it is :func:`default_block_for`.

    ``logical``: the (m, n, k) a shard's local call belongs to; the plan
    then keeps that shape's k order (:func:`_local_fp_block`).
    """
    if not isinstance(spec, GpuSpec):
        return default_block_for(m, n, k, spec)
    if logical and tuple(logical) != (m, n, k):
        return _local_fp_block(m, n, k, tuple(logical), spec, dtype_bytes=dtype_bytes)
    if m <= spec.splitk_max_m:
        return _splitk_block(m, n, k, spec)
    if dtype_bytes == 2 and k % 8 == 0 and n % 8 == 0:
        return _wgmma_block(m, n, spec)
    return default_block_for(m, n, k, spec)


def _splitk_legal(block: MatmulBlock, m: int, k: int, spec: GpuSpec) -> bool:
    return (block.bm in spec.splitk_rows and m <= block.bm
            and block.bn == spec.splitk_cols and block.bk % 64 == 0
            and block.splits == ceil_div(k, block.bk)
            and block.bm * block.bk * 4 <= spec.smem_per_block)


def fp_block_legal(block: MatmulBlock, m: int, n: int, k: int, *, dtype_bytes: int,
                   spec: GpuSpec) -> bool:
    """Whether the float GEMM kernel takes ``block`` for this call: a
    compiled tile of its route, the route's conditions on the call, and the
    shared memory of a block where the plan sets it (route "tile": the
    tile; "splitk": x's slice, staged in f32; a "wgmma" tile's is fixed)."""
    tile = (block.bm, block.bn, block.bk)
    if block.route == "tile":
        return (tile in spec.gemm_tiles and block.splits == 1
                and block.smem_bytes() <= spec.smem_per_block)
    if block.route == "wgmma":
        return (tile in spec.wgmma_tiles and block.splits == 1 and dtype_bytes == 2
                and k % 8 == 0 and n % 8 == 0)
    if block.route == "splitk":
        return _splitk_legal(block, m, k, spec)
    return False


def q16_limb_products(xbits: int, wbits: int) -> int:
    """The s8 / u8 wgmmas one k step of route "wgmma" issues for a width
    mix: an int16 operand is two limbs (a signed high byte, an unsigned low
    one), an int8 operand one, so 4, 2 or 1."""
    for bits in (xbits, wbits):
        if bits not in (8, 16):
            raise ValueError(f"the q16 GEMM takes 8- or 16-bit raws, not {bits}")
    return (xbits // 8) * (wbits // 8)


def _q16_wgmma_tile_legal(tile, xbits: int, wbits: int, spec: GpuSpec) -> bool:
    """BN 64 takes every width mix; a wider tile only mixes with at most two
    limb products (int16 x int16 keeps three s32 accumulators, hh, hl + lh
    and ll, which at BN 128 would be 192 registers a thread)."""
    return tile in spec.q16_wgmma_tiles and (
        tile[1] <= 64 or q16_limb_products(xbits, wbits) <= 2)


def default_q16_block_for(m: int, n: int, k: int, spec: Spec = TPU_V5E, *,
                          xbits: int = 16, wbits: int = 16) -> MatmulBlock:
    """The q16 GEMM's plan for one call: its route, then the route's tile.

    Under a GpuSpec: m <= ``splitk_max_m`` streams w on route "splitk"
    (the same plan for every width mix: x is staged as int32); every larger
    m, at any k and n, takes the tensor cores on route "wgmma" (its
    preparation launch pads k), on the legal tile of ``q16_wgmma_tiles`` for
    the widths with the best :func:`_gpu_block_score`, the wider on a tie.
    A plan for the default widths (16, 16) is legal for every mix.  Route
    "tile" is taken only when a caller names it.  Under a TpuSpec it is
    :func:`default_block_for`, the reference's block.
    """
    if not isinstance(spec, GpuSpec):
        return default_block_for(m, n, k, spec)
    if m <= spec.splitk_max_m:
        return _splitk_block(m, n, k, spec)
    tiles = [t for t in spec.q16_wgmma_tiles if _q16_wgmma_tile_legal(t, xbits, wbits, spec)]
    bm, bn, bk = max(tiles, key=lambda t: (
        _gpu_block_score(MatmulBlock(*t), m, n, spec), t[1]))
    return MatmulBlock(bm, bn, bk, route="wgmma")


def q16_block_legal(block: MatmulBlock, m: int, n: int, k: int, *, xbits: int,
                    wbits: int, spec: GpuSpec) -> bool:
    """Whether the q16 GEMM kernel takes ``block`` for this call: route
    "tile" one of the compiled tiles, "splitk" the route's row counts,
    columns and k slices (as the float GEMM's), "wgmma" a compiled tile that
    takes this width mix, at any m, n and k."""
    tile = (block.bm, block.bn, block.bk)
    if block.route == "tile":
        return (tile in spec.gemm_tiles and block.splits == 1
                and block.smem_bytes() <= spec.smem_per_block)
    if block.route == "wgmma":
        return block.splits == 1 and _q16_wgmma_tile_legal(tile, xbits, wbits, spec)
    if block.route == "splitk":
        return _splitk_legal(block, m, k, spec)
    return False


def explore_gemm_plans(m: int, n: int, k: int, spec: Spec = TPU_V5E, *,
                       kernel: str = "matmul_fp", dtype_bytes: int = 4, xbits: int = 16,
                       wbits: int = 16, top: int = 3) -> list[MatmulBlock]:
    """The legal plans of one GEMM kernel for one call, best first: the
    candidates ``measure_and_pin`` times.

    Under a TpuSpec: :func:`explore_tpu_block`'s blocks (the reference's).
    Under a GpuSpec: the planner's own pick first, then its route's other
    plans, then the other routes' in the planner's route order (for m <=
    ``splitk_max_m``: "splitk", "wgmma", "tile"; above: "wgmma", "tile").
    Route "splitk" offers slices of half, twice and four times the planned
    one and the whole of k, ranked by how near their grid comes to the
    planner's ``_SPLITK_WAVES`` blocks per SM; routes "wgmma" and "tile"
    offer each compiled tile, ranked by :func:`_gpu_block_score`.  Every
    plan is legal for the kernel (:func:`fp_block_legal` /
    :func:`q16_block_legal`)."""
    if kernel not in ("matmul_fp", "matmul_q16"):
        raise ValueError(f"no GEMM kernel {kernel!r}")
    if not isinstance(spec, GpuSpec):
        return [blk for blk, _ in explore_tpu_block(m, n, k, spec, top=top)]
    fp = kernel == "matmul_fp"
    if fp:
        analytic = default_fp_block_for(m, n, k, spec, dtype_bytes=dtype_bytes)

        def legal(blk):
            return fp_block_legal(blk, m, n, k, dtype_bytes=dtype_bytes, spec=spec)
    else:
        analytic = default_q16_block_for(m, n, k, spec, xbits=xbits, wbits=wbits)

        def legal(blk):
            return q16_block_legal(blk, m, n, k, xbits=xbits, wbits=wbits, spec=spec)

    by_route: dict = {"splitk": [], "wgmma": [], "tile": []}
    if m <= spec.splitk_max_m:
        base = _splitk_block(m, n, k, spec)
        target = _SPLITK_WAVES * spec.sms
        cols = ceil_div(n, spec.splitk_cols)
        whole = ceil_div(k, 64) * 64
        pieces = {base.bk, base.bk // 2, 2 * base.bk, 4 * base.bk, whole}
        plans = [dataclasses.replace(base, bk=p, splits=ceil_div(k, p))
                 for p in sorted(pieces) if 64 <= p <= whole and p % 64 == 0]
        by_route["splitk"] = sorted(plans, key=lambda b: (abs(cols * b.splits - target),
                                                          b.bk))
    tiles = spec.wgmma_tiles if fp else spec.q16_wgmma_tiles
    for route, compiled in (("wgmma", tiles), ("tile", spec.gemm_tiles)):
        by_route[route] = sorted(
            (MatmulBlock(*t, route=route) for t in compiled),
            key=lambda b: (-_gpu_block_score(b, m, n, spec), -b.bn, -b.bm))
    order = ("splitk", "wgmma", "tile") if m <= spec.splitk_max_m else ("wgmma", "tile")
    ranked = [analytic]
    for route in order:
        ranked += [blk for blk in by_route[route] if blk != analytic and legal(blk)]
    return ranked[:top]


# ---------------------------------------------------------------------------
# direct conv: the TPU model (the reference's, unchanged)
# ---------------------------------------------------------------------------


def _eff_tiles(ho: int, wo: int, tile_rows: int, tile_cols: int):
    th = tile_rows if 0 < tile_rows < ho else ho
    tw = tile_cols if 0 < tile_cols < wo else wo
    return th, tw


def _infer_halo_mode(ho: int, wo: int, th: int, tw: int, halo_mode) -> str:
    if halo_mode is not None:
        return halo_mode
    if tw < wo:
        return "dma"
    return "two_block" if th < ho else "none"


def direct_conv_vmem(
    hp: int, wp: int, cin: int, kh: int, kw: int, ho: int, wo: int, tau: int,
    in_bytes: int, acc_bytes: int = 4, *, stride: int = 1, tile_rows: int = 0,
    tile_cols: int = 0, halo_mode: Optional[str] = None,
) -> int:
    """VMEM working set of one TPU direct-conv grid step (double-buffered
    I/O) in the three regimes "none" / "two_block" / "dma"."""
    th, tw = _eff_tiles(ho, wo, tile_rows, tile_cols)
    mode = _infer_halo_mode(ho, wo, th, tw, halo_mode)
    if mode == "none":
        x = hp * wp * cin * in_bytes * 2
    elif mode == "two_block":
        if tw < wo:
            raise ValueError("two_block halo cannot tile columns (use 'dma')")
        rows = 2 * stride * th
        x = rows * wp * cin * in_bytes * 3
    elif mode == "dma":
        rows_in = min(hp, stride * th + kh - stride)
        cols_in = min(wp, stride * tw + kw - stride)
        x = 2 * rows_in * cols_in * cin * in_bytes
    else:
        raise ValueError(f"unknown halo_mode {mode!r}")
    w = kh * kw * cin * tau * in_bytes * 2
    acc = th * tw * tau * acc_bytes
    out = th * tw * tau * in_bytes * 2
    return x + w + acc + out


def direct_conv_hbm_traffic(
    hp: int, wp: int, cin: int, kh: int, kw: int, ho: int, wo: int, cout: int,
    stride: int, tau: int, in_bytes: int, *, tile_rows: int = 0,
    tile_cols: int = 0, halo_mode: Optional[str] = None,
) -> int:
    """Modeled HBM bytes one TPU forward of the layer moves (image per τ-way
    and per halo regime, weight slab per spatial tile, padded write-back)."""
    th, tw = _eff_tiles(ho, wo, tile_rows, tile_cols)
    mode = _infer_halo_mode(ho, wo, th, tw, halo_mode)
    coutp = ceil_div(cout, tau) * tau
    ways = coutp // tau
    tiles_r = ceil_div(ho, th)
    tiles_c = ceil_div(wo, tw)
    tiles = tiles_r * tiles_c
    if mode == "none":
        x_traffic = ways * hp * wp * cin
    elif mode == "two_block":
        x_traffic = ways * tiles_r * 2 * stride * th * wp * cin
    elif mode == "dma":
        rows_in = min(hp, stride * th + kh - stride)
        cols_in = min(wp, stride * tw + kw - stride)
        x_traffic = ways * tiles * rows_in * cols_in * cin
    else:
        raise ValueError(f"unknown halo_mode {mode!r}")
    w_traffic = tiles * kh * kw * cin * coutp
    out_traffic = tiles * th * tw * coutp
    return (x_traffic + w_traffic + out_traffic) * in_bytes


def direct_conv_input_traffic(
    hp: int, wp: int, cin: int, kh: int, kw: int, ho: int, wo: int, cout: int,
    stride: int, tau: int, in_bytes: int, *, tile_rows: int = 0,
    tile_cols: int = 0, halo_mode: Optional[str] = None,
) -> int:
    """The input-stream component of :func:`direct_conv_hbm_traffic`."""
    full = direct_conv_hbm_traffic(
        hp, wp, cin, kh, kw, ho, wo, cout, stride, tau, in_bytes,
        tile_rows=tile_rows, tile_cols=tile_cols, halo_mode=halo_mode,
    )
    th, tw = _eff_tiles(ho, wo, tile_rows, tile_cols)
    coutp = ceil_div(cout, tau) * tau
    tiles = ceil_div(ho, th) * ceil_div(wo, tw)
    w_out = tiles * (kh * kw * cin * coutp + th * tw * coutp) * in_bytes
    return full - w_out


def direct_conv_ideal_traffic(
    hp: int, wp: int, cin: int, kh: int, kw: int, ho: int, wo: int, cout: int,
    in_bytes: int,
) -> int:
    """Lower-bound bytes: image + weights + output each touched once."""
    return (hp * wp * cin + kh * kw * cin * cout + ho * wo * cout) * in_bytes


@dataclasses.dataclass(frozen=True)
class ConvTileChoice:
    """One legal direct-conv configuration (τ, 𝒯, ℭ, regime).

    ``vmem_bytes`` is the on-chip working set the spec's kernel needs: VMEM
    under a TpuSpec, shared memory per block under a GpuSpec.  ``cin_chunk``
    is the Cin slice the CUDA kernel stages per step (0 under a TpuSpec,
    where no regime splits Cin).  Under a GpuSpec ``route`` names the
    conv's route (``CONV_ROUTES``); route "tc" also plans the sub-tile of
    ``sub_rows`` x ``sub_cols`` output pixels its blocks walk, and the
    ``splits`` its Cin chunks are cut into across blocks.
    """

    tau: int
    tile_rows: int
    spatial_tiles: int
    vmem_bytes: int
    score: float
    tile_cols: int = 0
    col_tiles: int = 1
    halo_mode: str = ""
    cin_chunk: int = 0
    route: str = ""
    splits: int = 1
    sub_rows: int = 0
    sub_cols: int = 0


def conv_choice_to_doc(choice: ConvTileChoice) -> dict:
    """JSON-serializable form of a ConvTileChoice (the plan store's schema:
    the reference's fields and the port's route fields)."""
    return dataclasses.asdict(choice)


def conv_choice_from_doc(doc: dict) -> ConvTileChoice:
    """Inverse of :func:`conv_choice_to_doc`; bit-identical round trip."""
    return ConvTileChoice(
        tau=int(doc["tau"]),
        tile_rows=int(doc["tile_rows"]),
        spatial_tiles=int(doc["spatial_tiles"]),
        vmem_bytes=int(doc["vmem_bytes"]),
        score=float(doc["score"]),
        tile_cols=int(doc.get("tile_cols", 0)),
        col_tiles=int(doc.get("col_tiles", 1)),
        halo_mode=str(doc.get("halo_mode", "")),
        cin_chunk=int(doc.get("cin_chunk", 0)),
        route=str(doc.get("route", "")),
        splits=int(doc.get("splits", 1)),
        sub_rows=int(doc.get("sub_rows", 0)),
        sub_cols=int(doc.get("sub_cols", 0)),
    )


def _conv_tile_score(
    tau: int, th: int, tw: int, halo_mode: str, hp: int, wp: int, cin: int,
    kh: int, kw: int, ho: int, wo: int, cout: int, stride: int, spec: TpuSpec,
    in_bytes: int,
) -> float:
    traffic = direct_conv_hbm_traffic(
        hp, wp, cin, kh, kw, ho, wo, cout, stride, tau, in_bytes,
        tile_rows=th, tile_cols=tw, halo_mode=halo_mode,
    )
    ideal = direct_conv_ideal_traffic(hp, wp, cin, kh, kw, ho, wo, cout, in_bytes)
    rows = th * min(tw, wo)
    m_eff = rows / (ceil_div(rows, spec.mxu_dim) * spec.mxu_dim)
    return ideal / traffic * m_eff


def _tile_ladder(extent: int, lo: int) -> list[int]:
    lo = max(1, min(lo, extent))
    vals = {d for d in range(lo, extent + 1) if extent % d == 0}
    t = extent
    while t > lo:
        vals.add(t)
        t = ceil_div(t, 2)
    vals.add(lo)
    return sorted(vals, reverse=True)


# ---------------------------------------------------------------------------
# direct conv: the GPU model (csrc/conv2d.cu's own formulas)
# ---------------------------------------------------------------------------

#: Each of the conv kernel's 256 threads accumulates 4 pixels x 4 channels,
#: so a block's sub-tile holds 4096 / τ output pixels, laid out as below.
_GPU_SUBTILES = {8: (16, 32), 16: (16, 16), 32: (8, 16), 64: (8, 8),
                 128: (4, 8), 256: (2, 8)}


def gpu_conv_subtile(tau: int) -> tuple[int, int]:
    """(rows, cols) of output pixels one conv block computes per pass."""
    try:
        return _GPU_SUBTILES[tau]
    except KeyError:
        raise ValueError(
            f"conv kernel takes tau in {sorted(_GPU_SUBTILES)}, got {tau}"
        ) from None


def _gpu_window(kh: int, kw: int, stride: int, tau: int) -> tuple[int, int]:
    sh, sw = gpu_conv_subtile(tau)
    return (sh - 1) * stride + kh, (sw - 1) * stride + kw


def gpu_conv_smem(kh: int, kw: int, stride: int, tau: int, cin_chunk: int) -> int:
    """Dynamic shared memory of ``csrc/conv2d.cu``: one pass's input window
    (each channel's plane padded to an odd length) and the kh·kw·chunk·τ
    weight slab, both widened to 4 bytes."""
    rows, cols = _gpu_window(kh, kw, stride, tau)
    plane = rows * cols + (1 - rows * cols % 2)
    return 4 * (plane * cin_chunk + kh * kw * cin_chunk * tau)


def gpu_conv_max_chunk(kh: int, kw: int, stride: int, tau: int, cin: int,
                       smem: int) -> int:
    """The largest Cin chunk (at most 32, at most Cin) that fits ``smem``;
    0 when not even one channel fits."""
    best = 0
    for c in range(1, min(cin, 32) + 1):
        if gpu_conv_smem(kh, kw, stride, tau, c) <= smem:
            best = c
    return best


# ---------------------------------------------------------------------------
# direct conv: the tensor-core route (csrc/conv2d_tc.cuh's own constants)
# ---------------------------------------------------------------------------

#: BM: output pixels of a sub-tile (two consumer warpgroups of 64 rows)
TC_PIXELS = 128
#: CHUNK: Cin per staging step (one 128-byte swizzle row of f32)
TC_CHUNK = 32
#: MAX_BOX: TMA's largest box extent, which bounds the input window
TC_MAX_BOX = 256
#: w_stages<τ>(): weight-ring slots; WIN_STAGES: input windows in flight
_TC_W_STAGES = {64: 6, 128: 4}
_TC_WIN_STAGES = 2
#: sub-tile widths tried (each capped at the region's width)
_TC_WIDTHS = (8, 16, 32, 64, 128)

#: the fixed-point route "tc" (csrc/conv2d_q16_tc.cuh's own constants).
#: CHUNK: Cin per staging step (one swizzle row: 64 int16 or int8 channels)
TC_Q16_CHUNK = 64
#: TAU: Cout a work item, for every width mix (int16 x int16 keeps three s32
#: accumulators, hh, hl + lh and ll: 96 registers a thread at τ 64)
TC_Q16_TAU = 64
#: TPS: taps a step; W_RING: the weight ring's bytes, in at most 8 slots
#: of TPS x limbs x τ x 64
_TC_Q16_TAPS = 3
_TC_Q16_W_RING = 98304
_TC_Q16_MAX_W_STAGES = 8
#: the raws' widths in bytes a fixed-point policy may give a layer
_Q16_BYTES = (1, 2)


def gpu_conv_tc_legal(cin: int, cout: int, in_bytes: int) -> bool:
    """Whether a tensor-core route takes a conv of ``in_bytes`` operands:
    f32 (4) with Cin and Cout multiples of 8 (TMA's 16-byte rows; one TF32
    k-step), or int16 / int8 raws (2 / 1) with Cin·bytes a multiple of 16
    (TMA's 16-byte rows of NHWC x) and Cout a multiple of 8 (the pairs of
    the write-back).  Fixed point takes "tc" as well as float."""
    if cout % 8:
        return False
    if in_bytes == 4:
        return cin % 8 == 0
    return in_bytes in _Q16_BYTES and cin * in_bytes % 16 == 0


def gpu_conv_q16_tc_smem(kh: int, kw: int, stride: int, tau: int, sub_rows: int,
                         sub_cols: int, xbytes: int = 2, wbytes: int = 2) -> int:
    """Dynamic shared memory of ``csrc/conv2d_q16_tc.cuh`` (its
    ``Cfg::smem_bytes``) for raws of ``xbytes`` / ``wbytes``: the weight
    ring (as many slots of 3 taps x wbytes x τ x 64 bytes as fit 96 KB, at
    most 8), two input windows of 64 channels of x each rounded to 1024
    bytes, the two consumer warpgroups' write-back staging (64 rows of τ
    int16 and 16 bytes of padding each), the barriers, and 1024 bytes of
    alignment slack."""
    rows = (sub_rows - 1) * stride + kh
    cols = (sub_cols - 1) * stride + kw
    win = ceil_div(rows * cols * TC_Q16_CHUNK * xbytes, 1024) * 1024
    slot = _TC_Q16_TAPS * wbytes * tau * TC_Q16_CHUNK
    stages = min(_TC_Q16_MAX_W_STAGES, _TC_Q16_W_RING // slot)
    return (1024 + stages * slot + _TC_WIN_STAGES * win + 2 * 64 * (2 * tau + 16)
            + (2 * _TC_WIN_STAGES + 2 * stages) * 8)


def _tc_smem(kh, kw, stride, tau, sub_rows, sub_cols, in_bytes: int) -> int:
    """Route "tc"'s shared memory for a plan: the float header's for f32,
    the fixed-point header's for the width mix that takes the most otherwise
    (a plan made without the raws' widths fits every mix)."""
    if in_bytes == 4:
        return gpu_conv_tc_smem(kh, kw, stride, tau, sub_rows, sub_cols)
    return max(gpu_conv_q16_tc_smem(kh, kw, stride, tau, sub_rows, sub_cols, xb, wb)
               for xb in _Q16_BYTES for wb in _Q16_BYTES)


def gpu_conv_tc_smem(kh: int, kw: int, stride: int, tau: int, sub_rows: int,
                     sub_cols: int) -> int:
    """Dynamic shared memory of ``csrc/conv2d_tc.cuh`` (its ``smem_bytes``):
    the weight ring (hi and lo planes of τ x 32 channels a slot), two input
    windows of 32 channels each rounded to 1024 bytes, the barriers, and
    1024 bytes of alignment slack."""
    rows = (sub_rows - 1) * stride + kh
    cols = (sub_cols - 1) * stride + kw
    win = ceil_div(rows * cols * TC_CHUNK * 4, 1024) * 1024
    stages = _TC_W_STAGES[tau]
    return (1024 + stages * 2 * tau * TC_CHUNK * 4 + _TC_WIN_STAGES * win
            + (2 * _TC_WIN_STAGES + 2 * stages) * 8)


def gpu_conv_tc_tau(cout: int, spec: GpuSpec, in_bytes: int = 4) -> int:
    """The compiled τ that pads Cout least (the larger one on a tie); for
    fixed point (``in_bytes`` 1 or 2) the one τ its header compiles,
    :data:`TC_Q16_TAU`."""
    if in_bytes != 4:
        return TC_Q16_TAU
    return min(spec.conv_tc_taus, key=lambda t: (ceil_div(cout, t) * t, -t))


def gpu_conv_tc_subtile(rh: int, rw: int, kh: int, kw: int, stride: int, tau: int,
                        spec: GpuSpec, in_bytes: int = 4) -> Optional[tuple[int, int]]:
    """(rows, cols) of the sub-tile the blocks of a region of rh x rw output
    pixels walk, or None when no input window fits TMA's box and shared
    memory (:func:`_tc_smem` for ``in_bytes``).  For each width, the most
    rows (at most 128 pixels) whose window fits; of those, the fewest
    sub-tiles over the region, then the smallest input window, then the
    widest rows."""
    best = None
    for tw in sorted({min(w, rw) for w in _TC_WIDTHS}):
        cols = (tw - 1) * stride + kw
        for th in range(min(TC_PIXELS // tw, rh), 0, -1):
            rows = (th - 1) * stride + kh
            if (max(rows, cols) <= TC_MAX_BOX
                    and _tc_smem(kh, kw, stride, tau, th, tw, in_bytes) <= spec.smem_per_block):
                break
        else:
            continue
        key = (ceil_div(rh, th) * ceil_div(rw, tw), rows * cols, -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return None if best is None else best[1]


def gpu_conv_tc_splits(blocks: int, cin: int, spec: GpuSpec, chunk: int = TC_CHUNK) -> int:
    """How many ways to cut the Cin chunks (of ``chunk`` channels: 32 f32,
    64 raws) across blocks.  One when the grid already covers the card (a
    split adds a reduction pass over splits x the output); else the fewest
    waves of blocks times chunks a block (a block fills an SM), the fewest
    splits on a tie."""
    chunks = ceil_div(cin, chunk)
    if blocks >= spec.sms:
        return 1

    def cost(s):
        return ceil_div(blocks * s, spec.sms) * ceil_div(chunks, s), s

    best = min(range(1, chunks + 1), key=cost)
    return ceil_div(chunks, ceil_div(chunks, best))  # no empty split


def gpu_conv_tc_blocks(n: int, ho: int, wo: int, cout: int, tau: int, sub_rows: int,
                       sub_cols: int) -> int:
    """Blocks of an untiled tensor-core conv before any Cin split: one per
    sub-tile of each image and τ slice of Cout."""
    return n * ceil_div(ho, sub_rows) * ceil_div(wo, sub_cols) * ceil_div(cout, tau)


def _tc_choice(ho, wo, kh, kw, cout, stride, spec: GpuSpec,
               in_bytes: int) -> Optional[ConvTileChoice]:
    """A tensor-core route's plan for an untiled conv of ``in_bytes``
    operands (float, or fixed point for every width mix): τ and the
    sub-tile (each block's region); None when no sub-tile's window fits.
    The Cin split depends on the batch, which this search does not see:
    ``Engine.plan_conv`` adds it."""
    tau = gpu_conv_tc_tau(cout, spec, in_bytes)
    sub = gpu_conv_tc_subtile(ho, wo, kh, kw, stride, tau, spec, in_bytes)
    if sub is None:
        return None
    sh, sw = sub
    tiles = ceil_div(ho, sh) * ceil_div(wo, sw)
    ways = ceil_div(cout, tau)
    # the share of the grid's work that is real pixels and channels
    score = (ho * wo / (tiles * TC_PIXELS)) * (cout / (ways * tau))
    return ConvTileChoice(
        tau=tau, tile_rows=ho, spatial_tiles=1,
        vmem_bytes=_tc_smem(kh, kw, stride, tau, sh, sw, in_bytes), score=score,
        tile_cols=wo, col_tiles=1, halo_mode="none",
        cin_chunk=TC_CHUNK if in_bytes == 4 else TC_Q16_CHUNK,
        route="tc", sub_rows=sh, sub_cols=sw,
    )


def _explore_conv_gpu(hp, wp, cin, kh, kw, ho, wo, cout, stride,
                      spec: GpuSpec, in_bytes: int, top: int):
    """A conv whose operands a tensor-core route takes
    (:func:`gpu_conv_tc_legal`: float, or fixed point on every width a
    policy may give the layer, int8 and int16, since the plan does not see
    the raws) and for which one of its sub-tiles fits
    (:func:`gpu_conv_tc_subtile`) is planned on it (its Cin split is the
    engine's, which knows the batch); the CUDA-core route's (τ, Cin chunk)
    follow, ranked by modeled traffic, and serve every other conv.

    CUDA-core ranking: every block re-reads its sub-tile's input window for
    each τ-way and the kh·kw·Cin·τ weight slab for each sub-tile, so small τ
    re-streams the image and large τ the weights; padded channels and pixels
    are wasted work; a grid with fewer blocks than SMs leaves the card idle.
    """
    out = []
    ideal = direct_conv_ideal_traffic(hp, wp, cin, kh, kw, ho, wo, cout, in_bytes)
    for tau in spec.conv_taus:
        if tau > 8 and tau >= 2 * cout:
            continue  # at least half the channels would be padding
        chunk = gpu_conv_max_chunk(kh, kw, stride, tau, cin, spec.smem_per_block)
        if chunk == 0 or spec.conv_threads > spec.threads_per_block:
            continue
        sh, sw = gpu_conv_subtile(tau)
        rows, cols = _gpu_window(kh, kw, stride, tau)
        tiles = ceil_div(ho, sh) * ceil_div(wo, sw)
        coutp = ceil_div(cout, tau) * tau
        ways = coutp // tau
        traffic = tiles * (
            ways * rows * cols * cin + kh * kw * cin * coutp + sh * sw * coutp
        ) * in_bytes
        waste = (cout / coutp) * (ho * wo / (tiles * sh * sw))
        fill = min(1.0, tiles * ways / spec.sms)
        out.append(ConvTileChoice(
            tau=tau, tile_rows=ho, spatial_tiles=1,
            vmem_bytes=gpu_conv_smem(kh, kw, stride, tau, chunk),
            score=ideal / traffic * waste * fill, tile_cols=wo, col_tiles=1,
            halo_mode="none", cin_chunk=chunk, route="cudacore",
        ))
    out.sort(key=lambda c: (-c.score, -c.tau))
    widths = (4,) if in_bytes == 4 else _Q16_BYTES
    tc = (_tc_choice(ho, wo, kh, kw, cout, stride, spec, in_bytes)
          if all(gpu_conv_tc_legal(cin, cout, b) for b in widths) else None)
    if tc is not None:
        out.insert(0, tc)
    return out[:top]


def explore_conv_spatial(
    hp: int,
    wp: int,
    cin: int,
    kh: int,
    kw: int,
    ho: int,
    wo: int,
    cout: int,
    stride: int,
    spec: Spec = TPU_V5E,
    in_bytes: int = 4,
    top: int = 5,
) -> list[ConvTileChoice]:
    """Enumerate legal direct-conv configs and rank them.

    TpuSpec: the reference's (τ, tile_rows, tile_cols, halo_mode) search
    (untiled, row-tiled two-block with ``stride·tile_rows ≥ kh``, and
    (𝒯, ℭ)-tiled DMA).  GpuSpec: (τ, Cin chunk) for the CUDA kernel.
    """
    if isinstance(spec, GpuSpec):
        return _explore_conv_gpu(hp, wp, cin, kh, kw, ho, wo, cout, stride,
                                 spec, in_bytes, top)
    tau0 = min(spec.lane, cout)
    taus = []
    t = tau0
    while True:
        taus.append(t)
        if t <= 8:
            break
        t //= 2
    th_two_min = max(1, ceil_div(kh, stride))
    configs: list[tuple[int, int, str]] = [(ho, wo, "none")]
    for th in _tile_ladder(ho, th_two_min):
        if th < ho and stride * th >= kh:
            configs.append((th, wo, "two_block"))
    for th in _tile_ladder(ho, 1):
        for tw in _tile_ladder(wo, 1):
            if th >= ho and tw >= wo:
                continue
            configs.append((th, tw, "dma"))
    out: list[ConvTileChoice] = []
    for tau, (th, tw, mode) in itertools.product(taus, configs):
        vmem = direct_conv_vmem(
            hp, wp, cin, kh, kw, ho, wo, tau, in_bytes, stride=stride,
            tile_rows=th, tile_cols=tw, halo_mode=mode,
        )
        if vmem > spec.vmem_bytes:
            continue
        score = _conv_tile_score(
            tau, th, tw, mode, hp, wp, cin, kh, kw, ho, wo, cout, stride,
            spec, in_bytes,
        )
        out.append(
            ConvTileChoice(
                tau=tau,
                tile_rows=th,
                spatial_tiles=ceil_div(ho, th),
                vmem_bytes=vmem,
                score=score,
                tile_cols=tw,
                col_tiles=ceil_div(wo, tw),
                halo_mode=mode,
            )
        )
    out.sort(
        key=lambda c: (-c.score, -c.tau, -c.tile_rows, -c.tile_cols, c.halo_mode)
    )
    return out[:top]


def default_conv_tile_for(
    hp: int,
    wp: int,
    cin: int,
    kh: int,
    kw: int,
    ho: int,
    wo: int,
    cout: int,
    stride: int,
    spec: Spec = TPU_V5E,
    in_bytes: int = 4,
) -> Optional[ConvTileChoice]:
    """Best-scoring legal direct-conv config, or None (→ im2col route)."""
    ranked = explore_conv_spatial(
        hp, wp, cin, kh, kw, ho, wo, cout, stride, spec, in_bytes
    )
    return ranked[0] if ranked else None


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: route "wgmma" (csrc/flash_wgmma.cuh): q rows of a block (two consumer
#: warpgroups of 64), K / V tiles in flight, and keys of a kv tile by head dim
_FLASH_WGMMA_BQ = 128
_FLASH_WGMMA_STAGES = 2
_FLASH_WGMMA_BK = {64: 128, 128: 64}
#: route "simt" (csrc/flash_attention.cu): FA_BQ = FA_BK, one tile at a time
_FLASH_SIMT_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Flash attention's kernel for one call: its ``route`` ("simt" or
    "wgmma"), the keys of a kv tile ``bk`` and the block's dynamic
    shared memory ``smem`` in bytes.  The launch passes ``bk`` and ``smem``
    to the route's C entry point, which refuses a plan that differs from
    its own compiled tile."""

    route: str
    bk: int
    smem: int


def gpu_flash_smem(route: str, d: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of a flash block.  "wgmma" (``flash_wgmma.cuh``'s
    ``smem_bytes``): 1024 bytes of alignment slack, the Q tile and two
    stages of K and V tiles in bf16, two planes each for f32 (hi, lo) and
    one for bf16, and the barriers.  "simt" (``flash_attention.cu``'s
    ``fa_smem_floats``): the q, kᵀ, v and p tiles in f32, rows padded by
    one."""
    if route == "wgmma":
        planes = 2 if dtype_bytes == 4 else 1
        bq, bk, st = _FLASH_WGMMA_BQ, _FLASH_WGMMA_BK[d], _FLASH_WGMMA_STAGES
        return 1024 + planes * (bq * d * 2 + st * 2 * bk * d * 2) + (1 + 2 * st) * 8
    b = _FLASH_SIMT_BLOCK
    return 4 * (b * (d + 1) + d * (b + 1) + b * d + b * (b + 1))


def plan_flash(d: int, dtype_bytes: int, spec: Spec) -> FlashPlan:
    """The route of a flash-attention call on a GPU: "wgmma" (the tensor
    cores in split-precision bf16) for the head dims it is compiled for,
    "simt" (the CUDA cores) for the others it takes, f32 (``dtype_bytes``
    4) or bf16 (2).  Any other head dim or dtype raises, as does a TPU spec:
    the reference takes its flash blocks from the caller."""
    if not isinstance(spec, GpuSpec):
        raise TypeError(f"flash attention is planned for a GPU spec, got {spec.name}")
    if dtype_bytes not in (2, 4):
        raise ValueError(f"flash attention takes f32 or bf16, not {dtype_bytes}-byte values")
    if d in spec.flash_wgmma_head_dims:
        route, bk = "wgmma", _FLASH_WGMMA_BK[d]
    elif d in spec.flash_head_dims:
        route, bk = "simt", _FLASH_SIMT_BLOCK
    else:
        raise ValueError(f"flash attention is compiled for head dims "
                         f"{sorted(set(spec.flash_head_dims) | set(spec.flash_wgmma_head_dims))}"
                         f", not {d}")
    smem = gpu_flash_smem(route, d, dtype_bytes)
    if smem > spec.smem_per_block:
        raise ValueError(f"flash route {route} at head dim {d} needs {smem} bytes of "
                         f"shared memory, over the {spec.smem_per_block} a block has")
    return FlashPlan(route, bk, smem)


# ---------------------------------------------------------------------------
# per-layer precision assignment (the drift-aware DSE)
# ---------------------------------------------------------------------------


def choose_precision(drift: dict, budget: float, base_fmt, low_fmt) -> dict:
    """Assign each layer the cheapest activation grid meeting ``budget``.

    ``drift`` maps layer name -> measured *solo-flip* argmax agreement (the
    network's end-to-end agreement with the all-``base_fmt`` reference when
    only that layer drops to ``low_fmt``).  A layer gets ``low_fmt`` (int8:
    half the activation and KV bytes) iff its agreement is >= ``budget``;
    every other layer keeps ``base_fmt``.  Pure and deterministic: the
    callers pin the result in the PlanRegistry with ``source="measured"``
    and the drift attached, so a warm call replays it with no sweep.
    """
    if not 0.0 <= budget <= 1.0:
        raise ValueError(f"precision budget must be in [0, 1], got {budget}")
    return {
        layer: low_fmt if agreement >= budget else base_fmt
        for layer, agreement in drift.items()
    }


def pinned_precision(reg, net: str, names: Sequence[str], spec) -> Optional[tuple]:
    """The precision DSE's warm path: when the registry ``reg`` pins every
    layer of ``names`` under ``spec`` (each found pin a hit), the plan as
    sorted (layer, QFormat) pairs; else None."""
    pins = {name: reg.precision_for(net, name, spec) for name in names}
    if not all(p is not None for p in pins.values()):
        return None
    return tuple(sorted(((n, p.fmt) for n, p in pins.items()), key=lambda kv: kv[0]))


def search_precision(reg, net: str, names: Sequence[str], spec, base_fmt, low_fmt,
                     budget: float, agreement, drift: Optional[dict] = None) -> tuple:
    """The precision DSE's cold path over the named layers of one network.

    ``agreement(plan)`` runs the network under ``plan`` (sorted (layer,
    QFormat) pairs; a layer left out keeps ``base_fmt``) and returns its
    argmax agreement with the reference.  Each layer's solo-flip drift
    onto ``low_fmt`` is measured (``drift`` skips the sweep), the layers
    meeting ``budget`` go to ``low_fmt`` (:func:`choose_precision`), then
    the int8 layer of lowest drift reverts until the *composed* network
    meets the budget: solo-flip drifts compose, and the budget holds for
    the network.  Every choice is pinned in ``reg`` with
    ``source="measured"`` and its drift; returns the plan.
    """
    if drift is None:
        drift = {name: agreement(((name, low_fmt),)) for name in names}
    chosen = choose_precision(drift, budget, base_fmt, low_fmt)

    def full_plan():
        return tuple(sorted(((n, chosen.get(n, base_fmt)) for n in names),
                            key=lambda kv: kv[0]))

    while agreement(full_plan()) < budget:
        int8s = [n for n in names if chosen[n].total_bits == 8]
        if not int8s:
            break
        chosen[min(int8s, key=lambda n: (drift[n], n))] = base_fmt
    for name in names:
        reg.pin_precision(net, name, chosen.get(name, base_fmt), drift=drift.get(name),
                          spec=spec, source="measured")
    return full_plan()
