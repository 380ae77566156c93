"""Design-space exploration, device plane (paper §III.E), in the port.

The port's copy of the device half of ``repro.core.dse``.  Every search
takes a spec:

* Under a :class:`~repro_torch.core.tiling.TpuSpec` the functions are the
  reference's, line for line: ``explore_tpu_block`` ranks Pallas (bm, bn,
  bk) blocks by a roofline score inside the VMEM budget, and
  ``explore_conv_spatial`` ranks (τ, 𝒯, ℭ, halo_mode) direct-conv configs
  by modeled HBM traffic.  ``tests/test_torch_dse.py`` holds them to the
  reference's choices over the whole zoo.
* Under a :class:`~repro_torch.core.tiling.GpuSpec` the candidates are what
  the CUDA kernels take, and legality is the shared memory they really
  use.  The q16 GEMM picks one of the compiled tiles
  (:func:`default_block_for`); the float GEMM first picks its route from
  the shape and the dtype, then the route's tile
  (:func:`default_fp_block_for`).  The conv picks τ and the
  Cin chunk that ``csrc/conv2d.cu`` stages per step; a GPU block always
  loads exactly its own tile's input window (the reference's ``dma``
  regime), so the plan leaves the output tile to the kernel's default.

The FPGA plane (``explore_board``) and ``choose_precision`` are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

from .tiling import (
    GpuSpec,
    MatmulBlock,
    Spec,
    TPU_V5E,
    TpuSpec,
    ceil_div,
    clamp_block,
)

__all__ = [
    "ConvTileChoice",
    "explore_tpu_block",
    "explore_conv_spatial",
    "default_block_for",
    "default_fp_block_for",
    "fp_block_legal",
    "default_conv_tile_for",
    "direct_conv_vmem",
    "direct_conv_hbm_traffic",
    "direct_conv_ideal_traffic",
    "direct_conv_input_traffic",
    "gpu_conv_subtile",
    "gpu_conv_smem",
    "gpu_conv_max_chunk",
]


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
    """Route "splitk": pad m to a compiled row count, then cut k into as many
    slices as put about ``_SPLITK_WAVES`` blocks on each SM."""
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


def default_fp_block_for(m: int, n: int, k: int, spec: Spec = TPU_V5E, *,
                         dtype_bytes: int = 4) -> MatmulBlock:
    """The float GEMM's plan for one call: its route, then the route's tile.

    Under a GpuSpec: m <= ``splitk_max_m`` streams w on route "splitk" (any
    dtype); bf16 (``dtype_bytes`` 2) with any larger m and k, n multiples
    of 8 takes the tensor cores on route "wgmma" (on an H100 it ran ahead of
    the CUDA-core tile from m = 17 up); everything else
    (f32 with larger m, bf16 that TMA cannot address) the block-tiled route
    "tile" with :func:`default_block_for`'s tile.  Every route reads w in
    either layout, (k, n) or the transposed view of an (n, k) matrix, with
    the same plan.  Under a TpuSpec it is :func:`default_block_for`.
    """
    if not isinstance(spec, GpuSpec):
        return default_block_for(m, n, k, spec)
    if m <= spec.splitk_max_m:
        return _splitk_block(m, n, k, spec)
    if dtype_bytes == 2 and k % 8 == 0 and n % 8 == 0:
        return _wgmma_block(m, n, spec)
    return default_block_for(m, n, k, spec)


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
        return (block.bm in spec.splitk_rows and m <= block.bm
                and block.bn == spec.splitk_cols and block.bk % 64 == 0
                and block.splits == ceil_div(k, block.bk)
                and block.bm * block.bk * 4 <= spec.smem_per_block)
    return False


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
    where no regime splits Cin).
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


def _explore_conv_gpu(hp, wp, cin, kh, kw, ho, wo, cout, stride,
                      spec: GpuSpec, in_bytes: int, top: int):
    """Rank (τ, Cin chunk) for the CUDA conv by modeled traffic.

    Every block re-reads its sub-tile's input window for each τ-way and the
    kh·kw·Cin·τ weight slab for each sub-tile, so small τ re-streams the
    image and large τ the weights; padded channels and pixels are wasted
    work; a grid with fewer blocks than SMs leaves the card idle.
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
            halo_mode="none", cin_chunk=chunk,
        ))
    out.sort(key=lambda c: (-c.score, -c.tau))
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
