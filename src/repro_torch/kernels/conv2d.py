"""Direct NHWC convolution, float and fixed point: CUDA kernel wrappers +
plain versions.

Replaces ``repro/kernels/conv2d.py:conv2d_pallas`` (kernel ``_conv_kernel``),
``conv2d_q16_pallas`` (kernel ``_conv_q16_kernel``) and their manual-DMA
regime ``_conv_dma_call`` (kernel ``_conv_dma_kernel``).  Both wrappers
launch ``csrc/conv2d.cu``, whose header says what bounds it on an H100 and
what its design does about that.  Each has two routes (``CONV_ROUTES``),
which the planner picks from the shape: "tc", a tensor-core implicit GEMM
-- in split-precision TF32 for float (``csrc/conv2d_tc.cuh``), as s8 / u8
limb products of the int16 / int8 raws for fixed point
(``csrc/conv2d_q16_tc.cuh``) -- run as a weight-preparation launch, the
conv, and for a Cin split a reduction launch; and "cudacore", the CUDA-core
``conv_kernel``, for the convs "tc" does not take (the first layers).  A
launch that a route does not take raises; no call moves to the other
route.

The reference's three input regimes map onto one kernel:

* a GPU block always stages exactly its own tile's input window, one Cin
  chunk at a time, so ``halo_mode="dma"`` launches the kernel with the
  plan's (tile_rows, tile_cols) as each block's output tile;
* ``"two_block"`` (row tiles at full width) is the same kernel with
  (tile_rows, Wo) tiles, and keeps the reference's legality rule and error
  (``stride·tile_rows ≥ kh``);
* an untiled plan leaves the tile to the kernel: one pass of
  :func:`~repro_torch.core.dse.gpu_conv_subtile` pixels per block (route
  "tc": one sub-tile of :func:`~repro_torch.core.dse.gpu_conv_tc_subtile`);
  a tiled one makes the tile each block's region, which route "tc" walks
  in its sub-tiles.

Zero fill past the image stands in for the reference's explicit pad, which
is exact for both numerics, so the direct route never materialises a padded
copy.  A tile, τ or Cin chunk the kernel cannot take raises; nothing is
reshaped silently.  The wrappers run the plain versions for CPU tensors, and
only for those.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core.dse import (
    TC_CHUNK,
    TC_MAX_BOX,
    TC_PIXELS,
    TC_Q16_CHUNK,
    TC_Q16_TAU,
    gpu_conv_max_chunk,
    gpu_conv_q16_tc_smem,
    gpu_conv_smem,
    gpu_conv_subtile,
    gpu_conv_tc_legal,
    gpu_conv_tc_smem,
    gpu_conv_tc_subtile,
)
from repro_torch.core.quantization import Q2_14, QFormat
from repro_torch.core.tiling import CONV_ROUTES, H100, ceil_div

from . import _build
from ._common import on_cpu, ptr, require_contiguous, stream_of
from .matmul_q16 import check_shifts
from .ref import conv2d_fused_ref, conv_taps_i32, q16_epilogue

__all__ = [
    "ConvLaunch",
    "conv2d_cuda",
    "conv2d_plain",
    "conv2d_q16_cuda",
    "conv2d_q16_plain",
    "conv_launch_geometry",
    "halo_mode_for",
    "launch",
    "launch_q16",
    "launch_q16_tc",
    "launch_tc",
    "prep_q16_tc",
    "prep_tc",
    "q16_tc_planes_for",
]

_BITS = {torch.int8: 8, torch.int16: 16}


def halo_mode_for(tile_rows: int, tile_cols: int, ho: int, wo: int,
                  halo_mode: str) -> str:
    """Validate/normalize the tiled regime of a (tile_rows, tile_cols) pair
    (the reference's ``_halo_mode_for``): "untiled", "two_block" or "dma"."""
    row_tiled = 0 < tile_rows < ho
    col_tiled = 0 < tile_cols < wo
    if not (row_tiled or col_tiled):
        return "untiled"
    if col_tiled and halo_mode != "dma":
        raise ValueError(
            f"tile_cols={tile_cols} requires halo_mode='dma' (the two-block "
            f"scheme only tiles output rows), got {halo_mode!r}"
        )
    if halo_mode == "dma":
        return "dma"
    if halo_mode in ("two_block", "none"):
        return "two_block"
    raise ValueError(f"unknown halo_mode {halo_mode!r}")


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """Everything the kernel is launched with, checked against its limits."""

    geom: tuple  # the 18 ints of csrc/conv2d.cu's ConvGeom, in order
    ho: int
    wo: int
    smem_bytes: int
    route: str = "cudacore"
    splits: int = 1  # route "tc": ways the Cin chunks are cut across blocks


def _pow2_ceil(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def conv_launch_geometry(
    x_shape, w_shape, *, stride: int, padding: int, tau: int, cin_chunk: int,
    tile_rows: int, tile_cols: int, halo_mode: str, conv_route: str = "cudacore",
    sub_rows: int = 0, sub_cols: int = 0, splits: int = 1,
    widths: Optional[tuple] = None,
) -> ConvLaunch:
    """Resolve and check one direct-conv launch on ``conv_route``; ``widths``
    is (xbits, wbits) of a fixed-point conv's raws, None for float.

    "cudacore": τ (capped at the smallest compiled τ covering Cout, as the
    reference caps it at Cout), the Cin chunk (0 = the largest that fits
    shared memory), and each block's output tile from the regime.  "tc": a
    compiled τ (for fixed point one the width mix takes), float Cin and Cout
    multiples of 8 or fixed-point Cin·bytes a multiple of 16 and Cout of 8,
    the route's chunk (0, or 32 float / 64 fixed point), the regime's tile
    as each block's region, walked in sub-tiles of ``sub_rows`` x
    ``sub_cols`` pixels (0 = the planner's), and the Cin chunks cut
    ``splits`` ways."""
    n, h, wd, cin = x_shape
    kh, kw, cin2, cout = w_shape
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights expect {cin2}")
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride {stride} / padding {padding}")
    if conv_route not in CONV_ROUTES:
        raise ValueError(f"conv route must be one of {CONV_ROUTES}, got {conv_route!r}")
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (wd + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"empty conv output {ho}x{wo}")
    if conv_route == "tc":
        return _tc_geometry(x_shape, w_shape, ho, wo, stride=stride, padding=padding,
                            tau=tau, cin_chunk=cin_chunk, tile_rows=tile_rows,
                            tile_cols=tile_cols, halo_mode=halo_mode,
                            sub_rows=sub_rows, sub_cols=sub_cols, splits=splits,
                            widths=widths)
    tau = min(tau, _pow2_ceil(max(cout, 8)))
    if tau not in H100.conv_taus:
        raise ValueError(f"conv kernel takes tau in {H100.conv_taus}, got {tau}")
    sub_h, sub_w = gpu_conv_subtile(tau)
    limit = H100.smem_per_block
    if cin_chunk == 0:
        cin_chunk = gpu_conv_max_chunk(kh, kw, stride, tau, cin, limit)
    if not 1 <= cin_chunk <= cin:
        raise ValueError(f"Cin chunk {cin_chunk} outside [1, {cin}] (or no "
                         f"chunk fits {limit} bytes of shared memory)")
    smem = gpu_conv_smem(kh, kw, stride, tau, cin_chunk)
    if smem > limit:
        raise ValueError(f"Cin chunk {cin_chunk} at tau {tau} needs {smem} bytes "
                         f"of shared memory, over the {limit} a block has")
    th, tw = _region(kh, stride, ho, wo, tile_rows, tile_cols, halo_mode, (sub_h, sub_w))
    geom = (n, h, wd, cin, kh, kw, stride, padding, ho, wo, cout, tau,
            cin_chunk, th, tw, ceil_div(wo, tw), sub_h, sub_w)
    return ConvLaunch(geom, ho, wo, smem)


def _region(kh, stride, ho, wo, tile_rows, tile_cols, halo_mode, untiled):
    """Each block's output tile under the regime (``untiled`` when the
    plan has none), with the two-block scheme's legality rule."""
    mode = halo_mode_for(tile_rows, tile_cols, ho, wo, halo_mode)
    if mode == "untiled":
        return untiled
    if mode == "two_block":
        if stride * tile_rows < kh:
            raise ValueError(
                f"tile_rows={tile_rows} too small: stride*tile_rows ({stride * tile_rows}) "
                f"must cover the {kh}-row tap window for the two-block halo scheme"
            )
        return tile_rows, wo
    return (tile_rows if 0 < tile_rows < ho else ho,
            tile_cols if 0 < tile_cols < wo else wo)


def _tc_geometry(x_shape, w_shape, ho, wo, *, stride, padding, tau, cin_chunk, tile_rows,
                 tile_cols, halo_mode, sub_rows, sub_cols, splits, widths) -> ConvLaunch:
    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    if widths is None:
        in_bytes, chunk = 4, TC_CHUNK
        if cin % 8 or cout % 8:
            raise ValueError(f"the tensor-core conv route takes Cin and Cout multiples of "
                             f"8, got Cin {cin}, Cout {cout}")
        if tau not in H100.conv_tc_taus:
            raise ValueError(f"the tensor-core conv route takes tau in "
                             f"{H100.conv_tc_taus}, got {tau}")
    else:
        xbits, wbits = widths
        in_bytes, chunk = xbits // 8, TC_Q16_CHUNK
        if not gpu_conv_tc_legal(cin, cout, in_bytes):
            raise ValueError(f"the fixed-point tensor-core conv route takes Cin·bytes a "
                             f"multiple of 16 and Cout a multiple of 8, got Cin {cin} of "
                             f"int{xbits}, Cout {cout}")
        if tau != TC_Q16_TAU:
            raise ValueError(f"the fixed-point tensor-core conv route takes tau "
                             f"{TC_Q16_TAU}, got {tau}")
    if cin_chunk not in (0, chunk):
        raise ValueError(f"the tensor-core conv route stages Cin in chunks of "
                         f"{chunk}, got {cin_chunk}")
    region = _region(kh, stride, ho, wo, tile_rows, tile_cols, halo_mode, None)
    if not sub_rows or not sub_cols:
        sub = gpu_conv_tc_subtile(*(region or (ho, wo)), kh, kw, stride, tau, H100, in_bytes)
        if sub is None:
            raise ValueError(f"no tensor-core conv sub-tile fits a {kh}x{kw} stride-{stride} "
                             f"window in TMA's {TC_MAX_BOX}-wide box and "
                             f"{H100.smem_per_block} bytes of shared memory")
        sub_rows, sub_cols = sub
    if sub_rows < 1 or sub_cols < 1 or sub_rows * sub_cols > TC_PIXELS:
        raise ValueError(f"sub-tile {sub_rows}x{sub_cols} outside 1..{TC_PIXELS} pixels")
    rows, cols = (sub_rows - 1) * stride + kh, (sub_cols - 1) * stride + kw
    if max(rows, cols) > TC_MAX_BOX:
        raise ValueError(f"input window {rows}x{cols} exceeds TMA's {TC_MAX_BOX}-wide box")
    if widths is None:
        smem = gpu_conv_tc_smem(kh, kw, stride, tau, sub_rows, sub_cols)
    else:
        smem = gpu_conv_q16_tc_smem(kh, kw, stride, tau, sub_rows, sub_cols,
                                    widths[0] // 8, widths[1] // 8)
    if smem > H100.smem_per_block:
        raise ValueError(f"sub-tile {sub_rows}x{sub_cols} needs {smem} bytes of shared "
                         f"memory, over the {H100.smem_per_block} a block has")
    chunks = ceil_div(cin, chunk)
    if not 1 <= splits <= chunks or (splits - 1) * ceil_div(chunks, splits) >= chunks:
        raise ValueError(f"{splits} Cin splits of {chunks} chunks leave a split empty")
    th, tw = region or (sub_rows, sub_cols)
    geom = (n, h, wd, cin, kh, kw, stride, padding, ho, wo, cout, tau,
            chunk, th, tw, ceil_div(wo, tw), sub_rows, sub_cols)
    return ConvLaunch(geom, ho, wo, smem, "tc", splits)


def _check_operands(x, w, bias, dtypes):
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv wants NHWC x and (K, K, Cin, Cout) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got {tuple(bias.shape)}")


def _geom_arg(geom: tuple):
    arr = (ctypes.c_int * len(geom))(*geom)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


# ---------------------------------------------------------------------------
# float
# ---------------------------------------------------------------------------


def conv2d_plain(x, w, bias=None, *, stride: int = 1, padding: int = 0,
                 relu: bool = False, qout: Optional[QFormat] = None) -> torch.Tensor:
    """K² tap GEMMs with an f32 accumulator, then bias -> ReLU -> fake-quant
    (the reference's ``conv2d_fused_ref``)."""
    return conv2d_fused_ref(x, w, bias, stride=stride, padding=padding,
                            relu=relu, qout=qout)


def _epilogue_args(qout: Optional[QFormat]) -> tuple:
    return (int(qout is not None), qout.scale if qout else 1.0,
            qout.min_val if qout else 0.0, qout.max_val if qout else 0.0)


def launch(lib, x, w, bias, out, geo: ConvLaunch, *, relu: bool,
           qout: Optional[QFormat], device: int, stream) -> None:
    """One call of the float C entry point on prepared, checked operands."""
    keep, geom = _geom_arg(geo.geom)
    rc = lib.conv2d_launch(ptr(x), ptr(w), ptr(bias), ptr(out), geom, int(relu),
                           *_epilogue_args(qout), device, stream)
    del keep
    _build.check(lib, rc, "conv2d")


def prep_tc(lib, w, wp, *, device: int, stream) -> None:
    """Route "tc"'s weight preparation: w (K, K, Cin, Cout) -> wp (2, Cout,
    K·K, Cin), the TF32 hi and lo planes, K-major."""
    kh, kw, cin, cout = w.shape
    rc = lib.conv2d_tc_prep_launch(ptr(w), ptr(wp), kh * kw, cin, cout, device, stream)
    _build.check(lib, rc, "conv2d.tc_prep")


def launch_tc(lib, x, wp, bias, out, workspace, geo: ConvLaunch, *, relu: bool,
              qout: Optional[QFormat], device: int, stream) -> None:
    """One call of route "tc" (the conv, and for a Cin split its reduction)
    on prepared weights ``wp``; ``workspace`` (splits, N·Ho·Wo·Cout) f32 when
    ``geo.splits`` > 1."""
    keep, geom = _geom_arg(geo.geom)
    rc = lib.conv2d_tc_launch(ptr(x), ptr(wp), ptr(bias), ptr(out), ptr(workspace), geom,
                              geo.splits, int(relu), *_epilogue_args(qout), device,
                              stream)
    del keep
    _build.check(lib, rc, "conv2d.tc")


def conv2d_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    tau: int = 64,
    cin_chunk: int = 0,
    relu: bool = False,
    qout: Optional[QFormat] = None,
    tile_rows: int = 0,
    tile_cols: int = 0,
    halo_mode: str = "two_block",
    conv_route: str = "cudacore",
    sub_rows: int = 0,
    sub_cols: int = 0,
    splits: int = 1,
) -> torch.Tensor:
    """NHWC conv, any stride and zero padding.  x: (N,H,W,Cin) f32,
    w: (K,K,Cin,Cout) f32 -> (N,Ho,Wo,Cout) f32; ``bias`` (Cout,), ``relu``
    and ``qout`` fused into the write-back.  ``conv_route``, the sub-tile
    and ``splits`` as in :func:`conv_launch_geometry`; a launch the route
    does not take raises, here or in the kernel's launcher."""
    _check_operands(x, w, bias, (torch.float32,))
    geo = conv_launch_geometry(
        x.shape, w.shape, stride=stride, padding=padding, tau=tau,
        cin_chunk=cin_chunk, tile_rows=tile_rows, tile_cols=tile_cols,
        halo_mode=halo_mode, conv_route=conv_route, sub_rows=sub_rows,
        sub_cols=sub_cols, splits=splits,
    )
    if on_cpu(x, w, bias):
        return conv2d_plain(x, w, bias, stride=stride, padding=padding,
                            relu=relu, qout=qout)
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    require_contiguous(x=x, w=w)
    n, cout = x.shape[0], w.shape[3]
    out = torch.empty((n, geo.ho, geo.wo, cout), dtype=torch.float32, device=x.device)
    lib = _build.library("conv2d")
    dev, stream = x.device.index, stream_of(x)
    if geo.route == "tc":
        kh, kw, cin, _ = w.shape
        wp = torch.empty((2, cout, kh * kw, cin), dtype=torch.float32, device=x.device)
        prep_tc(lib, w, wp, device=dev, stream=stream)
        _build.launches["conv2d.tc_prep"] += 1
        ws = None
        if geo.splits > 1:
            ws = torch.empty((geo.splits, n * geo.ho * geo.wo * cout),
                             dtype=torch.float32, device=x.device)
        launch_tc(lib, x, wp, bias32, out, ws, geo, relu=relu, qout=qout, device=dev,
                  stream=stream)
        _build.launches["conv2d.tc_reduce"] += int(geo.splits > 1)
    else:
        launch(lib, x, w, bias32, out, geo, relu=relu, qout=qout, device=dev, stream=stream)
    _build.launches["conv2d"] += 1
    _build.launches[f"conv2d.{geo.route}"] += 1
    return out


# ---------------------------------------------------------------------------
# fixed point
# ---------------------------------------------------------------------------


def conv2d_q16_plain(xq, wq, bias=None, *, stride: int = 1, padding: int = 0,
                     shift: int, bias_shift: int, raw_min: int, raw_max: int,
                     out_dtype: torch.dtype, relu: bool = False) -> torch.Tensor:
    """Exact int32-wrapping tap-loop accumulation, then the q16 epilogue."""
    acc = conv_taps_i32(xq, wq, stride=stride, padding=padding)
    return q16_epilogue(acc, bias, bias_shift=bias_shift, relu=relu,
                        shift=shift, raw_min=raw_min, raw_max=raw_max,
                        out_dtype=out_dtype)


def launch_q16(lib, xq, wq, bias, out, geo: ConvLaunch, *, relu: bool,
               shift: int, bias_shift: int, raw_min: int, raw_max: int,
               device: int, stream) -> None:
    """One call of the fixed-point C entry point of route "cudacore" on
    prepared operands."""
    keep, geom = _geom_arg(geo.geom)
    rc = lib.conv2d_q16_launch(
        ptr(xq), _BITS[xq.dtype], ptr(wq), _BITS[wq.dtype], ptr(bias), ptr(out),
        _BITS[out.dtype], geom, int(relu), shift, bias_shift, raw_min, raw_max,
        device, stream,
    )
    del keep
    _build.check(lib, rc, "conv2d_q16")


def q16_tc_planes_for(wq: torch.Tensor) -> torch.Tensor:
    """Route "tc"'s prepared weights for ``wq`` (K, K, Cin, Cout), unwritten:
    (limbs, Cout, K·K, Cinp) uint8, Cinp = Cin rounded up to the 64-channel
    chunk; one limb for int8, two for int16."""
    kh, kw, cin, cout = wq.shape
    return torch.empty((_BITS[wq.dtype] // 8, cout, kh * kw,
                        ceil_div(cin, TC_Q16_CHUNK) * TC_Q16_CHUNK),
                       dtype=torch.uint8, device=wq.device)


def prep_q16_tc(lib, wq, wp, *, device: int, stream) -> None:
    """Route "tc"'s weight preparation: wq (K, K, Cin, Cout) raws -> wp
    (:func:`q16_tc_planes_for`), the signed hi and unsigned lo bytes of
    int16 (the int8 raw itself), K-major, Cin zero-padded."""
    kh, kw, cin, cout = wq.shape
    rc = lib.conv2d_q16_tc_prep_launch(ptr(wq), _BITS[wq.dtype], ptr(wp), kh * kw, cin, cout,
                                       device, stream)
    _build.check(lib, rc, "conv2d_q16.tc_prep")


def launch_q16_tc(lib, xq, wp, bias, out, workspace, geo: ConvLaunch, *, relu: bool,
                  shift: int, bias_shift: int, raw_min: int, raw_max: int, device: int,
                  stream) -> None:
    """One call of the fixed-point route "tc" (the conv, and for a Cin split
    its reduction) on the prepared weights ``wp`` (their limbs give the
    weights' width); ``workspace`` (splits, N·Ho·Wo·Cout) int32 when
    ``geo.splits`` > 1."""
    keep, geom = _geom_arg(geo.geom)
    rc = lib.conv2d_q16_tc_launch(
        ptr(xq), _BITS[xq.dtype], ptr(wp), 8 * wp.shape[0], ptr(bias), ptr(out),
        _BITS[out.dtype], ptr(workspace), geom, geo.splits, int(relu), shift, bias_shift,
        raw_min, raw_max, device, stream,
    )
    del keep
    _build.check(lib, rc, "conv2d_q16.tc")


def conv2d_q16_cuda(
    xq: torch.Tensor,
    wq: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    tau: int = 64,
    cin_chunk: int = 0,
    relu: bool = False,
    fmt: QFormat = Q2_14,
    shift: Optional[int] = None,
    bias_shift: Optional[int] = None,
    tile_rows: int = 0,
    tile_cols: int = 0,
    halo_mode: str = "two_block",
    conv_route: str = "cudacore",
    sub_rows: int = 0,
    sub_cols: int = 0,
    splits: int = 1,
) -> torch.Tensor:
    """Fixed-point NHWC conv on int16 / int8 raws (mixed widths allowed),
    written onto ``fmt``'s rung; ``shift`` / ``bias_shift`` as in
    :func:`~repro_torch.kernels.matmul_q16.matmul_q16_cuda`.  ``conv_route``,
    the sub-tile and ``splits`` as in :func:`conv_launch_geometry`; a launch
    the route does not take raises, here or in the kernel's launcher.  Every
    route and tiling is bit-identical: integer accumulation is exact in any
    order."""
    _check_operands(xq, wq, bias, (torch.int8, torch.int16))
    if bias is not None and bias.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"bias must hold int8 or int16 raws, got {bias.dtype}")
    shift = fmt.frac_bits if shift is None else shift
    bias_shift = fmt.frac_bits if bias_shift is None else bias_shift
    check_shifts(shift, bias_shift)
    geo = conv_launch_geometry(
        xq.shape, wq.shape, stride=stride, padding=padding, tau=tau,
        cin_chunk=cin_chunk, tile_rows=tile_rows, tile_cols=tile_cols,
        halo_mode=halo_mode, conv_route=conv_route, sub_rows=sub_rows,
        sub_cols=sub_cols, splits=splits, widths=(_BITS[xq.dtype], _BITS[wq.dtype]),
    )
    if on_cpu(xq, wq, bias):
        return conv2d_q16_plain(xq, wq, bias, stride=stride, padding=padding,
                                shift=shift, bias_shift=bias_shift,
                                raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                                out_dtype=fmt.storage_dtype, relu=relu)
    bias32 = None if bias is None else bias.to(torch.int32).contiguous()
    require_contiguous(xq=xq, wq=wq)
    n, cout = xq.shape[0], wq.shape[3]
    out = torch.empty((n, geo.ho, geo.wo, cout), dtype=fmt.storage_dtype, device=xq.device)
    lib = _build.library("conv2d")
    dev, stream = xq.device.index, stream_of(xq)
    epi = dict(relu=relu, shift=shift, bias_shift=bias_shift, raw_min=fmt.raw_min,
               raw_max=fmt.raw_max, device=dev, stream=stream)
    if geo.route == "tc":
        wp = q16_tc_planes_for(wq)
        prep_q16_tc(lib, wq, wp, device=dev, stream=stream)
        _build.launches["conv2d_q16.tc_prep"] += 1
        ws = None
        if geo.splits > 1:
            ws = torch.empty((geo.splits, n * geo.ho * geo.wo * cout), dtype=torch.int32,
                             device=xq.device)
        launch_q16_tc(lib, xq, wp, bias32, out, ws, geo, **epi)
        _build.launches["conv2d_q16.tc_reduce"] += int(geo.splits > 1)
    else:
        launch_q16(lib, xq, wq, bias32, out, geo, **epi)
    _build.launches["conv2d_q16"] += 1
    _build.launches[f"conv2d_q16.{geo.route}"] += 1
    return out
