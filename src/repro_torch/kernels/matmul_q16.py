"""The fixed-point GEMM with fused epilogue: CUDA kernel wrapper + plain
version.

Replaces ``repro/kernels/matmul_q16.py:matmul_q16_pallas`` (kernel
``_qmm_kernel``).  The kernel is ``csrc/matmul_q16.cu``, on three routes
that the plan (a :class:`MatmulBlock`) names, each described where it
lives:

* "splitk" (``csrc/gemm_splitk.cuh``): m <= 16, w streamed once with vector
  loads over k slices, the raws multiplied and added in ``uint32_t`` on the
  CUDA cores, the slices' partial sums reduced in a fixed order;
* "wgmma" (``csrc/gemm_q16_wgmma.cuh``): every larger m on the int8 tensor
  cores, each int16 operand as a signed high and an unsigned low byte (four
  s8 / u8 products for int16 x int16, two for a mix with int8, one for int8
  x int8), after a preparation launch that writes the byte planes;
* "tile" (``csrc/gemm.cuh``): the block-tiled CUDA-core GEMM, raws widened
  to int32; taken only when a caller names it.

int16 / int8 raws (mixed widths allowed) are accumulated with int32
wraparound on every route; the epilogue adds ``bias << bias_shift``,
applies ReLU and ``shift_saturate_i32`` onto the output rung, or returns the
raw int32 accumulator (``wide``), bit for bit the reference's.

``matmul_q16_cuda`` launches the planned route for CUDA tensors and runs
:func:`matmul_q16_plain` for CPU tensors, and only for those.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dse import default_q16_block_for, q16_block_legal
from repro_torch.core.quantization import Q2_14, QFormat, int_matmul_i32
from repro_torch.core.tiling import H100, MatmulBlock, Q16_ROUTES, ceil_div

from . import _build
from ._common import on_cpu, ptr, require_contiguous, stream_of
from .ref import q16_epilogue

__all__ = ["matmul_q16_cuda", "matmul_q16_plain", "launch", "check_shifts", "plan_for",
           "planes_for", "prep", "workspace_for", "x_in_place"]

_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


def check_shifts(shift: int, bias_shift: int) -> None:
    """The kernels' shift range: |shift| <= 31 and 0 <= bias_shift <= 31."""
    if not -31 <= shift <= 31:
        raise ValueError(f"write-back shift {shift} outside [-31, 31]")
    if not 0 <= bias_shift <= 31:
        raise ValueError(f"bias shift {bias_shift} outside [0, 31]")


def matmul_q16_plain(xq, wq, bias=None, *, shift: int, bias_shift: int,
                     raw_min: int, raw_max: int, out_dtype: torch.dtype,
                     relu: bool = False, wide: bool = False) -> torch.Tensor:
    """Exact int32-wrapping product of the raws, then the q16 epilogue."""
    return q16_epilogue(int_matmul_i32(xq, wq), bias, bias_shift=bias_shift,
                        relu=relu, shift=shift, raw_min=raw_min,
                        raw_max=raw_max, out_dtype=out_dtype, wide=wide)


def plan_for(xq: torch.Tensor, wq: torch.Tensor) -> MatmulBlock:
    """The H100 planner's route and tile for ``xq @ wq`` at these widths."""
    return default_q16_block_for(xq.shape[0], wq.shape[1], xq.shape[1], H100,
                                 xbits=_BITS[xq.dtype], wbits=_BITS[wq.dtype])


def workspace_for(block: MatmulBlock, m: int, n: int, device) -> Optional[torch.Tensor]:
    """Route "splitk" with more than one slice: the (splits, m, n) partial
    sums (uint32 bits in an int32 tensor), reduced in slice order by the
    kernel's second pass."""
    if block.route != "splitk" or block.splits == 1:
        return None
    return torch.empty((block.splits, m, n), dtype=torch.int32, device=device)


def x_in_place(xq: torch.Tensor) -> bool:
    """Route "wgmma" reads an int8 x as it is when TMA can address its rows
    (16-byte row stride and base); any other x is copied into byte planes."""
    return (xq.dtype == torch.int8 and xq.shape[1] % 16 == 0
            and xq.data_ptr() % 16 == 0)


def planes_for(xq: torch.Tensor, wq: torch.Tensor, block: MatmulBlock):
    """Route "wgmma"'s byte planes for ``block``: (x planes or None when x is
    read in place, w planes, kp): x (m, k) -> (limbs, m, kp), w (k, n) ->
    (limbs, n, kp), k padded to ``kp``, a multiple of the tile's k step
    ``block.bk`` (in bytes)."""
    m, k = xq.shape
    n = wq.shape[1]
    kp = ceil_div(k, block.bk) * block.bk
    xp = None if x_in_place(xq) else torch.empty(
        (_BITS[xq.dtype] // 8, m, kp), dtype=torch.uint8, device=xq.device)
    wp = torch.empty((_BITS[wq.dtype] // 8, n, kp), dtype=torch.uint8, device=wq.device)
    return xp, wp, kp


def prep(lib, xq, wq, xp, wp, *, kp: int, device: int, stream) -> None:
    """Route "wgmma"'s preparation launch: the raws into the byte planes of
    :func:`planes_for` (the plain version: ``ref.q16_limb_planes``)."""
    m, k = xq.shape
    n = wq.shape[1]
    rc = lib.matmul_q16_prep_launch(ptr(xq), _BITS[xq.dtype], ptr(wq), _BITS[wq.dtype],
                                    ptr(xp), ptr(wp), m, n, k, kp, device, stream)
    _build.check(lib, rc, "matmul_q16 prep")


def launch(lib, xq, wq, bias, out, block: MatmulBlock, *, relu: bool,
           shift: int, bias_shift: int, raw_min: int, raw_max: int,
           device: int, stream, workspace=None, planes=None) -> None:
    """One call of the route's C entry point on prepared, checked operands
    (``workspace`` from :func:`workspace_for`; for route "wgmma",
    ``planes``, the (x planes or None, w planes, kp) of :func:`planes_for`
    after :func:`prep`)."""
    m, k = xq.shape
    n = wq.shape[1]
    epi = (int(relu), shift, bias_shift, raw_min, raw_max, device, stream)
    if block.route == "wgmma":
        xp, wp, kp = planes
        rc = lib.matmul_q16_wgmma_launch(
            ptr(xq if xp is None else xp), _BITS[xq.dtype], int(xp is None), ptr(wp),
            _BITS[wq.dtype], ptr(bias), ptr(out), _BITS[out.dtype], m, n, k, kp, block.bm,
            block.bn, block.bk, *epi)
    else:
        rc = lib.matmul_q16_launch(
            ptr(xq), _BITS[xq.dtype], ptr(wq), _BITS[wq.dtype], ptr(bias), ptr(out),
            _BITS[out.dtype], ptr(workspace), m, n, k, Q16_ROUTES.index(block.route),
            block.bm, block.bn, block.bk, block.splits, *epi)
    _build.check(lib, rc, "matmul_q16")


def matmul_q16_cuda(
    xq: torch.Tensor,
    wq: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fmt: QFormat = Q2_14,
    block: Optional[MatmulBlock] = None,
    relu: bool = False,
    shift: Optional[int] = None,
    bias_shift: Optional[int] = None,
    wide: bool = False,
) -> torch.Tensor:
    """xq: (m, k) raw @ wq: (k, n) raw -> (m, n) raw on ``fmt``'s rung.

    ``shift`` / ``bias_shift`` are the write-back scale gaps (default: one
    ``fmt.frac_bits`` each, the same-format semantics); ``bias``: (n,) int16
    or int8 raw; ``wide=True`` returns the int32 accumulator.  ``block``:
    the route and tile (default: the H100 planner's choice for the shape and
    the widths); one the kernel does not take raises.
    """
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"matmul_q16 wants (m, k) @ (k, n), got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    for name, t in (("xq", xq), ("wq", wq), ("bias", bias)):
        if t is not None and t.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"{name} must hold int8 or int16 raws, got {t.dtype}")
    m, k = xq.shape
    n = wq.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    shift = fmt.frac_bits if shift is None else shift
    bias_shift = fmt.frac_bits if bias_shift is None else bias_shift
    check_shifts(shift, bias_shift)
    block = block or plan_for(xq, wq)
    if not q16_block_legal(block, m, n, k, xbits=_BITS[xq.dtype], wbits=_BITS[wq.dtype],
                           spec=H100):
        raise ValueError(f"matmul_q16 kernel does not take {block} for "
                         f"({m},{k})@({k},{n}) {xq.dtype} x {wq.dtype}")
    out_dtype = torch.int32 if wide else fmt.storage_dtype
    if on_cpu(xq, wq, bias):
        return matmul_q16_plain(xq, wq, bias, shift=shift, bias_shift=bias_shift,
                                raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                                out_dtype=out_dtype, relu=relu, wide=wide)
    bias32 = None if bias is None else bias.to(torch.int32).contiguous()
    require_contiguous(xq=xq, wq=wq)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    lib = _build.library("matmul_q16")
    dev, stream = xq.device.index, stream_of(xq)
    planes = None
    if block.route == "wgmma":
        planes = planes_for(xq, wq, block)
        prep(lib, xq, wq, planes[0], planes[1], kp=planes[2], device=dev, stream=stream)
        _build.launches["matmul_q16.prep"] += 1
    launch(lib, xq, wq, bias32, out, block, relu=relu, shift=shift, bias_shift=bias_shift,
           raw_min=fmt.raw_min, raw_max=fmt.raw_max, device=dev, stream=stream,
           workspace=workspace_for(block, m, n, xq.device), planes=planes)
    _build.launches["matmul_q16"] += 1
    _build.launches[f"matmul_q16.{block.route}"] += 1
    if block.route == "splitk" and block.splits > 1:
        _build.launches["matmul_q16.splitk_reduce"] += 1
    return out
