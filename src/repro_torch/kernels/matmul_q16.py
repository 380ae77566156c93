"""The fixed-point GEMM with fused epilogue: CUDA kernel wrapper + plain
version.

Replaces ``repro/kernels/matmul_q16.py:matmul_q16_pallas`` (kernel
``_qmm_kernel``).  The kernel is ``csrc/matmul_q16.cu`` on the block-tiled
GEMM of ``csrc/gemm.cuh``, which says what bounds it on an H100 and what
its design does about that.  int16 / int8 raws (mixed widths allowed) are
widened to int32 and accumulated with int32 wraparound; the epilogue adds
``bias << bias_shift``, applies ReLU and ``shift_saturate_i32`` onto the
output rung, or returns the raw int32 accumulator (``wide``).

``matmul_q16_cuda`` launches the kernel for CUDA tensors and runs
:func:`matmul_q16_plain` for CPU tensors, and only for those.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dse import default_block_for
from repro_torch.core.quantization import Q2_14, QFormat, int_matmul_i32
from repro_torch.core.tiling import H100, MatmulBlock

from . import _build
from ._common import on_cpu, ptr, require_contiguous, stream_of
from .ref import q16_epilogue

__all__ = ["matmul_q16_cuda", "matmul_q16_plain", "launch", "check_shifts"]

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


def launch(lib, xq, wq, bias, out, block: MatmulBlock, *, relu: bool,
           shift: int, bias_shift: int, raw_min: int, raw_max: int,
           device: int, stream) -> None:
    """One call of the C entry point on prepared, checked operands."""
    m, k = xq.shape
    n = wq.shape[1]
    rc = lib.matmul_q16_launch(
        ptr(xq), _BITS[xq.dtype], ptr(wq), _BITS[wq.dtype], ptr(bias), ptr(out),
        _BITS[out.dtype], m, n, k, block.bm, block.bn, block.bk, int(relu),
        shift, bias_shift, raw_min, raw_max, device, stream,
    )
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
    or int8 raw; ``wide=True`` returns the int32 accumulator.
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
    block = block or default_block_for(m, n, k, H100)
    if (block.bm, block.bn, block.bk) not in H100.gemm_tiles or block.route != "tile":
        raise ValueError(f"matmul_q16 kernel is compiled for tiles "
                         f"{H100.gemm_tiles}, not {block}")
    out_dtype = torch.int32 if wide else fmt.storage_dtype
    if on_cpu(xq, wq, bias):
        return matmul_q16_plain(xq, wq, bias, shift=shift, bias_shift=bias_shift,
                                raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                                out_dtype=out_dtype, relu=relu, wide=wide)
    bias32 = None if bias is None else bias.to(torch.int32).contiguous()
    require_contiguous(xq=xq, wq=wq)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    launch(_build.library("matmul_q16"), xq, wq, bias32, out, block, relu=relu,
           shift=shift, bias_shift=bias_shift, raw_min=fmt.raw_min,
           raw_max=fmt.raw_max, device=xq.device.index, stream=stream_of(xq))
    _build.launches["matmul_q16"] += 1
    return out
