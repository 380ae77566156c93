"""The float GEMM with fused epilogue: CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/matmul_fp.py:matmul_fp_pallas`` (kernel
``_mm_kernel``).  The kernel is ``csrc/matmul_fp.cu`` on the block-tiled
GEMM of ``csrc/gemm.cuh``, which says what bounds it on an H100 and what
its design does about that.

``matmul_fp_cuda`` launches the kernel for CUDA tensors and runs
:func:`matmul_fp_plain` for CPU tensors, and only for those.  A ``w`` that
is the transposed view of a contiguous (n, k) matrix (``embed.T``, the tied
LM head) is read in place by the kernel's transposed-B path, never copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dse import default_block_for
from repro_torch.core.quantization import QFormat
from repro_torch.core.tiling import H100, MatmulBlock

from . import _build
from ._common import on_cpu, ptr, require_contiguous, stream_of
from .ref import matmul_fused_ref

__all__ = ["matmul_fp_cuda", "matmul_fp_plain", "launch", "transposed"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_fp_plain(x, w, bias=None, *, relu: bool = False,
                    qout: Optional[QFormat] = None) -> torch.Tensor:
    """x (m, k) @ w (k, n) in f32, then bias -> ReLU -> fake-quant, cast to
    x's dtype (the reference's ``matmul_fused_ref``)."""
    return matmul_fused_ref(x, w, bias, relu=relu, qout=qout)


def transposed(w: torch.Tensor) -> bool:
    """True for the (k, n) transposed view of a contiguous (n, k) matrix."""
    return w.ndim == 2 and not w.is_contiguous() and w.t().is_contiguous()


def launch(lib, x, w, bias, out, block: MatmulBlock, relu: bool,
           qout: Optional[QFormat], device: int, stream) -> None:
    """One call of the C entry point on prepared, checked operands (``w``
    contiguous, or the transposed view of a contiguous matrix)."""
    m, k = x.shape
    n = w.shape[1]
    rc = lib.matmul_fp_launch(
        ptr(x), ptr(w), ptr(bias), ptr(out), m, n, k, _DTYPES[x.dtype],
        int(transposed(w)), block.bm, block.bn, block.bk, int(relu),
        int(qout is not None), qout.scale if qout else 1.0, qout.min_val if qout else 0.0,
        qout.max_val if qout else 0.0, device, stream,
    )
    _build.check(lib, rc, "matmul_fp")


def matmul_fp_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    block: Optional[MatmulBlock] = None,
    relu: bool = False,
    qout: Optional[QFormat] = None,
) -> torch.Tensor:
    """x: (m, k) @ w: (k, n) -> (m, n) in x's dtype (f32 or bf16).

    ``bias``: (n,), fused into the write-back in f32; ``relu`` / ``qout``:
    fused nonlinearity and fake-quantization, applied after the bias.
    ``block``: one of the kernel's compiled tiles (default: the H100 DSE's
    choice for the shape).
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_fp wants (m, k) @ (k, n), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"matmul_fp takes two f32 or two bf16 operands, got "
                        f"{x.dtype} and {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    block = block or default_block_for(m, n, k, H100)
    if (block.bm, block.bn, block.bk) not in H100.gemm_tiles:
        raise ValueError(f"matmul_fp kernel is compiled for tiles "
                         f"{H100.gemm_tiles}, not {block}")
    if on_cpu(x, w, bias):
        return matmul_fp_plain(x, w, bias, relu=relu, qout=qout)
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    require_contiguous(x=x)
    if not transposed(w):
        require_contiguous(w=w)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    launch(_build.library("matmul_fp"), x, w, bias32, out, block, relu, qout,
           x.device.index, stream_of(x))
    _build.launches["matmul_fp"] += 1
    return out
