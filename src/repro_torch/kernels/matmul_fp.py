"""The float GEMM with fused epilogue: CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/matmul_fp.py:matmul_fp_pallas`` (kernel
``_mm_kernel``).  The kernel is ``csrc/matmul_fp.cu``, on three routes that
the plan (a :class:`MatmulBlock`) names, each described where it lives:

* "wgmma" (``csrc/gemm_wgmma.cuh``): bf16 with large m on the tensor cores,
  TMA loads into a ring of shared-memory stages;
* "splitk" (``csrc/gemm_splitk.cuh``): m <= 16, w streamed once with 16-byte
  loads over k slices, the slices' partial sums reduced in a fixed order;
* "tile" (``csrc/gemm.cuh``): the block-tiled CUDA-core GEMM it shares with
  the q16 kernel (f32 with larger m, bf16 that TMA cannot address).

``matmul_fp_cuda`` launches the kernel for CUDA tensors and runs
:func:`matmul_fp_plain` for CPU tensors, and only for those.  A ``w`` that
is the transposed view of a contiguous (n, k) matrix (``embed.T``, the tied
LM head) is read in place on every route, never copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dse import default_fp_block_for, fp_block_legal
from repro_torch.core.quantization import QFormat
from repro_torch.core.tiling import FP_ROUTES, H100, MatmulBlock

from . import _build
from ._common import on_cpu, ptr, require_contiguous, stream_of
from .ref import matmul_fused_ref

__all__ = ["matmul_fp_cuda", "matmul_fp_plain", "launch", "plan_for", "transposed",
           "workspace_for"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_fp_plain(x, w, bias=None, *, relu: bool = False,
                    qout: Optional[QFormat] = None) -> torch.Tensor:
    """x (m, k) @ w (k, n) in f32, then bias -> ReLU -> fake-quant, cast to
    x's dtype (the reference's ``matmul_fused_ref``)."""
    return matmul_fused_ref(x, w, bias, relu=relu, qout=qout)


def transposed(w: torch.Tensor) -> bool:
    """True for the (k, n) transposed view of a contiguous (n, k) matrix."""
    return w.ndim == 2 and not w.is_contiguous() and w.t().is_contiguous()


def plan_for(x: torch.Tensor, w: torch.Tensor) -> MatmulBlock:
    """The H100 planner's route and tile for ``x @ w``."""
    return default_fp_block_for(x.shape[0], w.shape[1], x.shape[1], H100,
                                dtype_bytes=x.element_size())


def workspace_for(block: MatmulBlock, m: int, n: int, device) -> Optional[torch.Tensor]:
    """Route "splitk" with more than one slice: the (splits, m, n) f32
    partial sums, reduced in slice order by the kernel's second pass."""
    if block.route != "splitk" or block.splits == 1:
        return None
    return torch.empty((block.splits, m, n), dtype=torch.float32, device=device)


def launch(lib, x, w, bias, out, block: MatmulBlock, relu: bool,
           qout: Optional[QFormat], device: int, stream, workspace=None) -> None:
    """One call of the C entry point on prepared, checked operands (``w``
    contiguous, or the transposed view of a contiguous matrix;
    ``workspace`` from :func:`workspace_for`)."""
    m, k = x.shape
    n = w.shape[1]
    rc = lib.matmul_fp_launch(
        ptr(x), ptr(w), ptr(bias), ptr(out), ptr(workspace), m, n, k, _DTYPES[x.dtype],
        int(transposed(w)), FP_ROUTES.index(block.route), block.bm, block.bn, block.bk,
        block.splits, int(relu), int(qout is not None), qout.scale if qout else 1.0,
        qout.min_val if qout else 0.0, qout.max_val if qout else 0.0, device, stream,
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
    ``block``: the route and tile (default: the H100 planner's choice for
    the shape, dtype and layout); one the kernel does not take raises.
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
    block = block or plan_for(x, w)
    if not fp_block_legal(block, m, n, k, dtype_bytes=x.element_size(), spec=H100):
        raise ValueError(f"matmul_fp kernel does not take {block} for "
                         f"({m},{k})@({k},{n}) {x.dtype}"
                         f"{' (w transposed)' if transposed(w) else ''}")
    if on_cpu(x, w, bias):
        return matmul_fp_plain(x, w, bias, relu=relu, qout=qout)
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    require_contiguous(x=x)
    if not transposed(w):
        require_contiguous(w=w)
    if block.route == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("matmul_fp route wgmma: TMA needs 16-byte aligned x and w")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    launch(_build.library("matmul_fp"), x, w, bias32, out, block, relu, qout,
           x.device.index, stream_of(x), workspace_for(block, m, n, x.device))
    _build.launches["matmul_fp"] += 1
    _build.launches[f"matmul_fp.{block.route}"] += 1
    if block.route == "splitk" and block.splits > 1:
        _build.launches["matmul_fp.splitk_reduce"] += 1
    return out
