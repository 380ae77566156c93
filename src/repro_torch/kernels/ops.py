"""Route wrappers around the CUDA kernels, and the one im2col of the port.

The port's copy of ``repro.kernels.ops``.  Route *selection* (direct conv vs
im2col GEMM, planned tiles) is the engine's job (``core/engine.py``); these
wrappers run whichever route they are told.  :func:`flash_attention` is the
GQA attention wrapper the model's chunked prefill route calls.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import Q2_14, QFormat
from repro_torch.core.tiling import MatmulBlock

from .conv2d import conv2d_cuda, conv2d_q16_cuda
from .flash_attention import flash_attention_cuda
from .matmul_fp import matmul_fp_cuda
from .matmul_q16 import matmul_q16_cuda

__all__ = [
    "im2col",
    "conv_gemm_weights",
    "matmul_fp",
    "matmul_q16",
    "conv2d",
    "conv2d_q16",
    "flash_attention",
]


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """Already-padded NHWC image -> GEMM rows.

    x: (N, H, W, Cin) -> cols (N*Ho*Wo, Cin*Kh*Kw), features ordered
    (cin, kh, kw) to match :func:`conv_gemm_weights` (``F.unfold``'s order).
    ``F.unfold`` takes no integer tensors, so integer raws are gathered in
    float32, which is exact for magnitudes below 2^24 (int16 and int8 raws),
    and cast back.  Returns (cols, ho, wo).
    """
    n, h, wd, cin = x.shape
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    cast = None
    xg = x
    if not x.dtype.is_floating_point:
        cast = x.dtype
        xg = x.to(torch.float32)
    patches = F.unfold(xg.permute(0, 3, 1, 2), kernel_size=(kh, kw),
                       stride=stride)  # (N, Cin*Kh*Kw, Ho*Wo)
    cols = patches.transpose(1, 2).reshape(n * ho * wo, cin * kh * kw)
    if cast is not None:
        cols = cols.to(cast)
    return cols, ho, wo


def conv_gemm_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, K, Cin, Cout) conv weights -> (Cin*Kh*Kw, Cout) GEMM operand."""
    kh, kw, cin, cout = w.shape
    return w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def _pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    return F.pad(x, (0, 0, padding, padding, padding, padding)) if padding else x


# ---------------------------------------------------------------------------
# GEMM wrappers
# ---------------------------------------------------------------------------


def matmul_fp(x, w, *, bias=None, relu: bool = False,
              qout: Optional[QFormat] = None,
              block: Optional[MatmulBlock] = None) -> torch.Tensor:
    return matmul_fp_cuda(x, w, bias, block=block, relu=relu, qout=qout)


def matmul_q16(xq, wq, *, bias=None, relu: bool = False, fmt: QFormat = Q2_14,
               shift: Optional[int] = None, bias_shift: Optional[int] = None,
               wide: bool = False,
               block: Optional[MatmulBlock] = None) -> torch.Tensor:
    return matmul_q16_cuda(xq, wq, bias, fmt=fmt, block=block, relu=relu,
                           shift=shift, bias_shift=bias_shift, wide=wide)


# ---------------------------------------------------------------------------
# conv wrappers (route chosen by the caller / engine)
# ---------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    tau: int = 64,
    cin_chunk: int = 0,
    relu: bool = False,
    qout: Optional[QFormat] = None,
    route: str = "direct",
    block: Optional[MatmulBlock] = None,
    tile_rows: int = 0,
    tile_cols: int = 0,
    halo_mode: str = "two_block",
    conv_route: str = "cudacore",
    splits: int = 1,
    sub_rows: int = 0,
    sub_cols: int = 0,
) -> torch.Tensor:
    """NHWC conv, float path.  ``route="direct"``: the direct CUDA conv
    (padding as zero fill inside the kernel) on ``conv_route`` ("cudacore"
    or "tc", with its sub-tile and Cin split); ``route="im2col"``: im2col +
    the float GEMM kernel.  The epilogue is fused on both routes."""
    if route == "direct":
        return conv2d_cuda(
            x, w, bias, stride=stride, padding=padding, tau=tau,
            cin_chunk=cin_chunk, relu=relu, qout=qout, tile_rows=tile_rows,
            tile_cols=tile_cols, halo_mode=halo_mode, conv_route=conv_route,
            splits=splits, sub_rows=sub_rows, sub_cols=sub_cols,
        )
    if route != "im2col":
        raise ValueError(f"unknown conv route {route!r}")
    n = x.shape[0]
    kh, kw, _, cout = w.shape
    cols, ho, wo = im2col(_pad(x, padding), kh, kw, stride)
    # one image's columns are a transposed view; the kernel reads dense rows
    out = matmul_fp(cols.contiguous(), conv_gemm_weights(w).contiguous(), bias=bias,
                    relu=relu, qout=qout, block=block)
    return out.reshape(n, ho, wo, cout)


def conv2d_q16(
    xq: torch.Tensor,
    wq: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    tau: int = 64,
    cin_chunk: int = 0,
    relu: bool = False,
    fmt: QFormat = Q2_14,
    shift: Optional[int] = None,
    bias_shift: Optional[int] = None,
    route: str = "direct",
    block: Optional[MatmulBlock] = None,
    tile_rows: int = 0,
    tile_cols: int = 0,
    halo_mode: str = "two_block",
    conv_route: str = "cudacore",
    splits: int = 1,
    sub_rows: int = 0,
    sub_cols: int = 0,
) -> torch.Tensor:
    """NHWC conv, fixed-point path, on int16 / int8 raws.  ``route="direct"``:
    the direct CUDA conv on ``conv_route`` ("cudacore" or "tc", with its
    sub-tile and Cin split); ``route="im2col"``: im2col + the q16 GEMM."""
    if route == "direct":
        return conv2d_q16_cuda(
            xq, wq, bias, stride=stride, padding=padding, tau=tau,
            cin_chunk=cin_chunk, relu=relu, fmt=fmt, shift=shift,
            bias_shift=bias_shift, tile_rows=tile_rows, tile_cols=tile_cols,
            halo_mode=halo_mode, conv_route=conv_route, splits=splits,
            sub_rows=sub_rows, sub_cols=sub_cols,
        )
    if route != "im2col":
        raise ValueError(f"unknown conv route {route!r}")
    n = xq.shape[0]
    kh, kw, _, cout = wq.shape
    cols, ho, wo = im2col(_pad(xq, padding), kh, kw, stride)
    out = matmul_q16(cols, conv_gemm_weights(wq).contiguous(), bias=bias,
                     relu=relu, fmt=fmt, shift=shift, bias_shift=bias_shift,
                     block=block)
    return out.reshape(n, ho, wo, cout)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """GQA-aware attention.  q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D) ->
    (B, Hq, Sq, D).  q head h reads kv head ``h // (Hq // Hkv)`` in place;
    the reference's broadcast of k / v over the group is not built.

    ``bq`` / ``bk`` are the reference's block sizes: they are clamped to the
    sequence lengths as there, and a non-causal call whose Sk is not a
    multiple of ``bk`` raises as there.  The kernel tiles by its own blocks.
    """
    sk = k.shape[2]
    bk = min(bk, sk)
    if not causal and sk % bk:
        raise ValueError("non-causal flash kernel requires sk % bk == 0")
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset, bk=bk)
