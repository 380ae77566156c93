"""Plain PyTorch versions of the kernels' functions (the correctness contract).

The port's copy of ``repro.kernels.ref``, plus the two epilogues every plain
version shares.  Everything here is plain tensor code that runs on any
device: the CPU tests hold it against the JAX oracles, and ``chip_smoke.py``
holds each CUDA kernel against it on the card.

Integer products go through :func:`~repro_torch.core.quantization.int_matmul_i32`
(exact float64, wrapped to int32), since CUDA has no integer ``mm`` and CPU
``mm`` on int16 wraps at 16 bits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import (
    Q2_14,
    QFormat,
    int_matmul_i32,
    shift_saturate_i32,
    wrap_i32,
)

__all__ = [
    "float_epilogue",
    "q16_epilogue",
    "matmul_ref",
    "matmul_fused_ref",
    "matmul_q16_ref",
    "matmul_q16_fused_ref",
    "conv2d_ref",
    "conv2d_fused_ref",
    "conv2d_q16_ref",
    "conv_taps_f32",
    "conv_taps_i32",
    "conv_taps_tf32",
    "tf32_round",
    "tf32_split",
    "attention_ref",
]


def float_epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor], *,
                   relu: bool, qout: Optional[QFormat]) -> torch.Tensor:
    """bias -> ReLU -> fake-quant ``clip(round(acc·2^f)/2^f, lo, hi)`` on the
    f32 accumulator (the reference's order)."""
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    if relu:
        acc = torch.clamp(acc, min=0.0)
    if qout is not None:
        acc = torch.clamp(torch.round(acc * qout.scale) / qout.scale,
                          qout.min_val, qout.max_val)
    return acc


def q16_epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor], *,
                 bias_shift: int, relu: bool, shift: int, raw_min: int,
                 raw_max: int, out_dtype: torch.dtype,
                 wide: bool = False) -> torch.Tensor:
    """``+ (bias << bias_shift)`` (int32 wrap) -> ReLU on int32 -> write-back
    onto the output rung, or the raw int32 accumulator when ``wide``."""
    if bias is not None:
        acc = wrap_i32(acc.to(torch.int64) + (bias.to(torch.int64) << bias_shift))
    if relu:
        acc = torch.clamp(acc, min=0)
    if wide:
        return acc
    return shift_saturate_i32(acc, shift, raw_min, raw_max, out_dtype)


def _pad_nhwc(x: torch.Tensor, padding: int) -> torch.Tensor:
    if not padding:
        return x
    return F.pad(x, (0, 0, padding, padding, padding, padding))


def _taps(xp: torch.Tensor, kh: int, kw: int, stride: int):
    """Yield (i, j, patch) with patch (N, Ho, Wo, Cin): the strided slice of
    the padded image tap (i, j) reads."""
    _, h, wd, _ = xp.shape
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    for i in range(kh):
        for j in range(kw):
            yield i, j, xp[:, i:i + stride * (ho - 1) + 1:stride,
                           j:j + stride * (wo - 1) + 1:stride, :]


def conv_taps_f32(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """NHWC conv as K² tap GEMMs with an f32 accumulator (the reference
    kernel's dataflow).  x: (N,H,W,Cin), w: (K,K,Cin,Cout)."""
    kh, kw = w.shape[0], w.shape[1]
    acc = None
    for i, j, patch in _taps(_pad_nhwc(x, padding), kh, kw, stride):
        term = torch.matmul(patch.to(torch.float32), w[i, j].to(torch.float32))
        acc = term if acc is None else acc + term
    return acc


def conv_taps_i32(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """Integer NHWC conv, exact int32-wrapping accumulation over the taps:
    each tap GEMM and their sum in float64 (exact: every partial sum is an
    integer below 2^53), wrapped to int32 once at the end, which equals
    wrapping at every step."""
    kh, kw = wq.shape[0], wq.shape[1]
    acc = None
    for i, j, patch in _taps(_pad_nhwc(xq, padding), kh, kw, stride):
        term = torch.matmul(patch.to(torch.float64), wq[i, j].to(torch.float64))
        acc = term if acc is None else acc + term
    return wrap_i32(acc)


# ---------------------------------------------------------------------------
# split-precision TF32: the numerics of the tensor-core conv, emulated
# (for the tests; nothing on the main path calls these)
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits' range
    to the magnitude bits, then clear them.  Infinities and NaNs pass."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32).to(torch.int64)
    rounded = ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values: hi rounds x, lo rounds x - hi (the
    tensor-core conv rounds both halves; it truncates neither)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def conv_taps_tf32(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                   padding: int = 0, passes: int = 3) -> torch.Tensor:
    """:func:`conv_taps_f32` on TF32 operands.  ``passes=3``: each product
    as hi·lo + lo·hi + hi·hi of :func:`tf32_split`'s halves (3xTF32, the
    tensor-core conv's arithmetic); ``passes=1``: hi·hi alone (one TF32
    pass).  A TF32 x TF32 product is exact in f32, so the f32 sums differ
    from the card's only in their order."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    acc = conv_taps_f32(xh, wh, stride=stride, padding=padding)
    if passes == 3:
        acc = (conv_taps_f32(xh, wl, stride=stride, padding=padding)
               + conv_taps_f32(xl, wh, stride=stride, padding=padding)) + acc
    return acc


# ---------------------------------------------------------------------------
# the reference's oracles
# ---------------------------------------------------------------------------


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32-accumulated matmul, output in x.dtype."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def matmul_fused_ref(x, w, b=None, *, relu: bool = False,
                     qout: Optional[QFormat] = None) -> torch.Tensor:
    """Float GEMM with fused epilogue (bias -> ReLU -> quant)."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return float_epilogue(y, b, relu=relu, qout=qout).to(x.dtype)


def matmul_q16_ref(xq, wq, fmt: QFormat = Q2_14) -> torch.Tensor:
    """int16 raw x int16 raw -> int16 raw (int32 accumulate, saturating shift)."""
    return shift_saturate_i32(int_matmul_i32(xq, wq), fmt.frac_bits,
                              fmt.raw_min, fmt.raw_max, fmt.storage_dtype)


def matmul_q16_fused_ref(xq, wq, bq=None, *, fmt: QFormat = Q2_14,
                         relu: bool = False) -> torch.Tensor:
    """Fixed-point GEMM with fused epilogue on the int32 accumulator."""
    return q16_epilogue(int_matmul_i32(xq, wq), bq, bias_shift=fmt.frac_bits,
                        relu=relu, shift=fmt.frac_bits, raw_min=fmt.raw_min,
                        raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype)


def conv2d_ref(x, w, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv oracle.  x: (N,H,W,Cin), w: (K,K,Cin,Cout)."""
    return conv_taps_f32(x, w, stride=stride, padding=padding).to(x.dtype)


def conv2d_fused_ref(x, w, b=None, *, stride: int = 1, padding: int = 0,
                     relu: bool = False,
                     qout: Optional[QFormat] = None) -> torch.Tensor:
    """Conv oracle with fused epilogue (bias -> ReLU -> fake-quant)."""
    y = conv_taps_f32(x, w, stride=stride, padding=padding)
    return float_epilogue(y, b, relu=relu, qout=qout).to(x.dtype)


def conv2d_q16_ref(xq, wq, bq=None, *, fmt: QFormat = Q2_14, stride: int = 1,
                   padding: int = 0, relu: bool = False) -> torch.Tensor:
    """Fixed-point conv oracle: exact int32 tap-loop accumulation."""
    acc = conv_taps_i32(xq, wq, stride=stride, padding=padding)
    return q16_epilogue(acc, bq, bias_shift=fmt.frac_bits, relu=relu,
                        shift=fmt.frac_bits, raw_min=fmt.raw_min,
                        raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype)


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention oracle.  q: (BH, Sq, D), k / v: (BH, Sk, D)."""
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
