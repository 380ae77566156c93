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
    "conv_q16_limbs",
    "conv_q16_weight_planes",
    "tf32_round",
    "tf32_split",
    "attention_ref",
    "attention_split_bf16",
    "bf16_split",
    "matmul_q16_limbs",
    "q16_limb_planes",
    "q16_limbs",
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


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) in bf16: hi rounds x to nearest (ties to even, as
    ``__float2bfloat16_rn``), lo rounds x - hi the same way.  For bf16 x, hi
    is x and lo is zero."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


#: log2(e) in f32, as flash attention's route "wgmma" folds it into the scale
_LOG2E = 1.4426950408889634


def attention_split_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0, bk: int = 128,
                         passes: int = 3) -> torch.Tensor:
    """Flash attention's route "wgmma" (``csrc/flash_wgmma.cuh``) in its
    operands' arithmetic.  q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D) -> (B,
    Hq, Sq, D) in q's dtype.  Each operand is split into bf16 planes
    (:func:`bf16_split`) and each product issued as hi·lo + lo·hi + hi·hi
    (``passes`` 3) or hi·hi alone (1), exact products summed in f32; the
    online softmax runs per kv tile of ``bk`` keys in the log2 domain (the
    scale times log2(e), ``exp2``) with an f32 max, denominator and
    accumulator, masked scores at -1e30; p is split too, and rounded to
    bf16 (its hi plane alone) when v is bf16, as the reference rounds p to
    v's dtype.  Only the order of the f32 sums differs from the card."""
    f32 = torch.float32
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv

    def planes(x):
        hi, lo = (t.to(f32) for t in bf16_split(x))
        return hi, (lo if passes == 3 else torch.zeros_like(lo))

    def mm(a, bt):  # a @ bt over split planes, the small products first
        (ah, al), (bh, bl) = a, bt
        return (ah @ bl + al @ bh) + ah @ bh

    sl2 = torch.tensor(1.0 / d ** 0.5, dtype=f32) * torch.tensor(_LOG2E, dtype=f32)
    qs = planes(q.reshape(b, hkv, g, sq, d))
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq, 1), -1e30, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=f32, device=q.device)
    for c0 in range(0, sk, bk):
        if causal and c0 > q_offset + sq - 1:
            break
        kb = planes(k[:, :, None, c0:c0 + bk])
        vb = planes(v[:, :, None, c0:c0 + bk])
        s = mm(qs, tuple(t.transpose(-1, -2) for t in kb)) * sl2.to(q.device)
        if causal:
            cols = c0 + torch.arange(kb[0].shape[-2], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph, pl = planes(p)
        if v.dtype != f32:
            pl = torch.zeros_like(pl)
        acc = acc * alpha + mm((ph, pl), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(b, hq, sq, d)


# ---------------------------------------------------------------------------
# the fixed-point GEMM's tensor-core arithmetic
# ---------------------------------------------------------------------------


def q16_limbs(t: torch.Tensor) -> list[tuple[torch.Tensor, int]]:
    """A raw tensor as its 8-bit limbs, (int32 values, weight's shift) each:
    int16 -> [(hi, 8), (lo, 0)], hi = t >> 8 (arithmetic: a signed byte) and
    lo = t & 0xFF (an unsigned byte), so t = hi·2^8 + lo exactly; int8 ->
    [(t, 0)], one signed byte."""
    v = t.to(torch.int32)
    if t.dtype == torch.int8:
        return [(v, 0)]
    if t.dtype != torch.int16:
        raise TypeError(f"q16 limbs of int8 or int16 raws, not {t.dtype}")
    return [(v >> 8, 8), (v & 0xFF, 0)]


def q16_limb_planes(t: torch.Tensor, kp: int) -> torch.Tensor:
    """The q16 GEMM's preparation launch for one operand: t (rows, k) raws
    -> (limbs, rows, kp) uint8, each limb's bytes (the signed hi limb in
    two's complement) and zeros in the columns from k to kp.  x is passed
    as it is; w (k, n) as ``w.t()``, whose planes are then (n, kp): the
    transposed, K-major operand 8-bit wgmma takes."""
    rows, k = t.shape
    out = torch.zeros((len(q16_limbs(t)), rows, kp), dtype=torch.uint8, device=t.device)
    for i, (limb, _) in enumerate(q16_limbs(t)):
        out[i, :, :k] = (limb & 0xFF).to(torch.uint8)
    return out


def matmul_q16_limbs(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The q16 GEMM's route "wgmma" (``csrc/gemm_q16_wgmma.cuh``) in its own
    arithmetic: each operand split into limbs (:func:`q16_limbs`), every
    limb product summed on its own with int32 wrap (an s32 wgmma
    accumulator with no ``.satfinite``; hl and lh share one), then
    recombined in uint32: hh·2^16 + (hl + lh)·2^8 + ll, mod 2^32.  Equal
    to ``int_matmul_i32(xq, wq)`` bit for bit, since each per-limb sum is
    exact mod 2^32.  No main-path code calls it."""
    by_shift: dict = {}
    for a, sa in q16_limbs(xq):
        for b, sb in q16_limbs(wq):
            part = int_matmul_i32(a, b).to(torch.int64)
            by_shift[sa + sb] = wrap_i32(by_shift.get(sa + sb, 0) + part).to(torch.int64)
    total = sum(acc << shift for shift, acc in by_shift.items())
    return wrap_i32(total)


# ---------------------------------------------------------------------------
# the fixed-point conv's tensor-core arithmetic
# ---------------------------------------------------------------------------


def conv_q16_limbs(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """The fixed-point conv's route "tc" (``csrc/conv2d_q16_tc.cuh``) in its
    own arithmetic: x and w split into limbs (:func:`q16_limbs`), each limb
    pair's conv summed over every tap and channel on its own with int32 wrap
    (an s32 wgmma accumulator with no ``.satfinite``; hl and lh share one),
    then recombined in uint32: hh·2^16 + (hl + lh)·2^8 + ll, mod 2^32.  Equal
    to ``conv_taps_i32(xq, wq)`` bit for bit.  No main-path code calls it."""
    by_shift: dict = {}
    for a, sa in q16_limbs(xq):
        for b, sb in q16_limbs(wq):
            part = conv_taps_i32(a, b, stride=stride, padding=padding).to(torch.int64)
            by_shift[sa + sb] = wrap_i32(by_shift.get(sa + sb, 0) + part).to(torch.int64)
    total = sum(acc << shift for shift, acc in by_shift.items())
    return wrap_i32(total)


def conv_q16_weight_planes(wq: torch.Tensor, cinp: int) -> torch.Tensor:
    """Route "tc"'s weight preparation: wq (K, K, Cin, Cout) raws -> (limbs,
    Cout, K·K, cinp) uint8, each limb's bytes (the signed hi limb in two's
    complement) with zeros from Cin to cinp: K-major, as 8-bit wgmma takes
    its B operand."""
    kh, kw, cin, cout = wq.shape
    return q16_limb_planes(wq.permute(3, 0, 1, 2).reshape(cout * kh * kw, cin),
                           cinp).reshape(-1, cout, kh * kw, cinp)
