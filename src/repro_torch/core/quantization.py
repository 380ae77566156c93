"""Fixed-point Q-format quantization (paper §III.E: 16-bit, Q2.14), in PyTorch.

The port's copy of ``repro.core.quantization``.  Every function here is held
bit for bit against the JAX package on the same inputs (see
``tests/test_torch_quantization.py``):

  * :class:`QFormat` — a general Qm.n fixed-point format descriptor on an
    int16 or int8 storage rung.
  * ``quantize`` / ``dequantize`` — float <-> raw conversion.
    ``torch.round`` rounds half to even, like ``jnp.round``.
  * ``fake_quant`` — straight-through-estimator quantization, a
    ``torch.autograd.Function`` whose backward masks the gradient outside
    ``[lo, hi]`` (the reference's ``_fq_bwd``).
  * ``shift_saturate_i32`` — the one write-back ladder: round-half-up
    arithmetic shift of an int32 accumulator, with int32 wrap, then a clip.
    The CUDA kernels run the same arithmetic in ``csrc/common.cuh``.
  * ``qtensor_matmul_ref`` — the mixed-format GEMM oracle;
    ``qmatmul_ref`` / ``qmatmul_real`` — the single-format one, on raws and
    on real inputs (one GEMM of an FPGA deployment: float -> Q2.14 -> dot
    -> Q2.14 -> float).

Integer matmuls: CPU ``torch.mm`` on int16 returns int16 and wraps at 16
bits, so every product here is widened first.  :func:`int_matmul_i32` runs
the product in float64 — exact, since an int16·int16 product is below 2^30
and every contraction in the zoo is below 2^15 terms, so each partial sum
stays below 2^53 — and then wraps to int32 mod 2^32, as XLA's int32 dot
does.  Float64 works on the CPU and on the card alike (CUDA has no integer
``mm``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "QFormat",
    "Q2_14",
    "Q1_7",
    "Q2_6",
    "QTensor",
    "NumericsPolicy",
    "calibrate_format",
    "int8_rung",
    "int_matmul_i32",
    "wrap_i32",
    "quantize",
    "quantize_qtensor",
    "dequantize",
    "fake_quant",
    "fake_quant_fmt",
    "qmatmul_real",
    "qmatmul_ref",
    "qtensor_matmul_ref",
    "requantize_i32",
    "requantize_i32_to_i16",
    "shift_saturate_i32",
]


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Signed fixed point, paper convention: ``int_bits`` *includes* the sign.

    Q2.14 = 2 integer bits (one of which is the sign) + 14 fractional bits
    on an int16 rung; Q1.7 / Q2.6 live on the int8 rung.  Sub-width formats
    are legal: the raw range just does not fill the container.
    """

    int_bits: int
    frac_bits: int
    total_bits: int = 16

    def __post_init__(self):
        if self.total_bits not in (8, 16):
            raise ValueError(
                f"unsupported storage width {self.total_bits} (want 8 or 16)"
            )
        if self.int_bits + self.frac_bits > self.total_bits:
            raise ValueError(
                f"Qm.n with m+n > {self.total_bits} does not fit "
                f"int{self.total_bits} storage"
            )
        if self.int_bits < 1:
            raise ValueError("need at least the sign bit")

    @property
    def storage_dtype(self) -> torch.dtype:
        """The integer dtype raw values of this format are stored as."""
        return torch.int8 if self.total_bits == 8 else torch.int16

    @property
    def scale(self) -> float:
        """Multiplier from real value to raw integer."""
        return float(1 << self.frac_bits)

    @property
    def max_val(self) -> float:
        return 2.0 ** (self.int_bits - 1) - 2.0 ** (-self.frac_bits)

    @property
    def min_val(self) -> float:
        return -(2.0 ** (self.int_bits - 1))

    @property
    def raw_max(self) -> int:
        return (1 << (self.int_bits - 1 + self.frac_bits)) - 1

    @property
    def raw_min(self) -> int:
        return -(1 << (self.int_bits - 1 + self.frac_bits))

    @property
    def resolution(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def name(self) -> str:
        return f"Q{self.int_bits}.{self.frac_bits}"


#: The paper's format: 2 integer bits, 14 fractional bits.
Q2_14 = QFormat(int_bits=2, frac_bits=14)
#: int8 rungs of the precision ladder: Q1.7 covers [-1, 1), Q2.6 [-2, 2).
Q1_7 = QFormat(int_bits=1, frac_bits=7, total_bits=8)
Q2_6 = QFormat(int_bits=2, frac_bits=6, total_bits=8)


@dataclasses.dataclass
class QTensor:
    """Raw fixed-point values (int16 or int8 per ``fmt.storage_dtype``) plus
    the :class:`QFormat` they live on.  Grid-resident engine ops consume and
    produce QTensors without touching float."""

    raw: torch.Tensor
    fmt: QFormat = Q2_14

    @property
    def shape(self):
        return tuple(self.raw.shape)

    @property
    def ndim(self) -> int:
        return self.raw.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.raw.dtype

    def reshape(self, *shape) -> "QTensor":
        return QTensor(self.raw.reshape(*shape), self.fmt)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self.raw, self.fmt, dtype)


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """The numerics one forward pass runs under.

    ``name``: "float", "q16", "q8" or "mixed" (per-layer grids named by
    ``layer_fmts``, a sorted tuple of (layer_name, QFormat) pairs; layers
    not named fall back to ``fmt``).
    """

    name: str = "float"
    fmt: QFormat = Q2_14
    per_tensor_weights: bool = True
    layer_fmts: tuple = ()

    def __post_init__(self):
        if self.name not in ("float", "q16", "q8", "mixed"):
            raise ValueError(f"unknown numerics policy {self.name!r}")

    @property
    def quantized(self) -> bool:
        return self.name != "float"

    def fmt_for(self, layer: str) -> QFormat:
        """The activation grid of one named layer (``fmt`` if unnamed)."""
        for name, fmt in self.layer_fmts:
            if name == layer:
                return fmt
        return self.fmt


def calibrate_format(x, *, total_bits: int = 16,
                     max_frac: Optional[int] = None) -> QFormat:
    """Max-abs per-tensor Qm.n selection: the smallest integer-bit count whose
    range covers ``max|x|`` gets every remaining bit as fraction, optionally
    capped at ``max_frac`` (the accumulator-headroom rule)."""
    x = torch.as_tensor(x)
    maxabs = float(x.float().abs().max()) if x.numel() else 0.0
    for int_bits in range(1, total_bits + 1):
        frac = total_bits - int_bits
        if max_frac is not None:
            frac = max(0, min(frac, max_frac))
        fmt = QFormat(int_bits, frac, total_bits)
        if maxabs <= fmt.max_val:
            return fmt
    return QFormat(total_bits, 0, total_bits)  # saturating fallback


def int8_rung(fmt: QFormat) -> Optional[QFormat]:
    """The int8 rung covering the same real range as an int16 grid (Q2.14 ->
    Q2.6), or None when the range needs more than 7 + sign bits."""
    if fmt.int_bits >= 8:
        return None
    return QFormat(fmt.int_bits, 8 - fmt.int_bits, 8)


def quantize(x: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Real -> raw fixed point (``fmt.storage_dtype``), round half to even,
    saturating."""
    raw = torch.round(x.to(torch.float32) * fmt.scale)
    raw = torch.clamp(raw, fmt.raw_min, fmt.raw_max)
    return raw.to(fmt.storage_dtype)


def quantize_qtensor(x: torch.Tensor, fmt: Optional[QFormat] = None) -> QTensor:
    """Quantize to a :class:`QTensor`; ``fmt=None`` calibrates per-tensor."""
    fmt = fmt or calibrate_format(x)
    return QTensor(quantize(x, fmt), fmt)


def dequantize(q: torch.Tensor, fmt: QFormat = Q2_14,
               dtype=torch.float32) -> torch.Tensor:
    """Raw fixed point -> real."""
    return (q.to(torch.float32) * (1.0 / fmt.scale)).to(dtype)


class _FakeQuant(torch.autograd.Function):
    """Straight-through estimator, gated outside the representable range."""

    @staticmethod
    def forward(ctx, x, scale, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        q = torch.clamp(torch.round(x * scale) / scale, lo, hi)
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask = ((x >= ctx.lo) & (x <= ctx.hi)).to(g.dtype)
        return g * mask, None, None, None


def fake_quant(x: torch.Tensor, scale: float, lo: float, hi: float) -> torch.Tensor:
    return _FakeQuant.apply(x, scale, lo, hi)


def fake_quant_fmt(x: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """STE fake-quantization to ``fmt`` (for quantization-aware training)."""
    return fake_quant(x, fmt.scale, fmt.min_val, fmt.max_val)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 (or exact float64) values -> int32, wrapping mod 2^32."""
    v = v.to(torch.int64)
    return (((v + 2**31) % 2**32) - 2**31).to(torch.int32)


def int_matmul_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer (m, k) @ (k, n) with int32 wraparound, on any device.

    Computed in float64, which is exact while every partial sum stays below
    2^53 (int16·int16 < 2^30, k < 2^23), then wrapped mod 2^32.
    """
    if a.shape[-1] >= 2**23:
        raise ValueError(f"contraction {a.shape[-1]} too long for exact float64")
    return wrap_i32(torch.matmul(a.to(torch.float64), b.to(torch.float64)))


def shift_saturate_i32(acc: torch.Tensor, shift: int, raw_min: int,
                       raw_max: int, out_dtype=torch.int16) -> torch.Tensor:
    """The one write-back ladder on int32 values: round-half-up arithmetic
    right shift (the ``+ 2^(s-1)`` wraps in int32, as in the reference), an
    exact left shift for ``shift < 0`` (wrapping), then saturation into
    ``[raw_min, raw_max]`` stored as ``out_dtype``."""
    acc = acc.to(torch.int32)
    if shift > 0:
        # the reference adds an int32 constant (wrapping) before the shift
        shifted = wrap_i32(acc.to(torch.int64) + (1 << (shift - 1))) >> shift
    elif shift == 0:
        shifted = acc
    else:
        shifted = wrap_i32(acc.to(torch.int64) << (-shift))
    return torch.clamp(shifted, raw_min, raw_max).to(out_dtype)


def requantize_i32(acc: torch.Tensor, shift: int, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Saturating write-back of an int32 accumulator onto ``fmt``'s rung;
    ``shift`` is the scale gap ``fa + fb - n`` between accumulator and
    output grid."""
    return shift_saturate_i32(acc, shift, fmt.raw_min, fmt.raw_max,
                              fmt.storage_dtype)


def requantize_i32_to_i16(acc: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Same-format write-back: the accumulator of a product of two ``fmt``
    numbers sits at scale 2^(2·frac_bits), so the shift is one frac_bits."""
    return requantize_i32(acc, fmt.frac_bits, fmt)


def qmatmul_ref(xq: torch.Tensor, wq: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Single-format oracle of the fixed-point matmul: xq (m, k) and wq (k, n)
    raws on ``fmt`` -> (m, n) raws on ``fmt``, an int32 accumulator that
    wraps, then the saturating write-back."""
    return requantize_i32_to_i16(int_matmul_i32(xq, wq), fmt)


def qmatmul_real(x: torch.Tensor, w: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Quantize real inputs, run :func:`qmatmul_ref`, dequantize: the
    numerics an FPGA deployment of the paper sees for one GEMM."""
    return dequantize(qmatmul_ref(quantize(x, fmt), quantize(w, fmt), fmt), fmt)


def qtensor_matmul_ref(
    x: QTensor, w: QTensor, out_fmt: QFormat = Q2_14,
    bias: Optional[QTensor] = None, relu: bool = False,
) -> QTensor:
    """Mixed-format oracle for the grid-resident GEMM: x (m, k) Qa.fa times
    w (k, n) Qb.fb on a 2^(fa+fb) int32 accumulator, bias aligned by
    ``fa + fb - fc``, ReLU, then the write-back onto ``out_fmt``."""
    acc = int_matmul_i32(x.raw, w.raw)
    if bias is not None:
        bshift = x.fmt.frac_bits + w.fmt.frac_bits - bias.fmt.frac_bits
        if bshift < 0:
            raise ValueError(
                f"bias format {bias.fmt.name} finer than the accumulator grid"
            )
        acc = wrap_i32(acc.to(torch.int64) + (bias.raw.to(torch.int64) << bshift))
    if relu:
        acc = torch.clamp(acc, min=0)
    shift = x.fmt.frac_bits + w.fmt.frac_bits - out_fmt.frac_bits
    return QTensor(requantize_i32(acc, shift, out_fmt), out_fmt)
