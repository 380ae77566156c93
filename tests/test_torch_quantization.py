"""The port's fixed-point numerics held bit for bit against the JAX package.

Same numpy inputs through ``repro.core.quantization`` and
``repro_torch.core.quantization``: saturation at the int16 / int8 raw
bounds, both tie conventions (half-even ``quantize``, half-up write-back),
negative shifts, int32 wrap of the accumulator and of the rounding add, the
STE gradient, calibration and the mixed-format GEMM oracle.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import quantization as jq
from repro_torch.core import quantization as tq

FORMATS = [(2, 14, 16), (1, 15, 16), (4, 12, 16), (8, 8, 16), (1, 7, 8),
           (2, 6, 8), (2, 5, 8)]


def _fmts(spec):
    return jq.QFormat(*spec), tq.QFormat(*spec)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("spec", FORMATS)
def test_qformat_properties_match(spec):
    jf, tf = _fmts(spec)
    for attr in ("scale", "max_val", "min_val", "raw_max", "raw_min",
                 "resolution", "name"):
        assert getattr(jf, attr) == getattr(tf, attr), attr
    assert tf.storage_dtype == (torch.int8 if spec[2] == 8 else torch.int16)


def test_qformat_validation_matches():
    for bad in [(10, 10, 16), (0, 14, 16), (4, 5, 8), (2, 2, 32)]:
        with pytest.raises(ValueError):
            jq.QFormat(*bad)
        with pytest.raises(ValueError):
            tq.QFormat(*bad)


@pytest.mark.parametrize("spec", FORMATS)
def test_quantize_dequantize_bitexact(spec):
    rng = np.random.default_rng(sum(spec))
    jf, tf = _fmts(spec)
    span = 2.0 ** (spec[0] - 1)
    x = (rng.standard_normal(4096) * span * 1.5).astype(np.float32)
    # exact ties: half-integers on the raw grid, both signs, and the bounds
    ties = (np.arange(-40, 40) + 0.5) / tf.scale
    edges = [tf.max_val, tf.min_val, tf.max_val + tf.resolution / 2,
             tf.min_val - tf.resolution / 2, 1e9, -1e9, 0.0]
    x = np.concatenate([x, ties, edges]).astype(np.float32)
    qj = np.asarray(jq.quantize(jnp.asarray(x), jf))
    qt = _np(tq.quantize(torch.from_numpy(x), tf))
    np.testing.assert_array_equal(qt, qj)
    assert qt.dtype == qj.dtype
    assert qt.max() <= tf.raw_max and qt.min() >= tf.raw_min
    dj = np.asarray(jq.dequantize(jnp.asarray(qj), jf))
    dt = _np(tq.dequantize(torch.from_numpy(qt), tf))
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("n", [-7, -3, -1, 0, 1, 2, 5, 100])
def test_quantize_tie_rounds_half_to_even(n):
    x = np.float32((n + 0.5) / tq.Q2_14.scale)
    want = int(jq.quantize(jnp.float32(x)))
    assert int(tq.quantize(torch.tensor(x))) == want == round(n + 0.5)


@given(st.floats(min_value=-300, max_value=300, allow_nan=False))
@settings(max_examples=60, deadline=None)
def test_saturation_pins_match(x):
    for jf, tf in (_fmts((2, 14, 16)), _fmts((1, 7, 8)), _fmts((2, 6, 8))):
        want = np.asarray(jq.quantize(jnp.float32(x), jf))
        got = _np(tq.quantize(torch.tensor(np.float32(x)), tf))
        assert got == want


@pytest.mark.parametrize("spec", [(2, 14, 16), (2, 6, 8), (1, 7, 8)])
def test_fake_quant_forward_and_ste_backward(spec):
    jf, tf = _fmts(spec)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-3, 3, 500),
                        [jf.max_val, jf.min_val, jf.max_val + 1e-3, -5.0]]).astype(np.float32)
    yj = np.asarray(jq.fake_quant_fmt(jnp.asarray(x), jf))
    gj = np.asarray(jax.grad(lambda v: (jq.fake_quant_fmt(v, jf) * 3.0).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    yt = tq.fake_quant_fmt(xt, tf)
    (yt * 3.0).sum().backward()
    np.testing.assert_array_equal(_np(yt), yj)
    np.testing.assert_array_equal(_np(xt.grad), gj)


@pytest.mark.parametrize("shift", [-12, -3, -1, 0, 1, 2, 7, 14, 15, 22, 29])
@pytest.mark.parametrize("spec", [(2, 14, 16), (2, 6, 8)])
def test_shift_saturate_bitexact(shift, spec):
    """Half-up ties, negative (wrapping) left shifts, saturation, and the
    int32 wrap of the rounding add at the top of the range."""
    jf, tf = _fmts(spec)
    rng = np.random.default_rng(shift + 100)
    acc = rng.integers(-2**31, 2**31, 3000, dtype=np.int64).astype(np.int32)
    base = np.arange(-20, 20, dtype=np.int64)
    extra = [2**31 - 1, -2**31, 2**31 - 2, 0, 1, -1]
    if shift > 0:
        half = 1 << (shift - 1)
        extra += list(((base << shift) + half).clip(-2**31, 2**31 - 1))  # exact ties
        extra += [2**31 - half, 2**31 - half - 1]  # the add wraps past 2^31
    acc = np.concatenate([acc, np.asarray(extra, np.int64).astype(np.int32)])
    want = np.asarray(jq.requantize_i32(jnp.asarray(acc), shift, jf))
    got = _np(tq.requantize_i32(torch.from_numpy(acc), shift, tf))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_requantize_tie_rounds_half_up():
    # acc = (2k + 1) * 2^13 is an exact tie at shift 14: half-up, not half-even
    acc = np.array([(2 * k + 1) << 13 for k in range(-4, 4)], np.int32)
    want = np.asarray(jq.requantize_i32(jnp.asarray(acc), 14, jq.Q2_14))
    got = _np(tq.requantize_i32(torch.from_numpy(acc), 14, tq.Q2_14))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(-4, 4) + 1)


@given(st.floats(min_value=0.0, max_value=300.0, allow_nan=False))
@settings(max_examples=60, deadline=None)
def test_calibrate_format_matches(maxabs):
    x = np.array([maxabs, -maxabs / 3], np.float32)
    for bits in (16, 8):
        for max_frac in (None, 3, 9):
            want = jq.calibrate_format(jnp.asarray(x), total_bits=bits, max_frac=max_frac)
            got = tq.calibrate_format(torch.from_numpy(x), total_bits=bits, max_frac=max_frac)
            assert (got.int_bits, got.frac_bits, got.total_bits) == (
                want.int_bits, want.frac_bits, want.total_bits)


@pytest.mark.parametrize("spec", FORMATS + [(8, 8, 16), (9, 7, 16)])
def test_int8_rung_matches(spec):
    jf, tf = _fmts(spec)
    want, got = jq.int8_rung(jf), tq.int8_rung(tf)
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.int_bits, got.frac_bits, got.total_bits) == (
            want.int_bits, want.frac_bits, want.total_bits)


def test_policy_fmt_for_and_validation():
    pol = tq.NumericsPolicy("mixed", layer_fmts=(("conv0", tq.Q2_6),))
    assert pol.fmt_for("conv0") == tq.Q2_6 and pol.fmt_for("fc0") == tq.Q2_14
    assert pol.quantized and not tq.NumericsPolicy("float").quantized
    with pytest.raises(ValueError):
        tq.NumericsPolicy("q4")


WIDTHS = [(16, 16), (16, 8), (8, 16), (8, 8)]


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("out_spec", [(2, 14, 16), (2, 6, 8), (1, 15, 16)])
@pytest.mark.parametrize("relu", [False, True])
def test_qtensor_matmul_ref_bitexact(widths, out_spec, relu):
    """Mixed-width oracle with full-range raws, so the int32 accumulator
    wraps: the float64 product must wrap exactly like XLA's int32 dot."""
    rng = np.random.default_rng(zlib.crc32(repr((widths, out_spec, relu)).encode()))
    fa = jq.QFormat(2, 14) if widths[0] == 16 else jq.QFormat(2, 6, 8)
    fw = jq.QFormat(1, 15) if widths[1] == 16 else jq.QFormat(1, 7, 8)
    m, k, n = 9, 300, 17
    lo_a, lo_w = -(1 << (widths[0] - 1)), -(1 << (widths[1] - 1))
    xr = rng.integers(lo_a, -lo_a, (m, k)).astype(f"int{widths[0]}")
    wr = rng.integers(lo_w, -lo_w, (k, n)).astype(f"int{widths[1]}")
    # the bias lives on the input's grid, as the engine pins it
    br = rng.integers(lo_a, -lo_a, n).astype(f"int{widths[0]}")
    jo = jq.QFormat(*out_spec)
    want = jq.qtensor_matmul_ref(
        jq.QTensor(jnp.asarray(xr), fa), jq.QTensor(jnp.asarray(wr), fw), jo,
        bias=jq.QTensor(jnp.asarray(br), fa), relu=relu)
    got = tq.qtensor_matmul_ref(
        tq.QTensor(torch.from_numpy(xr), tq.QFormat(fa.int_bits, fa.frac_bits, fa.total_bits)),
        tq.QTensor(torch.from_numpy(wr), tq.QFormat(fw.int_bits, fw.frac_bits, fw.total_bits)),
        tq.QFormat(*out_spec),
        bias=tq.QTensor(torch.from_numpy(br),
                        tq.QFormat(fa.int_bits, fa.frac_bits, fa.total_bits)),
        relu=relu)
    np.testing.assert_array_equal(_np(got.raw), np.asarray(want.raw))
    assert got.fmt.name == want.fmt.name


def test_int_matmul_wraps_mod_2_32():
    """The raw product of full-scale int16 operands over k = 25088 (VGG16
    fc0) overflows int32; it must wrap exactly as XLA's int32 dot does."""
    k = 25088
    x = np.full((2, k), 32767, np.int16)
    w = np.full((k, 3), 32767, np.int16)
    w[::2, 1] = -32768
    want = np.asarray(jnp.dot(jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32),
                              preferred_element_type=jnp.int32))
    got = _np(tq.int_matmul_i32(torch.from_numpy(x), torch.from_numpy(w)))
    np.testing.assert_array_equal(got, want)
    exact = x[0].astype(np.int64) @ w[:, 0].astype(np.int64)
    assert exact > 2**31 and got[0, 0] == ((exact + 2**31) % 2**32) - 2**31


def test_qtensor_basics():
    q = tq.QTensor(torch.zeros((2, 3, 4), dtype=torch.int16), tq.Q2_14)
    assert q.shape == (2, 3, 4) and q.ndim == 3 and q.dtype == torch.int16
    assert q.reshape(2, -1).shape == (2, 12)
    assert q.dequantize().dtype == torch.float32
