"""Each kernel's plain version (what a wrapper runs for CPU tensors) held
against the JAX package: ``repro.kernels.ref`` and the JAX route wrappers
in ``repro.kernels.ops`` with their Pallas kernels in interpret mode.

Integer results are compared bit for bit; float results at the reference's
own tolerances (1e-4 GEMM f32, 2e-2 bf16, 2e-3 conv; ``tests/test_kernels.py``).
The cases cover strides, padding, the im2col route, the reference's tiled
regimes, int8/int16 mixes, mixed-format shifts and the wide read-out.  The
wrappers' argument checks are exercised here too: they run before the
device dispatch, so a CPU call raises exactly where a CUDA call would.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import QFormat as JQFormat
from repro.kernels import ops as jops, ref as jref
from repro_torch.core.quantization import Q2_6, Q2_14, QFormat
from repro_torch.core.tiling import MatmulBlock
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_q16_cuda
from repro_torch.kernels.matmul_fp import matmul_fp_cuda
from repro_torch.kernels.matmul_q16 import matmul_q16_cuda


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jfmt(f: QFormat) -> JQFormat:
    return JQFormat(f.int_bits, f.frac_bits, f.total_bits)


def _raws(rng, shape, dtype):
    lim = 127 if dtype == np.int8 else 32767
    return rng.integers(-lim - 1, lim + 1, shape).astype(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# float GEMM
# ---------------------------------------------------------------------------

MM_SHAPES = [(8, 8, 8), (33, 57, 65), (100, 60, 36), (1, 128, 128), (8, 300, 70)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["none", "bias_relu_q"])
def test_matmul_fp_plain_vs_jax(m, k, n, dtype, epilogue):
    rng = _rng("mmfp", m, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.3
    b = rng.standard_normal(n).astype(np.float32) if epilogue != "none" else None
    kw = dict(relu=True, qout=Q2_14) if epilogue != "none" else {}
    jkw = dict(relu=True, qout=_jfmt(Q2_14)) if epilogue != "none" else {}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want = jops.matmul_fp(xj, wj, bias=None if b is None else jnp.asarray(b),
                          interpret=True, **jkw)
    want_ref = jref.matmul_fused_ref(xj, wj, None if b is None else jnp.asarray(b), **jkw)
    xt, wt = _t(x).to(tdt), _t(w).to(tdt)
    got = ops.matmul_fp(xt, wt, bias=None if b is None else _t(b), **kw)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), np.asarray(want_ref, np.float32), atol=tol, rtol=tol)


def test_matmul_fp_ref_oracles_match():
    rng = _rng("mmref")
    x = rng.standard_normal((20, 30)).astype(np.float32)
    w = rng.standard_normal((30, 10)).astype(np.float32)
    np.testing.assert_allclose(ref.matmul_ref(_t(x), _t(w)).numpy(),
                               np.asarray(jref.matmul_ref(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# fixed-point GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (64, 100, 48), (33, 57, 65)])
@pytest.mark.parametrize("fmt", [Q2_14, QFormat(4, 12), QFormat(8, 8)])
def test_matmul_q16_plain_vs_jax_same_format(m, k, n, fmt):
    rng = _rng("mmq", m, k, n, fmt.name)
    xq = _raws(rng, (m, k), np.int16)
    wq = _raws(rng, (k, n), np.int16)
    bq = _raws(rng, (n,), np.int16)
    jf = _jfmt(fmt)
    want = jops.matmul_q16(jnp.asarray(xq), jnp.asarray(wq), bias=jnp.asarray(bq),
                           relu=True, fmt=jf, interpret=True)
    want_ref = jref.matmul_q16_fused_ref(jnp.asarray(xq), jnp.asarray(wq),
                                         jnp.asarray(bq), fmt=jf, relu=True)
    got = ops.matmul_q16(_t(xq), _t(wq), bias=_t(bq), relu=True, fmt=fmt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(
        ref.matmul_q16_ref(_t(xq), _t(wq), fmt).numpy(),
        np.asarray(jref.matmul_q16_ref(jnp.asarray(xq), jnp.asarray(wq), jf)))


MIXES = [
    # x dtype, w dtype, out fmt, shift, bias_shift, wide
    (np.int16, np.int16, Q2_14, 15, 1, False),
    (np.int8, np.int16, Q2_14, 7, 1, False),   # int8 -> int16 boundary
    (np.int16, np.int8, Q2_6, 23, 7, False),   # int16 -> int8 boundary
    (np.int8, np.int8, Q2_6, 7, 7, False),
    (np.int16, np.int16, Q2_14, -2, 0, False),  # exact up-scale
    (np.int16, np.int16, Q2_14, 0, 29, True),   # wide read-out
    (np.int8, np.int16, Q2_6, 0, 15, True),
]


@pytest.mark.parametrize("xd,wd,fmt,shift,bshift,wide", MIXES)
def test_matmul_q16_plain_vs_jax_mixed(xd, wd, fmt, shift, bshift, wide):
    rng = _rng("mix", str(xd), str(wd), shift, bshift, wide)
    m, k, n = 12, 200, 40
    xq, wq = _raws(rng, (m, k), xd), _raws(rng, (k, n), wd)
    bq = _raws(rng, (n,), xd)
    want = jops.matmul_q16(jnp.asarray(xq), jnp.asarray(wq), bias=jnp.asarray(bq),
                           relu=not wide, fmt=_jfmt(fmt), shift=shift,
                           bias_shift=bshift, wide=wide, interpret=True)
    got = ops.matmul_q16(_t(xq), _t(wq), bias=_t(bq), relu=not wide, fmt=fmt,
                         shift=shift, bias_shift=bshift, wide=wide)
    assert got.dtype == (torch.int32 if wide else fmt.storage_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# im2col
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2), (11, 4)])
def test_im2col_matches_jax(dtype, k, stride):
    """Integer raws are gathered in float32 (``F.unfold`` takes no int16),
    exactly, and cast back."""
    rng = _rng("im2col", str(dtype), k, stride)
    x = rng.standard_normal((2, 23, 21, 3)).astype(np.float32)
    if dtype != np.float32:
        x = _raws(rng, x.shape, dtype)
    cols_j, ho_j, wo_j = jops.im2col(jnp.asarray(x), k, k, stride)
    cols_t, ho_t, wo_t = ops.im2col(_t(x), k, k, stride)
    assert (ho_t, wo_t) == (ho_j, wo_j)
    assert cols_t.numpy().dtype == np.asarray(cols_j).dtype
    np.testing.assert_array_equal(cols_t.numpy(), np.asarray(cols_j))
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(ops.conv_gemm_weights(_t(w)).numpy(),
                                  np.asarray(jops.conv_gemm_weights(jnp.asarray(w))))


# ---------------------------------------------------------------------------
# conv (float)
# ---------------------------------------------------------------------------

CONV_CASES = [
    # n, h, w, cin, cout, k, stride, pad
    (1, 8, 8, 3, 8, 3, 1, 0),
    (2, 12, 12, 4, 16, 3, 1, 1),
    (1, 16, 16, 8, 8, 5, 1, 2),
    (1, 27, 27, 3, 16, 11, 4, 2),  # AlexNet-conv0-like
    (1, 9, 9, 2, 6, 2, 2, 0),
    (1, 14, 14, 1, 6, 5, 1, 0),  # LeNet-conv0-like (Cin 1)
]


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,pad", CONV_CASES)
@pytest.mark.parametrize("route", ["direct", "im2col"])
def test_conv2d_plain_vs_jax(n, h, w, cin, cout, k, stride, pad, route):
    rng = _rng("conv", n, h, w, cin, cout, k, stride, pad)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal(cout).astype(np.float32)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(wt), bias=jnp.asarray(b),
                       stride=stride, padding=pad, relu=True, route=route,
                       interpret=True)
    want_ref = jref.conv2d_fused_ref(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                     stride=stride, padding=pad, relu=True)
    got = ops.conv2d(_t(x), _t(wt), bias=_t(b), stride=stride, padding=pad,
                     relu=True, route=route)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("tile_rows,tile_cols,halo_mode", [
    (3, 0, "two_block"), (5, 0, "two_block"), (4, 6, "dma"), (7, 0, "dma"),
])
def test_conv2d_tiled_regimes_vs_jax(tile_rows, tile_cols, halo_mode):
    """The reference's tiled regimes, with its fake-quant epilogue.  JAX's
    DMA regime does not run on this jax, so the DMA cases are held to the
    untiled interpret kernel (the reference's own tiled == untiled law)."""
    rng = _rng("tiled", tile_rows, tile_cols, halo_mode)
    x = rng.standard_normal((2, 15, 13, 5)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 5, 12)).astype(np.float32) * 0.3
    b = rng.standard_normal(12).astype(np.float32)
    jkw = dict(bias=jnp.asarray(b), padding=1, relu=True, qout=_jfmt(Q2_14),
               tau=8, interpret=True)
    if halo_mode == "two_block":
        want = jops.conv2d(jnp.asarray(x), jnp.asarray(wt), tile_rows=tile_rows,
                           halo_mode=halo_mode, **jkw)
    else:
        want = jops.conv2d(jnp.asarray(x), jnp.asarray(wt), **jkw)
    got = ops.conv2d(_t(x), _t(wt), bias=_t(b), padding=1, relu=True, qout=Q2_14,
                     tau=8, tile_rows=tile_rows, tile_cols=tile_cols,
                     halo_mode=halo_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# conv (fixed point)
# ---------------------------------------------------------------------------

Q_CONV_MIXES = [
    (np.int16, np.int16, Q2_14, 15, 1),
    (np.int8, np.int16, Q2_14, 7, 1),
    (np.int16, np.int8, Q2_6, 23, 7),
    (np.int8, np.int8, Q2_6, 7, 6),
]


# every small case under every mix; the 121-tap case (slow in interpret
# mode) under the int16 -> int8 boundary mix
Q_CONV_CASES = [(c, mix) for c in CONV_CASES[:5] if c[5] != 11
                for mix in range(len(Q_CONV_MIXES))] + [(CONV_CASES[3], 2)]


@pytest.mark.parametrize("case,mix", Q_CONV_CASES)
def test_conv2d_q16_plain_vs_jax(case, mix):
    n, h, w, cin, cout, k, stride, pad = case
    xd, wd, fmt, shift, bshift = Q_CONV_MIXES[mix]
    rng = _rng("qconv", n, h, w, cin, cout, k, stride, pad, mix)
    xq = _raws(rng, (n, h, w, cin), xd)
    wq = _raws(rng, (k, k, cin, cout), wd)
    bq = _raws(rng, (cout,), xd)
    want = jops.conv2d_q16(jnp.asarray(xq), jnp.asarray(wq), bias=jnp.asarray(bq),
                           stride=stride, padding=pad, relu=True, fmt=_jfmt(fmt),
                           shift=shift, bias_shift=bshift, interpret=True)
    for route in ("direct", "im2col"):
        got = ops.conv2d_q16(_t(xq), _t(wq), bias=_t(bq), stride=stride, padding=pad,
                             relu=True, fmt=fmt, shift=shift, bias_shift=bshift,
                             route=route)
        assert got.dtype == fmt.storage_dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv2d_q16_ref_oracle_matches():
    rng = _rng("qconvref")
    xq = _raws(rng, (2, 10, 10, 3), np.int16)
    wq = _raws(rng, (3, 3, 3, 7), np.int16)
    bq = _raws(rng, (7,), np.int16)
    want = jref.conv2d_q16_ref(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bq),
                               stride=2, padding=1, relu=True)
    got = ref.conv2d_q16_ref(_t(xq), _t(wq), _t(bq), stride=2, padding=1, relu=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_t = conv2d_q16_cuda(_t(xq), _t(wq), _t(bq), stride=2, padding=1, relu=True,
                            tile_rows=2, halo_mode="two_block")
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the wrappers' checks (run before the device dispatch)
# ---------------------------------------------------------------------------


def test_cpu_calls_run_the_plain_versions_and_launch_nothing():
    _build.reset_launches()
    x = torch.randn(4, 6, 6, 2)
    w = torch.randn(3, 3, 2, 8)
    conv2d_cuda(x, w, padding=1)
    matmul_fp_cuda(torch.randn(3, 4), torch.randn(4, 5))
    q = torch.zeros(3, 4, dtype=torch.int16)
    matmul_q16_cuda(q, torch.zeros(4, 5, dtype=torch.int16))
    conv2d_q16_cuda(x.to(torch.int16), w.to(torch.int16), padding=1)
    assert _build.launches == dict.fromkeys(_build.KERNELS, 0)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x, w = torch.randn(4, 8), torch.randn(8, 5)
    with pytest.raises(TypeError):
        matmul_fp_cuda(x, w.double())
    with pytest.raises(ValueError):
        matmul_fp_cuda(x, torch.randn(7, 5))
    with pytest.raises(ValueError):
        matmul_fp_cuda(x, w, block=MatmulBlock(256, 256, 256))
    with pytest.raises(ValueError):
        matmul_fp_cuda(x, w, torch.randn(4))
    with pytest.raises(ValueError):
        matmul_fp_cuda(x, w.to("meta"))  # operands on two devices
    q = torch.zeros(4, 8, dtype=torch.int16)
    with pytest.raises(TypeError):
        matmul_q16_cuda(q.to(torch.int32), torch.zeros(8, 5, dtype=torch.int16))
    with pytest.raises(ValueError):
        matmul_q16_cuda(q, torch.zeros(8, 5, dtype=torch.int16), shift=40)
    with pytest.raises(ValueError):
        matmul_q16_cuda(q, torch.zeros(8, 5, dtype=torch.int16), bias_shift=-1,
                        bias=torch.zeros(5, dtype=torch.int16))
    img, wt = torch.randn(1, 10, 10, 3), torch.randn(3, 3, 3, 8)
    with pytest.raises(ValueError):
        conv2d_cuda(img, torch.randn(3, 3, 3, 64), tau=48)  # no such τ
    with pytest.raises(ValueError):
        conv2d_cuda(img, wt, tile_rows=2)  # two-block: stride*tile_rows < kh
    with pytest.raises(ValueError):
        conv2d_cuda(img, wt, tile_cols=4, halo_mode="two_block")
    with pytest.raises(ValueError):
        conv2d_cuda(img, wt, cin_chunk=4)  # more than Cin
    with pytest.raises(ValueError):
        conv2d_cuda(img, torch.randn(3, 3, 4, 8))
    with pytest.raises(TypeError):
        conv2d_cuda(img.double(), wt.double())
    with pytest.raises(ValueError):
        ops.conv2d(img, wt, route="winograd")


def test_jax_tile_too_small_error_kept():
    """The two-block legality error is the reference's (tests/test_conv_routes)."""
    x = jnp.ones((1, 10, 10, 3))
    w = jnp.ones((3, 3, 3, 8))
    with pytest.raises(ValueError, match="too small"):
        jops.conv2d(x, w, tile_rows=2, interpret=True)
    with pytest.raises(ValueError, match="too small"):
        conv2d_cuda(torch.ones(1, 10, 10, 3), torch.ones(3, 3, 3, 8), tile_rows=2)
