"""The fixed-point conv's tensor-core arithmetic and its wrapper, on the CPU.

``ref.conv_q16_limbs`` emulates route "tc" (``csrc/conv2d_q16_tc.cuh``):
int16 raws as a signed high and an unsigned low byte, each limb pair's tap
sums accumulated on their own with int32 wrap, recombined in uint32.  It is
held bit for bit against ``ref.conv_taps_i32`` and, through the q16
epilogue, against the reference's Pallas kernel in interpret mode, on every
width mix, at strides 1 / 2 / 4, with padding and at Cin not a multiple of
the route's 64-channel chunk; and at the two shapes where wrap-around
decides the result.  ``ref.conv_q16_weight_planes`` (the route's weight
preparation) is checked to hold the limbs, and the wrapper to run the plain
version for CPU tensors on either route.  The card tests
(``tests/test_torch_kernels_gpu.py``) hold the kernel itself to the same
plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import QFormat as JQFormat
from repro.kernels import ops as jops, ref as jref
from repro_torch.core.quantization import Q2_6, Q2_14, QFormat
from repro_torch.kernels import _build, ref
from repro_torch.kernels.conv2d import conv2d_q16_cuda, conv2d_q16_plain

DTYPES = {8: np.int8, 16: np.int16}

#: n, h, w, cin, cout, k, stride, pad
CASES = [
    (1, 9, 9, 20, 8, 3, 1, 1),     # Cin 20: one part chunk; pad 1
    (2, 11, 7, 70, 16, 3, 2, 1),   # stride 2, Cin 70: a whole chunk and a part one
    (1, 13, 13, 8, 24, 5, 4, 2),   # stride 4, 5x5, pad 2
    (1, 6, 5, 130, 8, 1, 1, 0),    # 1x1, three chunks
]
#: x bits, w bits, output format, shift, bias shift
MIXES = [
    (16, 16, Q2_14, 15, 1),
    (16, 8, Q2_6, 23, 7),
    (8, 16, Q2_14, 7, 1),
    (8, 8, Q2_6, 7, 6),
]


def _raws(rng, shape, bits):
    lim = 2 ** (bits - 1)
    return rng.integers(-lim, lim, shape).astype(DTYPES[bits])


def _jfmt(f: QFormat) -> JQFormat:
    return JQFormat(f.int_bits, f.frac_bits, f.total_bits)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mix", range(len(MIXES)))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_limb_sums_equal_the_reference(case, mix):
    """The limb arithmetic is the int32 tap sum, bit for bit; through the q16
    epilogue it is the reference's Pallas kernel (interpret mode)."""
    n, h, w, cin, cout, k, stride, pad = case
    xbits, wbits, fmt, shift, bshift = MIXES[mix]
    rng = np.random.default_rng(100 * sum(case) + mix)
    xq, wq = _raws(rng, (n, h, w, cin), xbits), _raws(rng, (k, k, cin, cout), wbits)
    bq = _raws(rng, (cout,), xbits)
    x, wt, b = _t(xq), _t(wq), _t(bq)
    acc = ref.conv_q16_limbs(x, wt, stride=stride, padding=pad)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, ref.conv_taps_i32(x, wt, stride=stride, padding=pad))
    got = ref.q16_epilogue(acc, b, bias_shift=bshift, relu=True, shift=shift,
                           raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                           out_dtype=fmt.storage_dtype)
    want = jops.conv2d_q16(jnp.asarray(xq), jnp.asarray(wq), bias=jnp.asarray(bq),
                           stride=stride, padding=pad, relu=True, fmt=_jfmt(fmt),
                           shift=shift, bias_shift=bshift, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrap_past_2_31_in_the_low_limbs():
    """Raws -1 at 3x3 x Cin 4096: the ll limb sum alone (255 · 255 · 36,864)
    passes 2^31, and the recombined sum is exactly 36,864, as in the
    reference's oracle."""
    xq = np.full((1, 3, 3, 4096), -1, np.int16)
    wq = np.full((3, 3, 4096, 8), -1, np.int16)
    x, wt = _t(xq), _t(wq)
    ll = ref.conv_taps_i32(x.to(torch.int32) & 0xFF, wt.to(torch.int32) & 0xFF)
    assert 255 * 255 * 36864 > 2 ** 31 and int(ll[0, 0, 0, 0]) < 0  # wrapped
    acc = ref.conv_q16_limbs(x, wt)
    assert int(acc.min()) == int(acc.max()) == 36864
    assert torch.equal(acc, ref.conv_taps_i32(x, wt))
    got = ref.q16_epilogue(acc, None, bias_shift=0, relu=False, shift=Q2_14.frac_bits,
                           raw_min=Q2_14.raw_min, raw_max=Q2_14.raw_max,
                           out_dtype=torch.int16)
    want = jref.conv2d_q16_ref(jnp.asarray(xq), jnp.asarray(wq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrap_of_the_int32_total_to_zero():
    """Raws -32768 at 1x1 x Cin 8: the int32 sum 8 · 2^30 = 2^33 wraps to 0."""
    xq = np.full((1, 3, 3, 8), -32768, np.int16)
    wq = np.full((1, 1, 8, 16), -32768, np.int16)
    acc = ref.conv_q16_limbs(_t(xq), _t(wq))
    assert int(acc.min()) == int(acc.max()) == 0
    want = jref.conv2d_q16_ref(jnp.asarray(xq), jnp.asarray(wq))
    got = ref.q16_epilogue(acc, None, bias_shift=0, relu=False, shift=Q2_14.frac_bits,
                           raw_min=Q2_14.raw_min, raw_max=Q2_14.raw_max,
                           out_dtype=torch.int16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [16, 8])
def test_weight_planes_hold_the_limbs(bits):
    """(limbs, Cout, K·K, Cinp) bytes: int16 as its signed hi byte and
    unsigned lo byte (hi·256 + lo = w), int8 as itself; K-major, zeros from
    Cin to Cinp."""
    rng = np.random.default_rng(bits)
    wq = _t(_raws(rng, (3, 3, 40, 24), bits))
    planes = ref.conv_q16_weight_planes(wq, 64)
    assert planes.shape == (bits // 8, 24, 9, 64) and planes.dtype == torch.uint8
    assert not planes[..., 40:].any()
    w_k = wq.permute(3, 0, 1, 2).reshape(24, 9, 40).to(torch.int32)  # (Cout, taps, Cin)
    signed = planes[0, ..., :40].view(torch.int8).to(torch.int32)
    if bits == 16:
        lo = planes[1, ..., :40].to(torch.int32)
        assert torch.equal(signed * 256 + lo, w_k)
        assert torch.equal(signed, w_k >> 8) and torch.equal(lo, w_k & 0xFF)
    else:
        assert torch.equal(signed, w_k)


@pytest.mark.parametrize("route", ["tc", "cudacore"])
def test_wrapper_runs_the_plain_version_for_cpu_tensors(route):
    """On CPU tensors either route's checks run, then the plain version;
    nothing is launched."""
    rng = np.random.default_rng(3)
    x, wt = _t(_raws(rng, (2, 10, 10, 32), 16)), _t(_raws(rng, (3, 3, 32, 16), 8))
    b = _t(_raws(rng, (16,), 16))
    _build.reset_launches()
    got = conv2d_q16_cuda(x, wt, b, stride=1, padding=1, relu=True, fmt=Q2_14, shift=15,
                          bias_shift=1, conv_route=route, tau=64 if route == "tc" else 16)
    want = conv2d_q16_plain(x, wt, b, stride=1, padding=1, relu=True, shift=15,
                            bias_shift=1, raw_min=Q2_14.raw_min, raw_max=Q2_14.raw_max,
                            out_dtype=torch.int16)
    assert torch.equal(got, want)
    assert _build.launches == dict.fromkeys(_build.KERNELS, 0)


def test_route_tc_refusals_raise_before_the_cpu_branch():
    """A call route "tc" does not take raises on CPU tensors too: Cin·bytes
    not a multiple of 16, Cout not a multiple of 8, a τ other than 64 on
    any width mix, a chunk other than 64, a split that leaves one empty.
    Nothing moves to the other route."""
    def call(cin=16, cout=16, xd=torch.int16, wd=torch.int16, **kw):
        x, wt = torch.zeros(1, 8, 8, cin, dtype=xd), torch.zeros(3, 3, cin, cout, dtype=wd)
        return conv2d_q16_cuda(x, wt, padding=1, conv_route="tc", **{"tau": 64, **kw})

    assert call().shape == (1, 8, 8, 16)
    assert call(xd=torch.int8, wd=torch.int8).shape == (1, 8, 8, 16)
    for bad in (dict(cin=12), dict(cin=8, xd=torch.int8), dict(cout=12), dict(tau=128),
                dict(xd=torch.int8, wd=torch.int8, tau=128),
                dict(tau=32), dict(cin_chunk=32), dict(cin=64, splits=2)):
        with pytest.raises(ValueError):
            call(**bad)
