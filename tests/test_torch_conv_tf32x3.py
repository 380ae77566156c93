"""Why the float conv's tensor-core route runs split-precision TF32.

The route (``csrc/conv2d_tc.cuh``) feeds each f32 operand to the tensor
cores as two TF32 halves, x = hi + lo, both rounded to nearest (ties away
from zero, ``cvt.rna.tf32.f32``), and sums hi·lo + lo·hi + hi·hi in f32.
``repro_torch.kernels.ref.conv_taps_tf32`` emulates that arithmetic bit for
bit in its operands (only the order of the f32 sums differs from the card).
Here, on the contraction depths of VGG16 conv8 (3·3·512 = 4608) and AlexNet
conv1 (5·5·64 = 1600), at a small spatial size with unit-scale outputs, from
a numpy seed:

* 3xTF32 stays within 1e-4 (atol = rtol, the reference's route tolerance)
  of the float64 conv, of the port's plain version ``conv2d_plain`` and of
  the JAX package's ``ref.conv2d_ref``;
* one TF32 pass (hi·hi alone) does not.

The card tests (``tests/test_torch_kernels_gpu.py``) hold the kernel itself
to ``conv2d_plain`` at the same 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_plain

TOL = 1e-4

#: name, spatial size, Cin, Cout, kernel, padding (the layers' own K and Cin)
DEPTHS = [
    ("vgg16.conv8", 6, 512, 64, 3, 1),
    ("alexnet.conv1", 6, 64, 192, 5, 2),
]


def _operands(h, cin, cout, k, seed):
    """x ~ N(0, 1) and w ~ N(0, 1 / (k²·Cin)): outputs of unit scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    return x, w


def _conv_f64(x, w, pad):
    """The float64 conv (NHWC x, (K, K, Cin, Cout) w)."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=pad)
    return y.permute(0, 2, 3, 1)


def test_tf32_round_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 + 2 ** -20, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20, 0.0, -0.0],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 0.0, -0.0]
    assert ref.tf32_round(x).tolist() == want
    special = torch.tensor([float("inf"), float("-inf")])
    assert torch.equal(ref.tf32_round(special), special)
    assert torch.isnan(ref.tf32_round(torch.tensor([float("nan")]))).all()


def test_tf32_split_halves_are_tf32_and_cover_f32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.integers(
        -20, 20, 100_000)).astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for half in (hi, lo):  # the 13 low mantissa bits of a TF32 value are 0
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi + lo recovers x to 2^-21 of |x| (lo's own rounding); hi alone to 2^-11
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize("name,h,cin,cout,k,pad", DEPTHS, ids=[d[0] for d in DEPTHS])
def test_three_tf32_passes_reach_f32_one_does_not(name, h, cin, cout, k, pad):
    x, w = _operands(h, cin, cout, k, seed=cin + k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    f64 = _conv_f64(xt, wt, pad)
    three = ref.conv_taps_tf32(xt, wt, padding=pad, passes=3)
    one = ref.conv_taps_tf32(xt, wt, padding=pad, passes=1)
    plain = conv2d_plain(xt, wt, padding=pad)
    assert float(f64.abs().max()) > 1.0  # unit-scale outputs
    torch.testing.assert_close(three.double(), f64, atol=TOL, rtol=TOL)
    torch.testing.assert_close(three, plain, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one.double(), f64, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, plain, atol=TOL, rtol=TOL)
    # one pass misses by the TF32 step: ~5e-4 of each product, not f32's 6e-8
    assert float((one.double() - f64).abs().max()) > 10 * float((three.double() - f64).abs().max())


@pytest.mark.parametrize("name,h,cin,cout,k,pad", DEPTHS, ids=[d[0] for d in DEPTHS])
def test_port_route_matches_jax_reference(name, h, cin, cout, k, pad):
    """The route's wrapper (its plain version on CPU tensors) and the 3xTF32
    emulation against the JAX package's conv oracle, on the same inputs."""
    x, w = _operands(h, cin, cout, k, seed=cin * k)
    want = torch.from_numpy(np.array(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                                       padding=pad)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tau = 64 if cout % 128 else 128
    got = conv2d_cuda(xt, wt, padding=pad, conv_route="tc", tau=tau)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    emulated = ref.conv_taps_tf32(xt, wt, padding=pad)
    torch.testing.assert_close(emulated, want, atol=TOL, rtol=TOL)
