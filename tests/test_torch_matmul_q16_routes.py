"""The q16 GEMM's tensor-core arithmetic and its routes' plans, on the CPU.

``ref.matmul_q16_limbs`` emulates route "wgmma" (``csrc/gemm_q16_wgmma.cuh``):
int16 raws as a signed high and an unsigned low byte, each limb product
summed on its own with int32 wrap, recombined in uint32.  It is held bit for
bit against ``int_matmul_i32``, the JAX reference's ``matmul_q16_ref`` and
the reference's Pallas kernel in interpret mode, for every width mix,
output rung, ReLU and the wide read-out, over ragged shapes; and at the two
shapes where wrap-around decides the result.  The wrapper's CPU path is
checked to accept each route's plan and to run the plain version for it.
The card tests (``tests/test_torch_kernels_gpu.py``) hold the kernels
themselves to the same plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core.quantization import QFormat as JQFormat
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import dse
from repro_torch.core.engine import PlanRegistry
from repro_torch.core.quantization import (Q2_6, Q2_14, QFormat, QTensor, int8_rung,
                                          int_matmul_i32)
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import ref
from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, plan_for

DTYPES = {8: np.int8, 16: np.int16}


def _raws(rng, shape, bits):
    lim = 2 ** (bits - 1)
    return rng.integers(-lim, lim, shape).astype(DTYPES[bits])


def _jfmt(f: QFormat) -> JQFormat:
    return JQFormat(f.int_bits, f.frac_bits, f.total_bits)


@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(m=st.integers(1, 40), k=st.integers(1, 300), n=st.integers(1, 70),
       xbits=st.sampled_from([8, 16]), wbits=st.sampled_from([8, 16]),
       rung=st.sampled_from(["int16", "int8", "wide"]), relu=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_limb_products_equal_the_reference(m, k, n, xbits, wbits, rung, relu, seed):
    """The limb arithmetic is the int32 dot: bit for bit against
    ``int_matmul_i32``, and with the epilogue against the JAX reference's
    Pallas kernel (interpret mode) on every width mix and rung."""
    rng = np.random.default_rng(seed)
    xq, wq = _raws(rng, (m, k), xbits), _raws(rng, (k, n), wbits)
    bq = _raws(rng, (n,), xbits)
    x, w, b = (torch.from_numpy(a) for a in (xq, wq, bq))
    acc = ref.matmul_q16_limbs(x, w)
    assert torch.equal(acc, int_matmul_i32(x, w))
    fmt = Q2_6 if rung == "int8" else Q2_14
    wide = rung == "wide"
    shift, bshift = (0, 5) if wide else (xbits // 2 + wbits // 2 + 3, 2)
    want = jops.matmul_q16(jnp.asarray(xq), jnp.asarray(wq), bias=jnp.asarray(bq),
                           relu=relu, fmt=_jfmt(fmt), shift=shift, bias_shift=bshift,
                           wide=wide, interpret=True)
    got = ref.q16_epilogue(acc, b, bias_shift=bshift, relu=relu, shift=shift,
                           raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                           out_dtype=fmt.storage_dtype, wide=wide)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", [Q2_14, QFormat(4, 12), Q2_6])
def test_limb_products_under_the_jax_oracle(fmt):
    """``shift_saturate`` of the limb sums equals ``jref.matmul_q16_ref``."""
    rng = np.random.default_rng(fmt.total_bits + fmt.frac_bits)
    bits = fmt.total_bits
    xq, wq = _raws(rng, (19, 133), bits), _raws(rng, (133, 45), bits)
    want = jref.matmul_q16_ref(jnp.asarray(xq), jnp.asarray(wq), _jfmt(fmt))
    acc = ref.matmul_q16_limbs(torch.from_numpy(xq), torch.from_numpy(wq))
    got = ref.shift_saturate_i32(acc, fmt.frac_bits, fmt.raw_min, fmt.raw_max,
                                 fmt.storage_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_low_limb_sum_wraps_and_the_total_is_exact():
    """Raws x = w = -1 at k = 40,960: hi = -1 and lo = 255, so the ll limb
    sum alone, 255² x 40,960, passes 2^31 and wraps in its s32 accumulator;
    recombined mod 2^32 the product is exactly 40,960, which ``wide`` reads."""
    k = 40960
    x = torch.full((2, k), -1, dtype=torch.int16)
    w = torch.full((k, 3), -1, dtype=torch.int16)
    (hi, _), (lo, _) = ref.q16_limbs(x)
    assert int(hi[0, 0]) == -1 and int(lo[0, 0]) == 255
    assert 255 * 255 * k > 2 ** 31
    acc = ref.matmul_q16_limbs(x, w)
    assert torch.equal(acc, torch.full((2, 3), k, dtype=torch.int32))
    got = matmul_q16_cuda(x, w, block=plan_for(x, w), wide=True, shift=0, bias_shift=0)
    assert torch.equal(got, acc)


def test_int32_sum_wraps_to_zero():
    """Raws x = w = -32768 at k = 4: each product is 2^30 and the sum 2^32,
    which wraps to 0 in int32, in the limbs (hh·2^16 = 2^32) as in the
    reference."""
    x = torch.full((1, 4), -32768, dtype=torch.int16)
    w = torch.full((4, 2), -32768, dtype=torch.int16)
    acc = ref.matmul_q16_limbs(x, w)
    assert torch.equal(acc, int_matmul_i32(x, w)) and int(acc.abs().max()) == 0
    want = jops.matmul_q16(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), fmt=_jfmt(Q2_14),
                           shift=0, bias_shift=0, wide=True, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))


def test_limb_planes_hold_the_limbs():
    """``ref.q16_limb_planes``: int16 -> (hi, lo) bytes, int8 -> itself, zeros
    from k to kp; the bytes read back as s8 / u8 rebuild the raws."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_raws(rng, (7, 50), 16))
    p = ref.q16_limb_planes(x, 128)
    assert p.shape == (2, 7, 128) and p.dtype == torch.uint8
    assert int(p[:, :, 50:].abs().max()) == 0
    hi = p[0, :, :50].view(torch.int8).to(torch.int32)
    lo = p[1, :, :50].to(torch.int32)
    assert torch.equal(hi * 256 + lo, x.to(torch.int32))
    x8 = torch.from_numpy(_raws(rng, (3, 20), 8))
    p8 = ref.q16_limb_planes(x8, 128)
    assert p8.shape == (1, 3, 128) and torch.equal(p8[0, :, :20].view(torch.int8), x8)


@pytest.mark.parametrize("m,xbits,wbits", [(4, 16, 16), (16, 8, 16), (17, 16, 8),
                                           (300, 8, 8), (300, 16, 16)])
def test_wrapper_takes_each_routes_plan_on_the_cpu(m, xbits, wbits):
    """The planner's route for the shape (split-k to m = 16, wgmma above)
    and route "tile" when named: the wrapper accepts each, and on CPU
    tensors runs the plain version for it."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_raws(rng, (m, 90), xbits))
    w = torch.from_numpy(_raws(rng, (90, 33), wbits))
    b = torch.from_numpy(_raws(rng, (33,), 16))
    want = matmul_q16_cuda(x, w, b, block=MatmulBlock(16, 64, 16), relu=True, shift=18,
                           bias_shift=2)
    blk = plan_for(x, w)
    assert blk.route == ("splitk" if m <= 16 else "wgmma")
    got = matmul_q16_cuda(x, w, b, block=blk, relu=True, shift=18, bias_shift=2)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not take"):
        matmul_q16_cuda(x, w, b, block=MatmulBlock(128, 256, 128, route="wgmma"))


def test_registry_key_holds_the_widths():
    """The q16 plan is keyed by the raws' widths: one shape planned for
    int16 x int16 and for int8 x int8 makes two entries, BN 64 (three s32
    accumulators) and BN 128; the engine plans from its operands' widths."""
    reg = PlanRegistry()
    a = reg.block_for(6272, 512, 4608, H100)
    b = reg.block_for(6272, 512, 4608, H100, xbits=8, wbits=8)
    assert (a.bn, b.bn) == (64, 128) and reg.misses == 2
    assert reg.block_for(6272, 512, 4608, H100, xbits=16, wbits=16) is a
    assert ("matmul_q16", 6272, 512, 4608, 8, 8, H100) in reg._blocks
    eng = default_template("q16", device="cpu").engine
    eng.plan_cache.clear()
    x8 = torch.zeros(40, 256, dtype=torch.int8)
    w8 = torch.zeros(256, 200, dtype=torch.int8)
    q8 = int8_rung(Q2_14)
    eng.matmul(QTensor(x8, q8), QTensor(w8, q8), qout=q8)
    got = eng.plan_cache._blocks[("matmul_q16", 40, 200, 256, 8, 8, H100)]
    assert got == dse.default_q16_block_for(40, 200, 256, H100, xbits=8, wbits=8)
