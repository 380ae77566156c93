"""Why flash attention's tensor-core route runs split-precision bf16.

The route (``csrc/flash_wgmma.cuh``) feeds each f32 operand of QKᵀ and PV to
the tensor cores as two bf16 halves, x = hi + lo, both rounded to nearest
even, and sums hi·lo + lo·hi + hi·hi in f32; p is split the same way before
PV.  ``repro_torch.kernels.ref.attention_split_bf16`` emulates that
arithmetic in its operands (only the order of the f32 sums differs from the
card).  Here, at a reduced GQA shape of the serving model's head dim (64),
from a numpy seed, at unit scale and with q and k scaled so that the largest
|score| passes 20 (where an error in the scores grows through the exponent):

* split bf16 stays within 2e-3 (atol = rtol, the reference's flash
  tolerance) of the JAX package's ``ref.attention_ref``, of a float64
  attention and of the port's plain version;
* one bf16 pass (hi alone) misses 2e-3 in the scaled case;
* bf16 operands leave the lo planes zero, so that dtype runs one product.

The card tests (``tests/test_torch_kernels_gpu.py``) hold the kernel itself
to the plain version at 2e-3 and to this emulation at 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_plain

TOL = 2e-3
#: batch, q heads, kv heads, Sq = Sk (three 128-key tiles, the last ragged), D
B, HQ, HKV, S, D = 1, 4, 2, 300, 64
#: q and k scale: unit, and one whose scores pass |s| = 20
SCALES = [("unit", 1.0), ("scaled", 2.6)]


def _operands(scale, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, HQ, S, D)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, HKV, S, D)) * scale).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    return q, k, v


def _attention_f64(q, k, v, causal=True):
    """Dense softmax attention in float64, kv heads shared by their group."""
    g = q.shape[1] // k.shape[1]
    qd, kd, vd = (torch.from_numpy(x).double() for x in (q, k, v))
    kd, vd = kd.repeat_interleave(g, dim=1), vd.repeat_interleave(g, dim=1)
    s = qd @ kd.transpose(-1, -2) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    return torch.softmax(s, dim=-1) @ vd, s


def _jax_ref(q, k, v):
    """The JAX package's dense oracle on (B·Hq, S, D), kv heads expanded."""
    g = HQ // HKV
    ke, ve = (np.repeat(x, g, axis=1).reshape(B * HQ, S, D) for x in (k, v))
    out = jref.attention_ref(jnp.asarray(q.reshape(B * HQ, S, D)), jnp.asarray(ke),
                             jnp.asarray(ve), causal=True)
    return torch.from_numpy(np.array(out)).reshape(B, HQ, S, D)


def test_bf16_split_halves_are_bf16_and_cover_f32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.integers(
        -20, 20, 100_000)).astype(np.float32))
    hi, lo = ref.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - x.double()).abs()
    # hi + lo recovers x to 2^-16 of |x| (lo's own rounding); hi alone to 2^-8
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert bool(((hi.double() - x.double()).abs() <= 2.0 ** -8 * x.double().abs()).all())
    # ties go to even, as __float2bfloat16_rn
    ulp = 2.0 ** -7
    t = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, -(1 + ulp / 2)], dtype=torch.float32)
    assert ref.bf16_split(t)[0].float().tolist() == [1.0, 1 + 2 * ulp, -1.0]


def test_bf16_operands_have_zero_lo_planes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    hi, lo = ref.bf16_split(x)
    assert torch.equal(hi, x)
    assert not bool(lo.float().abs().any())
    # so the emulation of bf16 operands is one product a GEMM, p rounded to bf16
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _operands(1.0, 2))
    three = ref.attention_split_bf16(q, k, v, passes=3)
    one = ref.attention_split_bf16(q, k, v, passes=1)
    assert torch.equal(three, one)
    want = flash_attention_plain(q, k, v, bk=128)
    torch.testing.assert_close(three.float(), want.float(), atol=2 ** -7, rtol=2 ** -7)


@pytest.mark.parametrize("name,scale", SCALES, ids=[s[0] for s in SCALES])
def test_three_bf16_passes_reach_the_reference_one_does_not(name, scale):
    q, k, v = _operands(scale, seed=int(scale * 10))
    f64, scores = _attention_f64(q, k, v)
    big = float(scores.masked_fill(scores.isinf(), 0).abs().max())
    assert big > (20.0 if name == "scaled" else 2.0)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    three = ref.attention_split_bf16(qt, kt, vt)
    one = ref.attention_split_bf16(qt, kt, vt, passes=1)
    jax_want = _jax_ref(q, k, v)
    torch.testing.assert_close(three, jax_want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(three.double(), f64, atol=TOL, rtol=TOL)
    torch.testing.assert_close(three, flash_attention_plain(qt, kt, vt), atol=TOL, rtol=TOL)
    err3 = float((three.double() - f64).abs().max())
    err1 = float((one.double() - f64).abs().max())
    assert err1 > 10 * err3
    if name == "scaled":
        with pytest.raises(AssertionError):
            torch.testing.assert_close(one.double(), f64, atol=TOL, rtol=TOL)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(one, jax_want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_offset,causal", [(0, True), (40, True), (0, False)])
def test_split_emulation_tiles_like_the_plain_version(q_offset, causal):
    """Ragged kv tiles, a q_offset, non-causal, and both tiles of the route
    (128 keys at D 64, 64 at D 128): the emulation is the plain version's
    function."""
    rng = np.random.default_rng(q_offset + causal)
    for d, bk in ((64, 128), (128, 64)):
        sq, sk = 70, 70 + q_offset
        q = torch.from_numpy(rng.standard_normal((2, 4, sq, d)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((2, 1, sk, d)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((2, 1, sk, d)).astype(np.float32))
        got = ref.attention_split_bf16(q, k, v, causal=causal, q_offset=q_offset, bk=bk)
        want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
