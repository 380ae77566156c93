"""The port's flash attention held against the JAX package on the same inputs.

The port's ``kernels.ops.flash_attention`` runs here on CPU tensors, so its
wrapper runs the kernel's plain version (the CUDA kernel itself is checked
under the CPU shim in ``test_torch_kernels_emulated.py`` and on the card in
``test_torch_kernels_gpu.py``).  The reference is ``ops.flash_attention``
with its Pallas kernel in interpret mode, and the dense oracle
``ref.attention_ref``.  Tolerances: the reference's own 2e-3 against the
oracle (``tests/test_kernels.py``), and 1e-5 against the reference kernel
in f32, whose online softmax the plain version repeats; bf16 to one bf16
step (2^-7 relative), where p and the output are rounded in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

FA_CASES = [  # the reference's (tests/test_kernels.py): b, hq, hkv, sq, sk, d, causal
    (1, 4, 4, 64, 64, 32, True),
    (2, 8, 2, 64, 64, 32, True),   # GQA
    (1, 4, 1, 128, 128, 64, True),  # MQA
    (2, 4, 4, 64, 64, 32, False),
    (1, 2, 2, 96, 96, 32, True),   # non-multiple of block
]
#: decode-style: 16 query rows at the end of 64 keys (tests/test_kernels.py)
Q_OFFSET_CASE = (1, 2, 2, 16, 64, 32, True)
ORACLE_TOL = 2e-3
KERNEL_TOL = 1e-5


def _draw(case, seed):
    b, hq, hkv, sq, sk, d, _ = case
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((b, hq, sq, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, hkv, sk, d))).astype(np.float32)
    v = (0.5 * rng.standard_normal((b, hkv, sk, d))).astype(np.float32)
    return q, k, v


def _flat(q, k, v):
    """(B, H, S, D) -> the oracle's (B·Hq, S, D), kv broadcast over groups."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    kf = np.broadcast_to(k[:, :, None], (b, hkv, g, sk, d)).reshape(b * hq, sk, d)
    vf = np.broadcast_to(v[:, :, None], (b, hkv, g, sk, d)).reshape(b * hq, sk, d)
    return q.reshape(b * hq, sq, d), kf.copy(), vf.copy()


@pytest.fixture(scope="module")
def reference():
    """Per case: inputs, the reference kernel's output (interpret mode) and
    the oracle's, each computed once."""
    out = {}
    for i, case in enumerate(FA_CASES + [Q_OFFSET_CASE]):
        q, k, v = _draw(case, i)
        causal = case[-1]
        q_offset = case[4] - case[3]
        blk = 16 if case == Q_OFFSET_CASE else 32
        kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, q_offset=q_offset, bq=blk, bk=blk,
                                    interpret=True)
        oracle = jref.attention_ref(*map(jnp.asarray, _flat(q, k, v)), causal=causal,
                                    q_offset=q_offset)
        out[case] = (q, k, v, np.asarray(kern), np.asarray(oracle).reshape(q.shape))
    return out


def _port(q, k, v, case, **kw):
    blk = 16 if case == Q_OFFSET_CASE else 32
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=case[-1], q_offset=case[4] - case[3], bq=blk, bk=blk,
                              **kw)
    return got.numpy()


@pytest.mark.parametrize("case", FA_CASES + [Q_OFFSET_CASE], ids=str)
def test_flash_attention_vs_reference_kernel(reference, case):
    q, k, v, kern, _ = reference[case]
    np.testing.assert_allclose(_port(q, k, v, case), kern, atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("case", FA_CASES + [Q_OFFSET_CASE], ids=str)
def test_flash_attention_vs_oracle(reference, case):
    q, k, v, _, oracle = reference[case]
    np.testing.assert_allclose(_port(q, k, v, case), oracle, atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    # the port's own oracle is the reference's, to f32 rounding
    port_oracle = ref.attention_ref(*map(torch.from_numpy, _flat(q, k, v)),
                                    causal=case[-1], q_offset=case[4] - case[3])
    np.testing.assert_allclose(port_oracle.numpy().reshape(q.shape), oracle,
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_flash_attention_bf16_vs_reference_kernel():
    """bf16 inputs: p is rounded to bf16 before p·v and the output is bf16,
    in both packages; they agree to one bf16 step."""
    case = FA_CASES[1]
    q, k, v = _draw(case, 42)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(qb, kb, vb, causal=True, bq=32, bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (qb, kb, vb))
    got = ops.flash_attention(tq, tk, tv, causal=True, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -7, rtol=2 ** -7)


def test_non_causal_ragged_kv_raises_in_both():
    """A non-causal call whose Sk is not a multiple of bk raises ValueError,
    as the reference's does."""
    q, k, v = _draw((1, 2, 2, 32, 48, 32, False), 3)
    with pytest.raises(ValueError, match="sk % bk"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                             bq=32, bk=32, interpret=True)
    with pytest.raises(ValueError, match="sk % bk"):
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=False, bq=32, bk=32)


def test_gqa_reads_kv_heads_in_place():
    """The port's GQA wrapper takes (B, Hkv, Sk, D) k / v as they are and
    equals the oracle on the broadcast heads; shapes it cannot take raise."""
    case = FA_CASES[1]
    q, k, v = _draw(case, 5)
    got = _port(q, k, v, case)
    want = ref.attention_ref(*map(torch.from_numpy, _flat(q, k, v)), causal=True)
    np.testing.assert_allclose(got, want.numpy().reshape(q.shape), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16),
                            torch.zeros(1, 2, 8, 16))
