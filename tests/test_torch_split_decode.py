"""A data-split decode step gives each of a rank's rows one device's bits,
on the CPU: the plain ops of a decode step against the rows' count.

* ``attention._sdpa_dense`` at decode shapes (one query row, GQA and MQA,
  with and without a mask, a key length whose rows do not start on a
  16-byte boundary): B rows, for B = 1..8, equal each rank's rows of every
  (f, 1) data split of them (``sharding.batch_split``; f divides B, so a
  rank holds 1..8 rows), and the reference's ``_sdpa_dense`` within its
  float tolerance;
* ``layers.split_einsum``, which carries those contractions and the SSD
  decode's output: ``torch.einsum`` without a split, one device's rows on
  every split;
* ``rglru.rglru_decode_step`` on B rows equals each row alone (output and
  new state: its conv's contraction is row-invariant as it is), with the
  template's GEMMs run a row at a time so the host BLAS, which blocks a
  GEMM by its row count, is out of the comparison (the GEMM plans keep the
  logical k order, ``tests/test_torch_sharding.py``).

``tests/test_torch_split_decode_gpu.py`` holds the same on the card at the
families' full widths, and the (2, 1) data split of recurrentgemma and
whisper against one card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

ROWS = range(1, 9)
#: the reference's float tolerance between attention routes
#: (tests/test_attention.py)
REF_TOL = 1e-5


def _qkv(b, h, hkv, d, t, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)  # the ring's layout
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    valid = rng.random((b, 1, 1, t)) < 0.8
    valid[..., 0] = True
    return q, k, v, valid


def _splits(b):
    """(f, this rank's rows) of every (f, 1) data split of b rows."""
    for f in (f for f in range(1, b + 1) if b % f == 0):
        r = b // f
        yield f, [slice(j * r, (j + 1) * r) for j in range(f)]


def _on_rank(f, fn, *args):
    with S.use_mesh(Mesh((f, 1), ("data", "model")), S.DECODE_RULES), S.batch_split(f):
        return fn(*args)


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("heads", [(8, 2), (4, 1)], ids=["gqa", "mqa"])
def test_sdpa_dense_split_rows(b, masked, heads):
    h, hkv = heads
    q, kc, vc, valid = (torch.from_numpy(a) for a in _qkv(b, h, hkv, 16, 37))
    mask = valid if masked else None

    def sdpa(q_, kc_, vc_, m_):
        # k / v as decode_attention hands them: the (B, Hkv, T, D) ring, transposed
        return A._sdpa_dense(q_, kc_.transpose(1, 2), vc_.transpose(1, 2), m_)

    full = sdpa(q, kc, vc, mask)
    for f, rows in _splits(b):
        for sl in rows:
            one = _on_rank(f, sdpa, q[sl].clone(), kc[sl].clone(), vc[sl].clone(),
                           None if mask is None else mask[sl].clone())
            assert torch.equal(one, full[sl]), (f, sl)
    want = JA._sdpa_dense(*(jnp.asarray(a.numpy()) for a in (q, kc.transpose(1, 2),
                                                              vc.transpose(1, 2))),
                          None if mask is None else jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=REF_TOL, atol=REF_TOL)


def _row_gemms(monkeypatch, module):
    """The module's ``dense`` run one row at a time (each row the same
    host GEMM call whatever the batch)."""
    plain = module.dense

    def dense(tpl, p, x, **kw):
        return torch.cat([plain(tpl, p, x[i:i + 1], **kw) for i in range(x.shape[0])])

    monkeypatch.setattr(module, "dense", dense)


def _block_params(cfg, kind):
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    for blk in params["blocks"]:
        if kind in blk:
            return {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()})
                    for k, v in blk[kind].items()}
    raise AssertionError(f"no {kind} block in {cfg.name}")


def _rows_alone(step, tpl, cfg, p, u, cache):
    full_out, full_cache = step(tpl, cfg, p, u, cache)
    for i in range(u.shape[0]):
        out, c = step(tpl, cfg, p, u[i:i + 1].clone(),
                      {k: t[i:i + 1].clone() for k, t in cache.items()})
        assert torch.equal(out, full_out[i:i + 1]), i
        for k in c:
            assert torch.equal(c[k], full_cache[k][i:i + 1]), (i, k)


@pytest.mark.parametrize("b", ROWS)
def test_rglru_decode_step_rows_alone(b, monkeypatch):
    _row_gemms(monkeypatch, R)
    cfg = reduced(get_config("recurrentgemma-9b"))
    p = _block_params(cfg, "rec")
    g = torch.Generator().manual_seed(b)
    u = torch.randn((b, 1, cfg.d_model), generator=g)
    cache = R.init_rglru_cache(cfg, b, torch.float32)
    cache = {k: torch.randn(t.shape, generator=g) for k, t in cache.items()}
    _rows_alone(R.rglru_decode_step, default_template("torch", device="cpu"), cfg, p, u,
                cache)


#: the contractions a decode step makes over the logical batch: the scores
#: and values of ``_sdpa_dense`` and the SSD output, at small decode shapes
EINSUMS = {"scores": ("bshgd,bthd->bhgst", (1, 2, 3, 8), (37, 2, 8)),
           "values": ("bhgst,bthd->bshgd", (2, 3, 1, 37), (37, 2, 8)),
           "ssd_out": ("bhpn,bhn->bhp", (4, 8, 16), (4, 16))}


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name", sorted(EINSUMS))
def test_split_einsum_rows(b, name):
    eq, sa, sb = EINSUMS[name]
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, *sa)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((b, *sb)).astype(np.float32))
    full = L.split_einsum(eq, x, y)
    assert torch.equal(full, torch.einsum(eq, x, y))
    for f, rows in _splits(b):
        for sl in rows:
            got = _on_rank(f, L.split_einsum, eq, x[sl].clone(), y[sl].clone())
            assert torch.equal(got, full[sl]), (f, sl)
