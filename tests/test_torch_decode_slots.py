"""The port's slot-indexed KV cache and per-row decode held against the JAX
package, and the bucket ladder the scheduler plans with.

Reduced qwen2-0.5b (2 layers, d 64, GQA 4:2, head dim 16, f32), reference
weights with numpy-drawn QKV biases and norm scales, carried across with
``repro_torch.convert``; caches, tokens and positions are numpy draws from
fixed seeds.  The port runs on the CPU (its kernel wrappers' plain
versions), the reference on the CPU with its ``xla`` / ``q16`` templates.

Tolerances:

* the bucket ladder, the batch rungs and ``plan_gemm_ladder``'s planned
  shapes are exact, and so are the cache constructors and the scheduler's
  cache maintenance (``init_cache(per_slot=True)``, ``insert_cache_slot``,
  ``insert_cache_rows``, ``clear_cache_rows``, ``_trim_cache_positions``):
  bit for bit;
* float per-slot ``decode_attention``, ``decode_step`` and
  ``prefill_chunk_step`` within 1e-4 of the reference's ``xla`` backend
  (the reference's GEMM tolerance, ``tests/test_kernels.py``), written
  positions and the rows of gated-off lanes (t < 0) bit for bit;
* q16, each layer fed the reference's own input: the new v rows and the
  positions bit for bit, k within 1 LSB (k crosses the float RoPE island,
  whose f32 cos / sin differ by an ulp between the frameworks), the layer
  output within 2e-3 (``test_torch_transformer.py``'s q16 tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import engine as jengine
from repro.core.template import TemplateConfig as JTemplateConfig
from repro.core.template import default_template as j_template
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core.template import TemplateConfig, default_template
from repro_torch.core.tiling import TPU_V5E
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T

FLOAT_TOL = 1e-4
Q16_TOL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy / jax tree -> the port's tree of CPU tensors (copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_j(v) for v in tree)
    return jnp.asarray(np.array(tree))


def _assert_tree_equal(got, want, what=""):
    """Port tree == reference tree, bit for bit (values and dtypes)."""
    got, want = _np_port(got), _np(want)
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for a, b in zip(gl, wl):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                         a.dtype, b.dtype)
        assert np.array_equal(a, b), what


def _np_port(tree):
    if isinstance(tree, dict):
        return {k: _np_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_np_port(v) for v in tree)
    return tree.numpy()


@pytest.fixture(scope="module")
def setup():
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    tree = _np(JT.init_params(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.default_rng(1)
    for blk in tree["blocks"]:
        for name in ("wq", "wk", "wv"):
            b = blk["attn"][name]["b"]
            blk["attn"][name]["b"] = (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
        for name in ("norm", "ffn_norm"):
            s = blk[name]["scale"]
            blk[name]["scale"] = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg_j, cfg, params_j, transformer_params_from_numpy(tree)


def _random_slot_cache(cfg, slots, cache_len, rng, dtype=np.float32):
    """A per-slot cache (numpy) with random rings and a ragged fill: slot b
    holds positions 0 .. fill[b]-1 (slot 0 empty)."""
    g = cfg.n_layers
    shape = (g, slots, cfg.n_kv_heads, cache_len, cfg.head_dim)
    if np.issubdtype(dtype, np.integer):
        k = rng.integers(-3000, 3000, shape).astype(dtype)
        v = rng.integers(-3000, 3000, shape).astype(dtype)
    else:
        k = rng.standard_normal(shape).astype(dtype)
        v = rng.standard_normal(shape).astype(dtype)
    fill = [0] + [int(x) for x in rng.integers(1, cache_len - 4, slots - 1)]
    pos = np.full((g, slots, cache_len), -1, np.int32)
    for b, n in enumerate(fill):
        pos[:, b, :n] = np.arange(n)
    return {"blocks": ({"attn": {"k": k, "v": v, "pos": pos}},), "tail": ()}, fill


# ---------------------------------------------------------------------------
# the bucket ladder (exact)
# ---------------------------------------------------------------------------


@given(st.integers(0, 4096),
       st.lists(st.integers(1, 4096), min_size=1, max_size=6, unique=True))
@settings(max_examples=60, deadline=None)
def test_bucket_for_matches_reference(length, ladder):
    assert tengine.bucket_for(length, ladder) == jengine.bucket_for(length, ladder)
    assert tengine.bucket_for(length, (8, 16, 64, 256, 1024)) == \
        jengine.bucket_for(length, (8, 16, 64, 256, 1024))


@given(st.integers(1, 300))
@settings(max_examples=40, deadline=None)
def test_batch_rungs_match_reference(slots):
    assert tengine.batch_rungs(slots) == jengine.batch_rungs(slots)


def test_ladder_edges_raise_as_the_reference():
    for fn in (tengine.bucket_for, jengine.bucket_for):
        with pytest.raises(ValueError):
            fn(-1, (8,))
    for fn in (tengine.batch_rungs, jengine.batch_rungs):
        with pytest.raises(ValueError):
            fn(0)


@given(st.lists(st.integers(1, 512), min_size=1, max_size=4, unique=True),
       st.sampled_from([(1,), (1, 2, 4), (1, 2, 3)]),
       st.sampled_from([(96, 64), (896, 128), (128, 4864)]))
@settings(max_examples=12, deadline=None)
def test_plan_gemm_ladder_matches_reference(ladder, batches, nk):
    """The same rungs and the same planned shapes; under the TPU spec the
    port's planner returns the reference's blocks as well."""
    n, k = nk
    mine = tengine.Engine(TemplateConfig(backend="q16", hw=TPU_V5E, device="cpu"),
                          plan_cache=tengine.PlanRegistry())
    ref = jengine.Engine(JTemplateConfig(backend="pallas", interpret=True),
                         plan_cache=jengine.PlanRegistry())
    got = mine.plan_gemm_ladder(ladder, n, k, batches=batches)
    want = ref.plan_gemm_ladder(ladder, n, k, batches=batches)
    assert sorted(got) == sorted(want)
    for m in want:
        g, w = got[m], want[m]
        assert (g.m, g.n, g.k) == (w.m, w.n, w.k)
        assert (g.block.bm, g.block.bn, g.block.bk) == (w.block.bm, w.block.bn, w.block.bk)
    assert mine.plan_cache.misses == ref.plan_cache.misses == len(want)
    # a second ladder plans nothing
    mine.plan_gemm_ladder(ladder, n, k, batches=batches)
    assert mine.plan_cache.misses == len(want)


# ---------------------------------------------------------------------------
# cache construction and maintenance (bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_slot", [False, True])
def test_init_cache_matches_reference(setup, per_slot):
    cfg_j, cfg, _, _ = setup
    from repro.core.quantization import NumericsPolicy as JPolicy
    from repro_torch.core.quantization import NumericsPolicy

    _assert_tree_equal(T.init_cache(cfg, 3, 12, per_slot=per_slot),
                       JT.init_cache(cfg_j, 3, 12, per_slot=per_slot))
    _assert_tree_equal(T.init_cache(cfg, 2, 9, per_slot=per_slot, policy=NumericsPolicy("q16")),
                       JT.init_cache(cfg_j, 2, 9, per_slot=per_slot, policy=JPolicy("q16")))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_cache_maintenance_bit_identical(setup, dtype):
    """insert_cache_slot / insert_cache_rows / clear_cache_rows /
    _trim_cache_positions on the same numpy caches give the reference's
    bytes, and the in-place variants the functional ones'."""
    cfg_j, cfg, _, _ = setup
    rng = np.random.default_rng(5)
    slots, clen = 4, 16
    cache, _ = _random_slot_cache(cfg, slots, clen, rng, dtype)
    # a batched (3, L) prefill cache: shared pos (C,) per group
    rows = _random_slot_cache(cfg, 3, clen, rng, dtype)[0]
    rows["blocks"][0]["attn"]["pos"] = np.tile(
        np.where(np.arange(clen) < 11, np.arange(clen), -1).astype(np.int32), (cfg.n_layers, 1))
    one = {"blocks": ({"attn": {k: v[:, :1] if k != "pos" else v
                                for k, v in rows["blocks"][0]["attn"].items()}},),
           "tail": ()}

    _assert_tree_equal(T._trim_cache_positions(_t(rows), 7),
                       JT._trim_cache_positions(_j(rows), 7), "trim")
    for vl in (None, 5):
        _assert_tree_equal(T.insert_cache_slot(_t(cache), 2, _t(one), valid_len=vl),
                           JT.insert_cache_slot(_j(cache), 2, _j(one), valid_len=vl),
                           f"insert_cache_slot valid_len={vl}")
    src = np.array([2, 0, 1, 0], np.int32)
    sel = np.array([True, False, True, True])
    vlen = np.array([3, 1, 11, 6], np.int32)
    want = JT.insert_cache_rows(_j(cache), _j(rows), src_rows=src, sel=sel, valid_lens=vlen)
    _assert_tree_equal(T.insert_cache_rows(_t(cache), _t(rows), src_rows=src, sel=sel,
                                           valid_lens=vlen), want, "insert_cache_rows")
    mine = _t(cache)
    leaf = mine["blocks"][0]["attn"]["k"]
    out = T.insert_cache_rows(mine, _t(rows), src_rows=src, sel=sel, valid_lens=vlen,
                              inplace=True)
    assert out is mine and out["blocks"][0]["attn"]["k"] is leaf
    _assert_tree_equal(mine, want, "insert_cache_rows in place")
    clr = np.array([False, True, False, True])
    want = JT.clear_cache_rows(_j(cache), clr)
    _assert_tree_equal(T.clear_cache_rows(_t(cache), clr), want, "clear_cache_rows")
    mine = _t(cache)
    T.clear_cache_rows(mine, clr, inplace=True)
    _assert_tree_equal(mine, want, "clear_cache_rows in place")


# ---------------------------------------------------------------------------
# per-slot decode (float)
# ---------------------------------------------------------------------------


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("s,t,n_valid", [
    (1, [5, -1, 0, 12], None),             # one token a row; lane 1 off, lane 2 at 0
    (3, [4, -1, 9, 0], [3, 0, 2, 1]),     # a chunk a row, ragged
    (1, 7, None),                          # a shared 0-d t over every row
])
def test_per_slot_decode_attention_matches_reference(setup, s, t, n_valid):
    cfg_j, cfg, params_j, params = setup
    rng = np.random.default_rng(11)
    slots, clen = 4, 16
    cache, _ = _random_slot_cache(cfg, slots, clen, rng)
    layer = {k: v[0] for k, v in cache["blocks"][0]["attn"].items()}
    x = (0.5 * rng.standard_normal((slots, s, cfg.d_model))).astype(np.float32)
    tj = jnp.asarray(np.asarray(t, np.int32))
    nv_j = None if n_valid is None else jnp.asarray(np.asarray(n_valid, np.int32))
    out_j, c_j = jattn.decode_attention(j_template("xla"), _layer0(params_j["blocks"][0])["attn"],
                                        jnp.asarray(x), _j(layer), cfg=cfg_j, t=tj,
                                        n_valid=nv_j)
    tt = torch.as_tensor(np.asarray(t, np.int64))
    nv = None if n_valid is None else torch.as_tensor(np.asarray(n_valid))
    for backend in ("cuda", "torch"):
        tpl = default_template(backend, device="cpu")
        before = _t(layer)
        out, c = tattn.decode_attention(tpl, T._at(params["blocks"][0], 0)["attn"],
                                        torch.from_numpy(x), before, cfg=cfg, t=tt,
                                        n_valid=nv)
        assert torch.equal(before["k"], _t(layer)["k"]), "the cache passed in moved"
        assert np.array_equal(c["pos"].numpy(), np.asarray(c_j["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(), np.asarray(c_j[name]),
                                       atol=FLOAT_TOL, rtol=FLOAT_TOL)
        tv = np.broadcast_to(np.asarray(t), (slots,))
        for b in np.flatnonzero(tv < 0):  # gated lanes: rows untouched, bit for bit
            for name in ("k", "v", "pos"):
                assert np.array_equal(c[name][b].numpy(), layer[name][b]), (b, name)
        live = tv >= 0
        np.testing.assert_allclose(out.numpy()[live], np.asarray(out_j)[live],
                                   atol=FLOAT_TOL, rtol=FLOAT_TOL)
        # in place: the same tensors, the same bytes as the functional step
        mine = _t(layer)
        out2, c2 = tattn.decode_attention(tpl, T._at(params["blocks"][0], 0)["attn"],
                                          torch.from_numpy(x), mine, cfg=cfg, t=tt,
                                          n_valid=nv, inplace=True)
        assert c2["k"] is mine["k"] and torch.equal(out2, out)
        for name in ("k", "v", "pos"):
            assert torch.equal(c2[name], c[name])


@pytest.mark.parametrize("t_kind", ["int", "0-d tensor"])
def test_shared_cache_decode_takes_int_or_device_t(setup, t_kind):
    """The shared-position cache (generate's) decodes at an int or a 0-d
    tensor alike, and matches the reference."""
    cfg_j, cfg, params_j, params = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    lg_j, cache_j = JT.prefill(j_template("xla"), cfg_j, params_j, jnp.asarray(toks[:, :6]),
                               cache_len=10)
    dec_j, c_j = JT.decode_step(j_template("xla"), cfg_j, params_j, jnp.asarray(toks[:, 6:]),
                                6, cache_j)
    tpl = default_template("cuda", device="cpu")
    _, cache = T.prefill(tpl, cfg, params, torch.from_numpy(toks[:, :6]).long(), cache_len=10)
    t = 6 if t_kind == "int" else torch.tensor(6)
    dec, c = T.decode_step(tpl, cfg, params, torch.from_numpy(toks[:, 6:]).long(), t, cache)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert np.array_equal(c["blocks"][0]["attn"]["pos"].numpy(),
                          np.asarray(c_j["blocks"][0]["attn"]["pos"]))


def _hostless(monkeypatch):
    """Make every read of a tensor's value on the host raise: a step that
    passes under this makes no host sync on the card."""
    def refuse(*_a, **_k):
        raise AssertionError("host read of a tensor on the decode path")

    for name in ("item", "tolist", "__int__", "__float__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_decode_step_per_row_t_matches_reference(setup, monkeypatch):
    """decode_step on a slot-indexed cache at a (B,) position vector, lane 1
    off (t = -1), against the reference; the step reads no tensor value back
    to the host."""
    cfg_j, cfg, params_j, params = setup
    rng = np.random.default_rng(3)
    slots, clen = 3, 20
    cache, fill = _random_slot_cache(cfg, slots, clen, rng)
    tvec = np.array([fill[0], -1, fill[2]], np.int64)
    tok = rng.integers(0, cfg.vocab, (slots, 1))
    lg_j, c_j = JT.decode_step(j_template("xla"), cfg_j, params_j, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(tvec, jnp.int32), _j(cache))
    tpl = default_template("cuda", device="cpu")
    tt, tokt = torch.from_numpy(tvec), torch.from_numpy(tok)
    lg, c = T.decode_step(tpl, cfg, params, tokt, tt, _t(cache))
    live = tvec >= 0
    np.testing.assert_allclose(lg.numpy()[live], np.asarray(lg_j)[live], atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    a, w = c["blocks"][0]["attn"], c_j["blocks"][0]["attn"]
    assert np.array_equal(a["pos"].numpy(), np.asarray(w["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(a[name].numpy(), np.asarray(w[name]), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
        assert np.array_equal(a[name][:, 1].numpy(), cache["blocks"][0]["attn"][name][:, 1])
    mine = _t(cache)
    with monkeypatch.context() as mp:
        _hostless(mp)
        lg2, c2 = T.decode_step(tpl, cfg, params, tokt, tt, mine, inplace=True)
    assert c2 is mine and torch.equal(lg2, lg)
    assert torch.equal(mine["blocks"][0]["attn"]["k"], a["k"])


def test_prefill_chunk_step_matches_reference(setup):
    """Two chunk steps over a slot-indexed cache (ragged, one lane off)
    against the reference's, then a decode step after them."""
    cfg_j, cfg, params_j, params = setup
    rng = np.random.default_rng(4)
    slots, clen, ck = 3, 24, 5
    cache = _np(JT.init_cache(cfg_j, slots, clen, per_slot=True))
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 0, 4)]
    jc, tc = _j(cache), _t(cache)
    tpl = default_template("cuda", device="cpu")
    done = [0, 0, 0]
    for _ in range(2):
        tok = np.zeros((slots, ck), np.int64)
        t0 = np.full((slots,), -1, np.int64)
        nv = np.zeros((slots,), np.int64)
        for b, p in enumerate(prompts):
            n = min(ck, len(p) - done[b])
            if n > 0:
                tok[b, :n] = p[done[b]:done[b] + n]
                t0[b], nv[b] = done[b], n
                done[b] += n
        lg_j, jc = JT.prefill_chunk_step(j_template("xla"), cfg_j, params_j,
                                         jnp.asarray(tok, jnp.int32), jnp.asarray(t0, jnp.int32),
                                         jnp.asarray(nv, jnp.int32), jc)
        lg, tc = T.prefill_chunk_step(tpl, cfg, params, torch.from_numpy(tok),
                                      torch.from_numpy(t0), torch.from_numpy(nv), tc)
        live = nv > 0
        np.testing.assert_allclose(lg.numpy()[live], np.asarray(lg_j)[live], atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
        a, w = tc["blocks"][0]["attn"], jc["blocks"][0]["attn"]
        assert np.array_equal(a["pos"].numpy(), np.asarray(w["pos"]))
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(w["k"]), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
    assert (tc["blocks"][0]["attn"]["pos"][:, 1] == -1).all()


# ---------------------------------------------------------------------------
# per-slot decode (q16), each layer on the reference's own input
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q16(setup):
    cfg_j, cfg, params_j, params = setup
    cal = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    tpl_j = j_template("q16")
    pol_j = JT.calibrate_policy(tpl_j, cfg_j, params_j, jnp.asarray(cal))
    tpl = default_template("q16", device="cpu")
    pol = T.calibrate_policy(tpl, cfg, params, torch.from_numpy(cal).long())
    return (tpl_j, pol_j, JT.quantize_params(tpl_j, cfg_j, params_j, pol_j), tpl, pol,
            T.quantize_params(tpl, cfg, params, pol))


@pytest.mark.parametrize("s,t,n_valid", [(1, [3, -1, 9], None), (4, [0, 6, -1], [4, 2, 0])])
def test_q16_per_slot_layer_on_the_reference_input(setup, q16, s, t, n_valid):
    cfg_j, cfg, _, _ = setup
    tpl_j, pol_j, qp_j, tpl, pol, qp = q16
    rng = np.random.default_rng(21)
    slots, clen = 3, 16
    cache, _ = _random_slot_cache(cfg, slots, clen, rng, np.int16)
    h = (0.5 * rng.standard_normal((slots, s, cfg.d_model))).astype(np.float32)
    plan_j, plan = JT.plan_pattern(cfg_j)[0], T.plan_pattern(cfg)[0]
    tv = np.asarray(t)
    nv_j = None if n_valid is None else jnp.asarray(np.asarray(n_valid, np.int32))
    nv = None if n_valid is None else torch.as_tensor(np.asarray(n_valid))
    h_j = jnp.asarray(h)
    for layer in range(cfg.n_layers):
        c_in = {"attn": {k: v[layer] for k, v in cache["blocks"][0]["attn"].items()}}
        out_j, c_j, _ = JT._run_layer(tpl_j, cfg_j, plan_j, _layer0_at(qp_j, layer), h_j,
                                      positions=jnp.asarray(tv, jnp.int32), mode="decode",
                                      cache=_j(c_in), t=jnp.asarray(tv, jnp.int32),
                                      policy=pol_j, n_valid=nv_j)
        out, c, _ = T._run_layer(tpl, cfg, plan, T._at(qp["blocks"][0], layer),
                              torch.from_numpy(np.array(h_j)), positions=None, mode="decode",
                              cache=_t(c_in), t=torch.from_numpy(tv), policy=pol, n_valid=nv)
        a, w = c["attn"], c_j["attn"]
        assert a["k"].dtype == torch.int16
        assert np.array_equal(a["pos"].numpy(), np.asarray(w["pos"])), layer
        assert np.array_equal(a["v"].numpy(), np.asarray(w["v"])), layer
        dk = a["k"].numpy().astype(np.int32) - np.asarray(w["k"], np.int32)
        assert np.abs(dk).max() <= 1, layer
        live = np.broadcast_to(tv, (slots,)) >= 0
        np.testing.assert_allclose(out.numpy()[live], np.asarray(out_j)[live], atol=Q16_TOL,
                                   rtol=0)
        h_j = out_j


def _layer0_at(tree_j, layer):
    return jax.tree_util.tree_map(lambda a: a[layer], tree_j["blocks"][0])
