"""The port's dense transformer and serving path held against the JAX package.

Reduced qwen2-0.5b (2 layers, d 64, GQA 4:2, head dim 16, f32).  Weights
come from the reference's ``init_params``, with numpy draws for the QKV
biases and the norm scales (so neither is zero), and cross over as numpy
arrays through ``repro_torch.convert``; tokens are numpy draws.  The port
runs on the CPU (``device="cpu"``: its kernel wrappers run their plain
versions), the reference on the CPU with its Pallas kernels in interpret
mode.

Tolerances:

* float logits within 1e-4 of the reference's ``xla`` backend (the
  reference's GEMM tolerance), for prefill and decode as well, and the
  port's own prefill + decode within 3e-4 of its forward (the reference's
  ``tests/test_models_smoke.py``);
* q16: calibrated formats and every weight raw bit-identical, every grid
  GEMM bit-exact against the reference kernel on the same raws; each layer
  run on the reference's own input writes v cache raws bit-identical and k
  raws within 1 LSB (k crosses the float RoPE island); logits within 2e-3
  of the reference's q16 logits with argmax agreement of at least 0.99.
  Across a whole prefill the first layer's v raws stay bit-identical, but
  deeper layers' raws may move by an LSB or two: the f32 islands (norms,
  softmax, silu) of the two frameworks differ by an ulp, and an ulp can
  flip the rounding of the next quantize;
* the island law: the engine's counters equal ``q16_island_counts``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.quantization import QFormat as JQFormat
from repro.core.quantization import QTensor as JQTensor
from repro.core.template import default_template as j_template
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.kernels import ops as jops
from repro.launch.serve import generate as j_generate
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.quantization import NumericsPolicy, QTensor
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import matmul_fp
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T

FLOAT_TOL = 1e-4
PARITY_TOL = 3e-4
Q16_LOGIT_TOL = 2e-3
Q16_ARGMAX = 0.99


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qtree_np(tree):
    """A reference tree with QTensor leaves -> numpy, quantized leaves as
    ``(raw, (int_bits, frac_bits, total_bits))``."""
    if isinstance(tree, JQTensor):
        f = tree.fmt
        return np.asarray(tree.raw), (f.int_bits, f.frac_bits, f.total_bits)
    if isinstance(tree, dict):
        return {k: _qtree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_qtree_np(v) for v in tree)
    return np.asarray(tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _tok(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.fixture(scope="module")
def setup():
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    tree = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.default_rng(1)
    for blk in tree["blocks"]:
        for name in ("wq", "wk", "wv"):
            b = blk["attn"][name]["b"]
            blk["attn"][name]["b"] = (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
        for name in ("norm", "ffn_norm"):
            s = blk[name]["scale"]
            blk[name]["scale"] = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params = transformer_params_from_numpy(tree)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    return cfg_j, cfg, params_j, params, tokens


@pytest.fixture(scope="module")
def float_ref(setup):
    """The reference's xla forward, prefill(S-1) and decode_step(S-1)."""
    cfg_j, _, params_j, _, tokens = setup
    tpl = j_template("xla")
    s = tokens.shape[1]
    full, _ = JT.forward(tpl, cfg_j, params_j, jnp.asarray(tokens), mode="fwd")
    pre, cache = JT.prefill(tpl, cfg_j, params_j, jnp.asarray(tokens[:, :s - 1]),
                            cache_len=s + 4)
    dec, _ = JT.decode_step(tpl, cfg_j, params_j, jnp.asarray(tokens[:, s - 1:]), s - 1,
                            cache)
    return np.asarray(full), np.asarray(pre), np.asarray(dec), _np_tree(cache)


# ---------------------------------------------------------------------------
# float
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_float_forward_prefill_decode_match_xla(setup, float_ref, backend):
    _, cfg, _, params, tokens = setup
    full_j, pre_j, dec_j, cache_j = float_ref
    tpl = default_template(backend, device="cpu")
    s = tokens.shape[1]
    full, aux = T.forward(tpl, cfg, params, _tok(tokens))
    assert full.shape == (*tokens.shape, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(full.numpy(), full_j, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    pre, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :s - 1]), cache_len=s + 4)
    np.testing.assert_allclose(pre.numpy(), pre_j, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["blocks"][0]["attn"][name].numpy(),
                                   cache_j["blocks"][0]["attn"][name], atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
    assert np.array_equal(cache["blocks"][0]["attn"]["pos"].numpy(),
                          cache_j["blocks"][0]["attn"]["pos"])
    dec, _ = T.decode_step(tpl, cfg, params, _tok(tokens[:, s - 1:]), s - 1, cache)
    np.testing.assert_allclose(dec.numpy(), dec_j, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_decode_parity_with_forward(setup, backend):
    """decode_step(t) after prefill equals forward at the same position, for
    four rolled steps (the reference's ``test_models_smoke.py`` checks)."""
    _, cfg, _, params, tokens = setup
    tpl = default_template(backend, device="cpu")
    s, k = tokens.shape[1], 4
    full, _ = T.forward(tpl, cfg, params, _tok(tokens))
    pre, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :s - k]), cache_len=s)
    np.testing.assert_allclose(pre.numpy(), full[:, s - k - 1].numpy(), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    for i in range(k):
        t = s - k + i
        lg, cache = T.decode_step(tpl, cfg, params, _tok(tokens[:, t:t + 1]), t, cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=PARITY_TOL,
                                   rtol=PARITY_TOL, err_msg=f"decode step {i}")


def test_last_pos_and_init_cache(setup):
    """``prefill(last_pos=...)`` reads the logits at the given positions, and
    ``init_cache`` builds the prefill cache's structure, empty."""
    _, cfg, _, params, tokens = setup
    tpl = default_template("torch", device="cpu")
    s = tokens.shape[1]
    full, _ = T.forward(tpl, cfg, params, _tok(tokens))
    lg, cache = T.prefill(tpl, cfg, params, _tok(tokens), cache_len=s + 4, last_pos=s - 3)
    np.testing.assert_allclose(lg.numpy(), full[:, s - 3].numpy(), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    lg, _ = T.prefill(tpl, cfg, params, _tok(tokens), last_pos=torch.tensor([s - 3, 4]))
    np.testing.assert_allclose(lg.numpy(), full[[0, 1], [s - 3, 4]].numpy(),
                               atol=PARITY_TOL, rtol=PARITY_TOL)
    empty = T.init_cache(cfg, 2, s + 4)
    for name, leaf in cache["blocks"][0]["attn"].items():
        got = empty["blocks"][0]["attn"][name]
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, name
    assert bool((empty["blocks"][0]["attn"]["pos"] == -1).all())
    q16_cache = T.init_cache(cfg, 2, s + 4, policy=NumericsPolicy("q16"))
    assert q16_cache["blocks"][0]["attn"]["k"].dtype == torch.int16


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chunked_route_matches_reference(setup, monkeypatch, backend):
    """With the chunked threshold and blocks shrunk in both packages, a
    16-token prompt takes the reference's ``_sdpa_chunked`` and the port's
    chunked route: the flash-attention kernel's (plain) route on cuda, one
    call per layer, and the plain online softmax on torch."""
    cfg_j, cfg, params_j, params, tokens = setup
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 8)
        monkeypatch.setattr(mod, "_BQ", 4)
        monkeypatch.setattr(mod, "_BK", 4)
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    s = tokens.shape[1]
    tpl_j = j_template("xla")
    full_j, _ = JT.forward(tpl_j, cfg_j, params_j, jnp.asarray(tokens), mode="fwd")
    pre_j, _ = JT.prefill(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, :s - 4]),
                          cache_len=s)
    tpl = default_template(backend, device="cpu")
    full, _ = T.forward(tpl, cfg, params, _tok(tokens))
    pre, _ = T.prefill(tpl, cfg, params, _tok(tokens[:, :s - 4]), cache_len=s)
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    np.testing.assert_allclose(pre.numpy(), np.asarray(pre_j), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    want = 2 * cfg.n_layers if backend == "cuda" else 0
    assert len(calls) == want
    assert all(kw["bq"] == 4 and kw["bk"] == 4 and kw["causal"] for kw in calls)


def test_tied_head_reads_embed_in_place(setup, monkeypatch):
    """The tied LM head hands the float GEMM embed's transposed view, which
    the kernel reads in place: no copy of the table per call."""
    _, cfg, _, params, tokens = setup
    seen = []
    real = kops.matmul_fp
    monkeypatch.setattr(kops, "matmul_fp",
                        lambda x, w, **kw: seen.append(w) or real(x, w, **kw))
    T.prefill(default_template("cuda", device="cpu"), cfg, params, _tok(tokens))
    head = seen[-1]
    assert head.shape == (cfg.d_model, cfg.vocab) and matmul_fp.transposed(head)
    assert head.data_ptr() == params["embed"].data_ptr()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _ref_stream(tpl, cfg_j, params_j, prompts, gen, policy=None):
    """The reference's greedy tokens and per-step logits, step by step."""
    s = prompts.shape[1]
    logits, cache = JT.prefill(tpl, cfg_j, params_j, jnp.asarray(prompts),
                               cache_len=s + gen, policy=policy)
    toks, steps = [], []
    for i in range(gen):
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < gen - 1:
            logits, cache = JT.decode_step(tpl, cfg_j, params_j, tok, s + i, cache,
                                           policy=policy)
    return np.concatenate(toks, 1), np.stack(steps, 1)


def _assert_stream_follows(got, want, logits, tol):
    """Tokens agree at every step until the reference's top-2 margin first
    falls to ``tol`` or below (the streams may part at a near-tie)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]  # (B, gen)
    for row in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margin[row, i] <= tol:
                break
            assert got[row, i] == want[row, i], (row, i)


def test_generate_matches_reference_generate(setup):
    cfg_j, cfg, params_j, params, _ = setup
    prompts = np.asarray(j_synthetic_batch(0, 0, 2, 8, cfg.vocab))
    gen = 6
    tpl_j = j_template("xla")
    want = np.asarray(j_generate(cfg_j, params_j, jnp.asarray(prompts), gen=gen, tpl=tpl_j))
    stream, logits = _ref_stream(tpl_j, cfg_j, params_j, prompts, gen)
    assert np.array_equal(stream, want)
    for backend in ("cuda", "torch"):
        got = serve.generate(cfg, params, _tok(prompts), gen=gen,
                             tpl=default_template(backend, device="cpu"))
        assert got.shape == (2, gen)
        _assert_stream_follows(got.numpy(), want, logits, FLOAT_TOL)


def test_synthetic_batch_keeps_the_recurrence():
    toks = synthetic_batch(3, 1, 4, 50, 1000)
    assert toks.shape == (4, 50) and toks.min() >= 0 and toks.max() < 1000
    noise = (toks[:, 1:] - 31 * toks[:, :-1] - 7) % 1000
    assert int(noise.max()) < 1000 // 64
    assert torch.equal(toks, synthetic_batch(3, 1, 4, 50, 1000))


def test_serve_main_runs_on_cpu_and_refuses_what_is_not_ported(tmp_path):
    for backend in ("cuda", "q16", "q8", "torch"):
        out = serve.main(["--device", "cpu", "--backend", backend, "--prompts", "2",
                          "--prompt-len", "8", "--gen", "3"])
        assert out.shape == (2, 3)
    # the replica router and the plan store are ported (ROADMAP queue 1 items 2, 4)
    store = tmp_path / "plans.json"
    out = serve.main(["--device", "cpu", "--scheduler", "--replicas", "2", "--plan-store",
                      str(store), "--prompts", "3", "--prompt-len", "8", "--gen", "3"])
    assert len(out) == 3 and all(len(row) == 3 for row in out) and store.exists()
    # tensor-parallel decode (ROADMAP queue 1 item 5) serves through the
    # scheduler: --shards without it is refused
    with pytest.raises(SystemExit, match="--shards N serves through --scheduler"):
        serve.main(["--device", "cpu", "--shards", "2"])


def test_unported_paths_raise(setup):
    _, cfg, _, params, tokens = setup
    for change in ({"family": "moe"}, {"abs_pos": True}):
        with pytest.raises(NotImplementedError, match="item 6"):
            T.plan_pattern(dataclasses.replace(cfg, **change))
    tpl = default_template("cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        T.prefill(tpl, cfg, params, _tok(tokens), ctx=torch.zeros(2, 4, cfg.d_model))
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(NotImplementedError, match="item 6"):
        tattn._sdpa_chunked(tpl, q, q, q, causal=True, window=4, q_offset=0)
    with pytest.raises(NotImplementedError, match="item 6"):
        tattn._sdpa_chunked(tpl, q, q, q, causal=False, window=0, q_offset=0)


# ---------------------------------------------------------------------------
# grid-resident q16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q16(setup):
    cfg_j, cfg, params_j, params, tokens = setup
    cal = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    tpl_j = j_template("q16")
    pol_j = JT.calibrate_policy(tpl_j, cfg_j, params_j, jnp.asarray(cal))
    qp_j = JT.quantize_params(tpl_j, cfg_j, params_j, pol_j)
    tpl = default_template("q16", device="cpu")
    pol = T.calibrate_policy(tpl, cfg, params, _tok(cal))
    qp = T.quantize_params(tpl, cfg, params, pol)
    return tpl_j, pol_j, qp_j, tpl, pol, qp


def test_q16_formats_and_weight_raws_bit_identical(q16):
    _, pol_j, qp_j, _, pol, qp = q16
    assert (pol.fmt.int_bits, pol.fmt.frac_bits) == (pol_j.fmt.int_bits, pol_j.fmt.frac_bits)
    mine = dict(_leaves(qp))
    n = 0
    for path, leaf in _leaves(qp_j):
        if not isinstance(leaf, JQTensor):
            continue
        got = mine[path]
        assert isinstance(got, QTensor), path
        assert (got.fmt.int_bits, got.fmt.frac_bits, got.fmt.total_bits) == (
            leaf.fmt.int_bits, leaf.fmt.frac_bits, leaf.fmt.total_bits), path
        assert np.array_equal(got.raw.numpy(), np.asarray(leaf.raw)), path
        n += 1
    # stacked over the layers: q/k/v/o weights, q/k/v biases, 3 FFN, the head
    assert n == 4 + 3 + 3 + 1
    # the reference's tree carries across as the same QTensors
    carried = transformer_params_from_numpy(_qtree_np(qp_j))
    assert torch.equal(carried["lm_head"]["w"].raw, qp["lm_head"]["w"].raw)


def test_q16_grid_gemms_bit_exact_on_the_same_raws(setup, q16, monkeypatch):
    """Every grid GEMM of a q16 prefill, rerun through the reference's
    fixed-point kernel (interpret mode) on the same raws and epilogue."""
    _, cfg, _, _, tokens = setup
    _, _, _, tpl, pol, qp = q16
    calls = []
    real = kops.matmul_q16

    def record(xq, wq, **kw):
        out = real(xq, wq, **kw)
        calls.append((xq, wq, kw, out))
        return out

    monkeypatch.setattr(kops, "matmul_q16", record)
    T.prefill(tpl, cfg, qp, _tok(tokens), policy=pol)
    assert len(calls) == 7 * cfg.n_layers + 1
    for xq, wq, kw, out in calls:
        f = kw["fmt"]
        want = jops.matmul_q16(
            jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()),
            bias=None if kw["bias"] is None else jnp.asarray(kw["bias"].numpy()),
            relu=kw["relu"], fmt=JQFormat(f.int_bits, f.frac_bits, f.total_bits),
            shift=kw["shift"], bias_shift=kw["bias_shift"], wide=kw["wide"],
            interpret=True)
        assert np.array_equal(out.numpy(), np.asarray(want))


def test_q16_prefill_cache_and_logits_track_reference(setup, q16):
    cfg_j, cfg, _, _, tokens = setup
    tpl_j, pol_j, qp_j, tpl, pol, qp = q16
    s = tokens.shape[1]
    lg_j, cache_j = JT.prefill(tpl_j, cfg_j, qp_j, jnp.asarray(tokens), cache_len=s + 4,
                               policy=pol_j)
    lg, cache = T.prefill(tpl, cfg, qp, _tok(tokens), cache_len=s + 4, policy=pol)
    cj, c = cache_j["blocks"][0]["attn"], cache["blocks"][0]["attn"]
    assert c["k"].dtype == torch.int16 and c["v"].dtype == torch.int16
    # the first layer's input is the embedding through one norm: no island
    # of an earlier layer lies between the two packages
    assert np.array_equal(c["v"][0].numpy(), np.asarray(cj["v"][0]))
    assert np.abs(c["k"][0].numpy().astype(np.int32)
                  - np.asarray(cj["k"][0], np.int32)).max() <= 1
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=Q16_LOGIT_TOL, rtol=0)
    full_j, _ = JT.forward(tpl_j, cfg_j, qp_j, jnp.asarray(tokens), mode="fwd", policy=pol_j)
    full, _ = T.forward(tpl, cfg, qp, _tok(tokens), policy=pol)
    full_j = np.asarray(full_j)
    assert np.abs(full.numpy() - full_j).max() <= Q16_LOGIT_TOL
    agree = (full.numpy().argmax(-1) == full_j.argmax(-1)).mean()
    assert agree >= Q16_ARGMAX


def test_q16_each_layer_on_the_reference_input(setup, q16):
    """Each layer of a q16 prefill, fed the reference's own residual
    stream: v cache raws bit-identical, k raws within 1 LSB, and the layer's
    output within the q16 logit tolerance."""
    cfg_j, cfg, _, _, tokens = setup
    tpl_j, pol_j, qp_j, tpl, pol, qp = q16
    s = tokens.shape[1]
    plan_j, plan = JT.plan_pattern(cfg_j)[0], T.plan_pattern(cfg)[0]
    h_j = JT._embed_tokens(cfg_j, qp_j, jnp.asarray(tokens))
    for layer in range(cfg.n_layers):
        p_j = jax.tree_util.tree_map(lambda a: a[layer], qp_j["blocks"][0])
        out_j, c_j, _ = JT._run_layer(tpl_j, cfg_j, plan_j, p_j, h_j,
                                      positions=jnp.arange(s), mode="prefill",
                                      cache_len=s, policy=pol_j)
        out, c = T._run_layer(tpl, cfg, plan, T._at(qp["blocks"][0], layer),
                              torch.from_numpy(np.array(h_j)), positions=torch.arange(s),
                              mode="prefill", cache_len=s, policy=pol)
        assert np.array_equal(c["attn"]["v"].numpy(), np.asarray(c_j["attn"]["v"])), layer
        dk = c["attn"]["k"].numpy().astype(np.int32) - np.asarray(c_j["attn"]["k"], np.int32)
        assert np.abs(dk).max() <= 1, layer
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=Q16_LOGIT_TOL, rtol=0)
        h_j = out_j


def _reset_islands(eng):
    eng.counters["quantize_calls"] = 0
    eng.counters["dequantize_calls"] = 0


def test_q16_island_law(setup, q16):
    """Prefill and decode tick exactly the designated islands: per layer the
    reference's per-body counts (``test_q16_residency.py``), plus the head."""
    cfg_j, cfg, _, _, tokens = setup
    _, _, _, tpl, pol, qp = q16
    eng = tpl.engine
    _reset_islands(eng)
    _, cache = T.prefill(tpl, cfg, qp, _tok(tokens[:, :8]), cache_len=16, policy=pol)
    law = T.q16_island_counts(cfg, mode="prefill")
    assert (eng.counters["quantize_calls"], eng.counters["dequantize_calls"]) == (
        law["quantize"], law["dequantize"])
    _reset_islands(eng)
    logits, _ = T.decode_step(tpl, cfg, qp, _tok(tokens[:, 8:9]), 8, cache, policy=pol)
    law = T.q16_island_counts(cfg, mode="decode")
    assert (eng.counters["quantize_calls"], eng.counters["dequantize_calls"]) == (
        law["quantize"], law["dequantize"])
    assert logits.dtype == torch.float32
    # the reference counts one traced body for the stack; the port every layer
    for mode in ("prefill", "decode", "fwd"):
        ref, mine = JT.q16_island_counts(cfg_j, mode=mode), T.q16_island_counts(cfg, mode=mode)
        for key in ("quantize", "dequantize"):
            assert mine[key] - 1 == cfg.n_layers * (ref[key] - 1)
    sw = T.q16_island_counts(cfg, mode="decode")
    ge = T.q16_island_counts(dataclasses.replace(cfg, act="gelu"), mode="decode")
    assert sw["dequantize"] == ge["dequantize"] + cfg.n_layers


def test_q16_generate_follows_reference_and_quantizes_once(setup, q16):
    cfg_j, cfg, params_j, params, _ = setup
    tpl_j, pol_j, _, tpl, pol, _ = q16
    prompts = np.asarray(j_synthetic_batch(0, 0, 2, 8, cfg.vocab))
    gen = 4
    want = np.asarray(j_generate(cfg_j, params_j, jnp.asarray(prompts), gen=gen, tpl=tpl_j,
                                 policy=pol_j))
    qp_j = JT.quantize_params(tpl_j, cfg_j, params_j, pol_j)
    stream, logits = _ref_stream(tpl_j, cfg_j, qp_j, prompts, gen, policy=pol_j)
    assert np.array_equal(stream, want)
    eng = tpl.engine
    builds = eng.counters["qparam_builds"]
    got = serve.generate(cfg, params, _tok(prompts), gen=gen, tpl=tpl, policy=pol)
    again = serve.generate(cfg, params, _tok(prompts), gen=gen, tpl=tpl, policy=pol)
    assert eng.counters["qparam_builds"] == builds, "generate() re-quantized"
    assert torch.equal(got, again)
    _assert_stream_follows(got.numpy(), want, logits, Q16_LOGIT_TOL)
