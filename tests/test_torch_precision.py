"""The port's precision DSE held to the JAX package's.

``dse.choose_precision``, ``models/cnn.py:calibrate_cnn_precision`` and
``models/transformer.py:calibrate_precision`` pick each layer's (or layer
group's) activation grid from its solo-flip argmax drift onto the int8
rung, revert int8 layers until the composed network meets the budget, and
pin every choice in the plan registry, from which a warm call rebuilds the
policy with no forward and no search.  These are the cases of
``tests/test_mixed_precision.py`` on the port, against the reference on the
same numpy inputs and on weights carried across by ``repro_torch.convert``.
Both run on the CPU (the reference's Pallas kernels in interpret mode, the
port's wrappers on their plain versions).

* Plans are compared by ``(int_bits, frac_bits, total_bits)``: the two
  packages' ``QFormat`` classes differ.
* Given the reference's ``ref=`` (its argmax predictions), only the grid
  forwards decide, and these are exact: the drifts and the plans equal the
  reference's.  With each package's default ``ref`` (the per-op q16 forward
  of the float weights, whose float islands can differ by an ulp) the
  drifts stay within 1/N of the reference's, N the number of argmax rows.
* ``qmatmul_ref``, ``qmatmul_real`` and ``requantize_i32_to_i16`` equal the
  reference's bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import dse as jdse
from repro.core import quantization as jq
from repro.core.engine import reset_plan_caches as j_reset
from repro.core.template import default_template as j_template
from repro.core.tiling import TPU_V5E
from repro.models import cnn as jcnn
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cnn_params_from_numpy, transformer_params_from_numpy
from repro_torch.core import dse, quantization as tq
from repro_torch.core.engine import plan_cache_for, reset_plan_caches
from repro_torch.core.quantization import NumericsPolicy, Q2_6, Q2_14, int8_rung
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100
from repro_torch.launch import serve
from repro_torch.models import cnn as tcnn
from repro_torch.models import transformer as T


def _f(fmt) -> tuple:
    return fmt.int_bits, fmt.frac_bits, fmt.total_bits


def _plan(policy) -> tuple:
    return policy.name, _f(policy.fmt), tuple((n, _f(f)) for n, f in policy.layer_fmts)


def _jpolicy(policy):
    """The reference's copy of a calibrated base policy (the calibration
    itself is held to the reference in ``test_torch_cnn.py`` and
    ``test_torch_transformer.py``)."""
    return jq.NumericsPolicy(policy.name, fmt=jq.QFormat(*_f(policy.fmt)))


def _drifts(reg, net, names, spec) -> dict:
    return {n: reg.precision_for(net, n, spec).drift for n in names}


@pytest.fixture
def fresh():
    j_reset()
    reset_plan_caches()
    yield
    j_reset()
    reset_plan_caches()


# ---------------------------------------------------------------------------
# choose_precision and the single-format GEMM oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [0.0, 0.42, 0.5, 0.99, 0.991, 1.0])
def test_choose_precision_matches_reference(budget):
    drift = {"a": 1.0, "b": 0.991, "c": 0.42}
    got = dse.choose_precision(drift, budget, Q2_14, Q2_6)
    want = jdse.choose_precision(drift, budget, jq.Q2_14, jq.Q2_6)
    assert {k: _f(v) for k, v in got.items()} == {k: _f(v) for k, v in want.items()}
    if budget == 0.99:
        assert got == {"a": Q2_6, "b": Q2_6, "c": Q2_14}


@pytest.mark.parametrize("bad", [-0.1, 1.5])
def test_choose_precision_rejects_a_budget_outside_0_1(bad):
    for fn, base, low in ((dse.choose_precision, Q2_14, Q2_6),
                          (jdse.choose_precision, jq.Q2_14, jq.Q2_6)):
        with pytest.raises(ValueError, match="budget"):
            fn({"a": 1.0}, bad, base, low)


@pytest.mark.parametrize("fmt", ["Q2_14", "Q2_6"])
def test_qmatmul_oracles_match_reference(fmt):
    jf, tf = getattr(jq, fmt), getattr(tq, fmt)
    rng = np.random.default_rng(5)
    lo, hi = tf.raw_min, tf.raw_max + 1
    xr = rng.integers(lo, hi, (7, 300)).astype(np.int16)
    wr = rng.integers(lo, hi, (300, 9)).astype(np.int16)
    got = tq.qmatmul_ref(torch.from_numpy(xr), torch.from_numpy(wr), tf)
    want = jq.qmatmul_ref(jnp.asarray(xr), jnp.asarray(wr), jf)
    assert got.dtype == tf.storage_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = rng.integers(-2**31, 2**31, (64,), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        tq.requantize_i32_to_i16(torch.from_numpy(acc), tf).numpy(),
        np.asarray(jq.requantize_i32_to_i16(jnp.asarray(acc), jf)))
    x = (rng.standard_normal((5, 40)) * 0.7).astype(np.float32)
    w = (rng.standard_normal((40, 6)) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        tq.qmatmul_real(torch.from_numpy(x), torch.from_numpy(w), tf).numpy(),
        np.asarray(jq.qmatmul_real(jnp.asarray(x), jnp.asarray(w), jf)))


# ---------------------------------------------------------------------------
# LeNet: calibrate_cnn_precision
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lenet():
    """The reference's LeNet (scale 0.4) and a (4, 32, 32, 1) image batch in
    both packages, with each package's calibrated base policy (equal) and
    the reference's default ``ref`` (its per-op q16 forward)."""
    j_reset()
    jtpl = j_template("q16")
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcnn.LENET, scale=0.4)
    img = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (4, 32, 32, 1)) * 2 - 1)
    jref = np.array(jnp.argmax(jcnn.cnn_forward(jtpl, jcnn.LENET, jparams,
                                                  jnp.asarray(img)), -1))
    ttpl = default_template("q16", device="cpu")
    tparams = cnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    x = torch.from_numpy(img.copy())
    tpol = tcnn.calibrate_cnn_policy(ttpl, tcnn.LENET, tparams, x)
    jpol = _jpolicy(tpol)
    j_reset()
    return dict(jtpl=jtpl, jparams=jparams, img=jnp.asarray(img), jpol=jpol, jref=jref,
                ttpl=ttpl, tparams=tparams, x=x, tpol=tpol)


def _lenet_both(s, **kw):
    """calibrate_cnn_precision cold in both packages; returns (port policy,
    reference policy, port drifts, reference drifts)."""
    names = tcnn.cnn_layer_names(tcnn.LENET)
    jkw = dict(kw)
    tkw = dict(kw)
    if "ref" in kw:
        jkw["ref"] = jnp.asarray(kw["ref"])
    want = jcnn.calibrate_cnn_precision(s["jtpl"], jcnn.LENET, s["jparams"], s["img"],
                                        policy=s["jpol"], **jkw)
    got = tcnn.calibrate_cnn_precision(s["ttpl"], tcnn.LENET, s["tparams"], s["x"],
                                       policy=s["tpol"], **tkw)
    return (got, want, _drifts(s["ttpl"].engine.plan_cache, "lenet", names, H100),
            _drifts(s["jtpl"].engine.plan_cache, "lenet", names, TPU_V5E))


@pytest.mark.parametrize("budget", [0.99, 0.5])
def test_lenet_drifts_and_plan_equal_given_reference_ref(lenet, fresh, budget):
    got, want, tdrift, jdrift = _lenet_both(lenet, budget=budget, ref=lenet["jref"])
    assert tdrift == jdrift
    assert _plan(got) == _plan(want)
    assert got.name == "mixed" and len(got.layer_fmts) == 5
    if budget == 0.99:  # conv0 / conv1 / fc1 meet it on this seed, fc0 / fc2 do not
        assert sum(f.total_bits == 8 for _, f in got.layer_fmts) == 3


def test_lenet_plan_identical_given_drift(lenet, fresh):
    drift = {"conv0": 1.0, "conv1": 0.75, "fc0": 1.0, "fc1": 0.5, "fc2": 1.0}
    got, want, tdrift, jdrift = _lenet_both(lenet, budget=0.99, drift=drift)
    assert tdrift == jdrift == drift
    assert _plan(got) == _plan(want)
    assert [n for n, _ in got.layer_fmts] == list(tcnn.cnn_layer_names(tcnn.LENET))


def test_lenet_default_ref_drifts_within_one_row(lenet, fresh):
    got, want, tdrift, jdrift = _lenet_both(lenet, budget=0.99)
    n_rows = lenet["x"].shape[0]
    assert all(abs(tdrift[k] - jdrift[k]) <= 1 / n_rows for k in jdrift), (tdrift, jdrift)


def test_composed_budget_reverts_int8_layers(lenet, fresh):
    """Per-layer drift that claims every layer passes, against a reference
    the composed network never matches: every int8 choice reverts, in both
    packages, and the pins record the reverted plan."""
    names = tcnn.cnn_layer_names(tcnn.LENET)
    wrong = (lenet["jref"] + 1) % 10
    got, want, _, _ = _lenet_both(lenet, budget=0.99, drift={n: 1.0 for n in names},
                                  ref=wrong)
    assert _plan(got) == _plan(want)
    assert all(f == lenet["tpol"].fmt for _, f in got.layer_fmts)
    reg = lenet["ttpl"].engine.plan_cache
    assert reg.precision_plan("lenet", H100) == {n: lenet["tpol"].fmt for n in names}


def test_cnn_warm_pins_rebuild_identical_policy_zero_forwards(lenet, fresh, monkeypatch):
    """A cold sweep pins every layer (one miss each); a second calibration
    replays the pins: the identical policy, hits only, no forward."""
    tpl, spec = lenet["ttpl"], tcnn.LENET
    reg = tpl.engine.plan_cache
    names = tcnn.cnn_layer_names(spec)
    cold = tcnn.calibrate_cnn_precision(tpl, spec, lenet["tparams"], lenet["x"], budget=0.0,
                                        policy=lenet["tpol"], drift={n: 1.0 for n in names})
    assert all(f == int8_rung(lenet["tpol"].fmt) for _, f in cold.layer_fmts)
    assert reg.misses >= len(names)
    assert reg.stats()["precision"] == reg.stats()["measured"] == len(names)

    def boom(*a, **kw):  # pragma: no cover - only fires on a regression
        raise AssertionError("warm precision replay ran a forward")

    monkeypatch.setattr("repro_torch.models.cnn.cnn_forward", boom)
    misses0, hits0 = reg.misses, reg.hits
    warm = tcnn.calibrate_cnn_precision(tpl, spec, lenet["tparams"], lenet["x"], budget=0.0,
                                        policy=lenet["tpol"])
    assert warm == cold
    assert reg.misses == misses0 and reg.hits == hits0 + len(names)


def test_lenet_int8_layers_cost_exactly_half_bytes(lenet, fresh):
    """An all-int8 plan quantizes every weight onto int8 raws (half the
    int16 plan's bytes); its activations are int8 end to end."""
    tpl, spec = lenet["ttpl"], tcnn.LENET
    names = tcnn.cnn_layer_names(spec)
    low = int8_rung(lenet["tpol"].fmt)
    all8 = dataclasses.replace(lenet["tpol"], name="mixed",
                               layer_fmts=tuple((n, low) for n in names))

    def raw_bytes(qp):
        return [q.raw.numel() * q.raw.element_size()
                for g in ("convs", "fcs") for layer in qp[g] for q in (layer["w"],)]

    b16 = raw_bytes(tcnn.quantize_cnn_params(tpl, spec, lenet["tparams"], lenet["tpol"]))
    b8 = raw_bytes(tcnn.quantize_cnn_params(tpl, spec, lenet["tparams"], all8))
    assert [2 * b for b in b8] == b16
    h8, h16 = (tpl.quant(lenet["x"], p.fmt_for(names[0])) for p in (all8, lenet["tpol"]))
    assert h8.raw.dtype == torch.int8
    assert 2 * h8.raw.numel() * h8.raw.element_size() == \
        h16.raw.numel() * h16.raw.element_size()
    tpl.engine.drop_qparams(lenet["tparams"], all8)


# ---------------------------------------------------------------------------
# reduced qwen2-0.5b: calibrate_precision and the int8 KV cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen2-0.5b from the reference's ``init_params`` (seed 0) in both
    packages, a (2, 16) calibration batch, each package's calibrated base
    policy (equal) and the reference's default ``ref``."""
    j_reset()
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    assert T.precision_group_names(cfg) == JT.precision_group_names(cfg_j) == ("g0", "head")
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(9), (2, 16), 0, cfg.vocab))
    jtpl = j_template("q16")
    jref = np.array(jnp.argmax(JT.forward(jtpl, cfg_j, jparams, jnp.asarray(tokens),
                                            mode="fwd")[0], -1))
    tparams = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ttpl = default_template("q16", device="cpu")
    toks = torch.from_numpy(tokens).long()
    tpol = T.calibrate_policy(ttpl, cfg, tparams, toks)
    jpol = _jpolicy(tpol)
    j_reset()
    return dict(cfg_j=cfg_j, cfg=cfg, jparams=jparams, jtokens=jnp.asarray(tokens),
                jtpl=jtpl, jpol=jpol, jref=jref, tparams=tparams, ttpl=ttpl, toks=toks,
                tpol=tpol)


def _qwen_both(s, **kw):
    names = T.precision_group_names(s["cfg"])
    jkw = dict(kw)
    if "ref" in kw:
        jkw["ref"] = jnp.asarray(kw["ref"])
    want = JT.calibrate_precision(s["jtpl"], s["cfg_j"], s["jparams"], s["jtokens"],
                                  policy=s["jpol"], **jkw)
    got = T.calibrate_precision(s["ttpl"], s["cfg"], s["tparams"], s["toks"],
                                policy=s["tpol"], **kw)
    return (got, want, _drifts(s["ttpl"].engine.plan_cache, s["cfg"].name, names, H100),
            _drifts(s["jtpl"].engine.plan_cache, s["cfg_j"].name, names, TPU_V5E))


@pytest.mark.parametrize("budget", [0.99, 0.25, 0.0])
def test_qwen2_drifts_and_plan_equal_given_reference_ref(qwen, fresh, budget):
    got, want, tdrift, jdrift = _qwen_both(qwen, budget=budget, ref=qwen["jref"])
    assert tdrift == jdrift
    assert _plan(got) == _plan(want)
    n8 = sum(f.total_bits == 8 for _, f in got.layer_fmts)
    if budget == 0.0:  # every group, and so every layer's KV cache, on int8
        assert n8 == len(got.layer_fmts) == 2


def test_qwen2_default_ref_drifts_within_one_row(qwen, fresh):
    _, _, tdrift, jdrift = _qwen_both(qwen, budget=0.99)
    n_rows = qwen["toks"].numel()
    assert all(abs(tdrift[k] - jdrift[k]) <= 1 / n_rows for k in jdrift), (tdrift, jdrift)


def test_transformer_warm_pins_zero_forwards(qwen, fresh, monkeypatch):
    cfg = qwen["cfg"]
    base = NumericsPolicy("q16", fmt=Q2_14)
    reg = plan_cache_for(H100)
    names = T.precision_group_names(cfg)
    for n in names:
        reg.pin_precision(cfg.name, n, Q2_6 if n == "g0" else Q2_14, drift=1.0,
                          searched=False)

    def boom(*a, **kw):  # pragma: no cover - only fires on a regression
        raise AssertionError("warm precision replay ran a forward")

    monkeypatch.setattr(T, "forward", boom)
    misses0, hits0 = reg.misses, reg.hits
    warm = T.calibrate_precision(qwen["ttpl"], cfg, params=None, tokens=None, policy=base)
    assert warm.name == "mixed"
    assert dict(warm.layer_fmts) == {"g0": Q2_6, "head": Q2_14}
    assert reg.misses == misses0 == 0 and reg.hits == hits0 + len(names)


def test_int8_groups_cost_exactly_half_bytes(qwen, fresh):
    """A group on the int8 rung stores int8 weights and int8 k / v raws, in
    ``init_cache`` and in the prefill's cache: exactly half the bytes of the
    same group on the int16 grid; the reference's caches have the same
    dtypes."""
    cfg, tpl = qwen["cfg"], qwen["ttpl"]
    low = int8_rung(qwen["tpol"].fmt)
    mixed = dataclasses.replace(qwen["tpol"], name="mixed", layer_fmts=(("g0", low),))
    all8 = dataclasses.replace(qwen["tpol"], name="mixed",
                               layer_fmts=(("g0", low), ("head", low)))

    def kv_bytes(cache):
        return sum(c["attn"][k].numel() * c["attn"][k].element_size()
                   for c in cache["blocks"] for k in ("k", "v"))

    def w_bytes(qp, group):
        tree = qp["blocks"][0] if group == "g0" else qp["lm_head"]
        leaves = [tree["w"]] if group == "head" else [
            leaf["w"] for sub in ("attn", "ffn") for leaf in tree[sub].values()]
        return sum(q.raw.numel() * q.raw.element_size() for q in leaves)

    q16_cache = T.init_cache(cfg, 2, 24, policy=qwen["tpol"])
    for pol in (mixed, all8):
        cache = T.init_cache(cfg, 2, 24, policy=pol)
        assert cache["blocks"][0]["attn"]["k"].dtype == torch.int8
        assert 2 * kv_bytes(cache) == kv_bytes(q16_cache)
        qp = T.quantize_params(tpl, cfg, qwen["tparams"], pol)
        _, pcache = T.prefill(tpl, cfg, qp, qwen["toks"][:, :8], cache_len=24, policy=pol)
        assert 2 * kv_bytes(pcache) == kv_bytes(q16_cache)
        qp16 = T.quantize_params(tpl, cfg, qwen["tparams"], qwen["tpol"])
        for group in ("g0", "head"):
            scale = 2 if pol.fmt_for(group).total_bits == 8 else 1
            assert scale * w_bytes(qp, group) == w_bytes(qp16, group)
        tpl.engine.drop_qparams(qwen["tparams"], pol)
    jlow = jq.int8_rung(qwen["jpol"].fmt)
    jmixed = dataclasses.replace(qwen["jpol"], name="mixed", layer_fmts=(("g0", jlow),))
    jcache = JT.init_cache(qwen["cfg_j"], 2, 24, policy=jmixed)
    tcache = T.init_cache(cfg, 2, 24, policy=mixed)
    assert str(jcache["blocks"][0]["attn"]["k"].dtype) == "int8"
    assert tcache["blocks"][0]["attn"]["v"].dtype == torch.int8


# ---------------------------------------------------------------------------
# serve --backend q8 on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", [False, True], ids=["generate", "scheduler"])
def test_serve_q8_pins_measured_and_replays_warm(fresh, scheduler):
    """``serve.main --backend q8`` calibrates, sweeps and pins every group
    with ``source="measured"``; a second run in the same process replays the
    pins: no DSE search at all."""
    argv = ["--device", "cpu", "--backend", "q8", "--prompts", "2", "--prompt-len", "8",
            "--gen", "3", "--precision-budget", "0.5"]
    if scheduler:
        argv += ["--scheduler", "--prefill-chunk", "8"]
    out = serve.main(argv)
    assert len(out) == 2 and all(len(row) == 3 for row in out)
    reg = plan_cache_for(H100)
    cfg = reduced(get_config("qwen2-0.5b"))
    names = T.precision_group_names(cfg)
    st = reg.stats()
    assert st["precision"] == st["measured"] == len(names)
    assert set(reg.precision_plan(cfg.name, H100)) == set(names)
    misses0, hits0 = reg.misses, reg.hits
    again = serve.main(argv)
    assert reg.misses == misses0, "a warm q8 serve must search nothing"
    assert reg.hits > hits0
    assert [list(r) for r in again] == [list(r) for r in out]


@pytest.mark.parametrize("scheduler", [False, True], ids=["generate", "scheduler"])
def test_serve_q8_calibration_error_raises(fresh, monkeypatch, scheduler):
    """No fallback: a precision DSE that fails stops ``serve --backend q8``
    (the reference degrades to per-op q16 without ``--scheduler``)."""
    def fail(*a, **kw):
        raise ValueError("the grid cannot serve this model")

    monkeypatch.setattr(T, "calibrate_precision", fail)
    argv = ["--device", "cpu", "--backend", "q8", "--prompts", "1", "--prompt-len", "8",
            "--gen", "2"] + (["--scheduler"] if scheduler else [])
    with pytest.raises(ValueError, match="cannot serve"):
        serve.main(argv)
