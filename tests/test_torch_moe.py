"""The port's MoE FFN held against the JAX package's.

Reduced granite-moe (d 64, 4 experts, top-2, per-expert d_ff 32, f32) and
reduced phi3.5-moe.  Expert and router weights come from the reference's
``init_moe`` and cross over as numpy arrays; inputs are numpy draws.  The
port runs on the CPU (its kernel wrappers run their plain versions).

Tolerances: ``moe_ffn`` within 1e-4 of the reference's and of the dense
oracle (the reference's ``tests/test_moe.py``); the aux loss within 1e-5;
routing (top-k indices, queue positions) exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import all_configs as j_all_configs
from repro.configs import reduced as j_reduced
from repro.core.template import default_template as j_template
from repro.models import moe as jmoe
from repro_torch.configs import all_configs, reduced
from repro_torch.core.template import default_template
from repro_torch.kernels import ops as kops
from repro_torch.models import moe

TOL = 1e-4
AUX_TOL = 1e-5
NAMES = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


def _cfgs(name, **kw):
    cfg_j = dataclasses.replace(j_reduced(j_all_configs()[name]), **kw)
    cfg = dataclasses.replace(reduced(all_configs()[name]), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


def _params(cfg_j, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("cf", [1.25, 100.0])
@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_matches_reference_and_dense_oracle(name, cf, backend):
    """The grouped dispatch equals the reference's (drops included) and,
    with no drops, the dense oracle of both packages."""
    cfg_j, cfg = _cfgs(name, capacity_factor=cf, moe_group=16)
    pj, p = _params(cfg_j)
    x = _x((2, 24, cfg.d_model))
    want, aux_j = jmoe.moe_ffn(j_template("xla"), cfg_j, pj, jnp.asarray(x))
    got, aux = moe.moe_ffn(default_template(backend, device="cpu"), cfg, p,
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert abs(float(aux) - float(aux_j)) <= AUX_TOL
    oracle = moe.moe_ffn_dense_ref(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jmoe.moe_ffn_dense_ref(cfg_j, pj, jnp.asarray(x))),
        atol=TOL, rtol=TOL)
    if cf > 10:
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=TOL, rtol=TOL)


def test_expert_gemms_go_through_the_template_per_group_and_expert(monkeypatch):
    """On the cuda backend each expert projection is one float GEMM per
    (group, expert), G·E·3 a call, at (cap, d) @ (d, ff) and (cap, ff) @
    (ff, d); on torch none (one einsum a projection)."""
    cfg_j, cfg = _cfgs(NAMES[0], moe_group=16)
    _, p = _params(cfg_j)
    x = torch.from_numpy(_x((2, 24, cfg.d_model)))
    shapes = []
    real = kops.matmul_fp
    monkeypatch.setattr(kops, "matmul_fp",
                        lambda a, w, **kw: shapes.append((tuple(a.shape), tuple(w.shape)))
                        or real(a, w, **kw))
    moe.moe_ffn(default_template("torch", device="cpu"), cfg, p, x)
    assert shapes == []
    moe.moe_ffn(default_template("cuda", device="cpu"), cfg, p, x)
    g, e, cap = 3, cfg.n_experts, 10  # 48 tokens in groups of 16; ceil(16·2/4)·1.25
    d, ff = cfg.d_model, cfg.d_ff
    assert len(shapes) == g * e * 3
    assert set(shapes) == {((cap, d), (d, ff)), ((cap, ff), (ff, d))}


@pytest.mark.parametrize("name", NAMES)
def test_grouping_invariance_without_drops(name):
    """With no capacity drops the group size does not change the math."""
    _, cfg0 = _cfgs(name)
    cfg_j0, _ = _cfgs(name)
    _, p = _params(cfg_j0)
    x = torch.from_numpy(_x((2, 32, cfg0.d_model)))
    tpl = default_template("cuda", device="cpu")
    outs = [moe.moe_ffn(tpl, dataclasses.replace(cfg0, capacity_factor=100.0,
                                                 moe_group=group), p, x)[0]
            for group in (8, 16, 64)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(outs[0].numpy(), outs[2].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_capacity_drops_reduce_output_norm(name):
    """A tiny capacity drops tokens (the output shrinks toward zero), never
    NaN; the reference drops the same choices."""
    cfg_j, cfg = _cfgs(name)
    pj, p = _params(cfg_j)
    x = _x((2, 32, cfg.d_model))
    tpl = default_template("cuda", device="cpu")
    hi, _ = moe.moe_ffn(tpl, dataclasses.replace(cfg, capacity_factor=100.0), p,
                        torch.from_numpy(x))
    lo, _ = moe.moe_ffn(tpl, dataclasses.replace(cfg, capacity_factor=0.1), p,
                        torch.from_numpy(x))
    assert bool(torch.isfinite(lo).all())
    assert float(torch.linalg.norm(lo)) < float(torch.linalg.norm(hi))
    lo_j, _ = jmoe.moe_ffn(j_template("xla"), dataclasses.replace(cfg_j, capacity_factor=0.1),
                           pj, jnp.asarray(x))
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_j), atol=TOL, rtol=TOL)


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=20, deadline=None)
def test_router_topk_invariants(seed):
    """Gates normalized over k, indices distinct per token, probs a
    distribution; indices equal to the reference's top-k."""
    cfg_j, cfg = _cfgs(NAMES[0])
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(np.float32)
    gates, idx, probs = moe._route(cfg, torch.from_numpy(w), torch.from_numpy(xt))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    for t in range(idx.shape[1]):
        assert len(set(idx[0, t].tolist())) == cfg.top_k
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    gates_j, idx_j, _ = jmoe._route(cfg_j, jnp.asarray(w), jnp.asarray(xt))
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_j), atol=1e-6)


def test_aux_loss_balanced_vs_collapsed():
    """The aux loss is ~1 for balanced routing and ~E when collapsed."""
    cfg_j, cfg = _cfgs(NAMES[0], top_k=1)
    _, p = _params(cfg_j)
    collapsed = dict(p)
    w = torch.zeros_like(p["router"]["w"])
    w[:, 0] = 1.0
    collapsed["router"] = {"w": w}
    x = torch.from_numpy(np.abs(_x((2, 32, cfg.d_model), scale=1.0)) + 0.1)
    tpl = default_template("cuda", device="cpu")
    _, aux_rand = moe.moe_ffn(tpl, cfg, p, x)
    _, aux_coll = moe.moe_ffn(tpl, cfg, collapsed, x)
    assert float(aux_coll) > float(aux_rand)
    assert float(aux_coll) == pytest.approx(cfg.n_experts, rel=0.05)


def test_expert_counts_and_sharding_overrides_as_the_reference():
    """phi's 16 experts divide the 16-way model axis; granite's 40 do not,
    so it trains with capacity-dim expert parallelism and serves with the
    expert FFN dim sharded (the configs' overrides, carried over)."""
    phi = all_configs()["phi3.5-moe-42b-a6.6b"]
    assert phi.n_experts % 16 == 0
    granite = all_configs()["granite-moe-3b-a800m"]
    assert dict(granite.rule_overrides) == {"experts": None, "expert_cap": "model"}
    assert dict(granite.serve_rule_overrides).get("expert_mlp") == "model"
