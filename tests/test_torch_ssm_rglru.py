"""The port's sequence mixers held against the JAX package's: the Mamba2 SSD
(chunked scan and recurrence) and the RG-LRU (doubling scan and loop).

Inputs are numpy draws from a seed; block weights come from the reference's
``init_ssm`` / ``init_rglru`` (reduced mamba2-1.3b and recurrentgemma-9b)
and cross over as numpy arrays.  The port runs on the CPU.

Tolerances (the reference's ``tests/test_ssm_rglru.py``): ``ssd_chunked``
within 1e-4 / 1e-3 (atol / rtol) of ``ssd_reference`` and of the
reference's ``ssd_chunked``; ``_lru_scan`` within 1e-5 / 1e-4 of
``rglru_reference``; a block's decode step within 1e-3 of its forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import all_configs as j_all_configs
from repro.configs import reduced as j_reduced
from repro.core.template import default_template as j_template
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import all_configs, reduced
from repro_torch.core.template import default_template
from repro_torch.models import rglru, ssm

SSD_TOL = dict(atol=1e-4, rtol=1e-3)
LRU_TOL = dict(atol=1e-5, rtol=1e-4)
DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
CFG = reduced(all_configs()["mamba2-1.3b"])
CFG_J = j_reduced(j_all_configs()["mamba2-1.3b"])
RCFG = reduced(all_configs()["recurrentgemma-9b"])
RCFG_J = j_reduced(j_all_configs()["recurrentgemma-9b"])


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, s, h, n))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, s, h, n))).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _tree(init, cfg_j, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), cfg_j))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("s", [16, 24, 32])
def test_ssd_chunked_matches_recurrence_and_reference(chunk, s):
    """The chunk size does not change the result (s % chunk != 0 too); the
    output and the final state equal the recurrence's and the reference's."""
    args = _ssd_inputs(chunk * 100 + s, 2, s, 4, 8, 16)
    got, st_c = ssm.ssd_chunked(*_t(*args), chunk, return_state=True)
    want, st_r = ssm.ssd_reference(*_t(*args))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SSD_TOL)
    np.testing.assert_allclose(st_c.numpy(), st_r.numpy(), **SSD_TOL)
    ref, st_j = jssm.ssd_chunked(*map(jnp.asarray, args), chunk, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SSD_TOL)
    np.testing.assert_allclose(st_c.numpy(), np.asarray(st_j), **SSD_TOL)
    want_j, _ = jssm.ssd_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(want.numpy(), np.asarray(want_j), **SSD_TOL)


def test_ssd_carried_state_continuation():
    """ssd(x1 ++ x2) == ssd(x2 | final_state(x1)): the prefill's carry."""
    x, dt, A, B, C = _t(*_ssd_inputs(0, 1, 24, 2, 8, 8))
    full = ssm.ssd_chunked(x, dt, A, B, C, 8)
    cut = 16
    _, state1 = ssm.ssd_chunked(x[:, :cut], dt[:, :cut], A, B[:, :cut], C[:, :cut], 8,
                                return_state=True)
    part2 = ssm.ssd_chunked(x[:, cut:], dt[:, cut:], A, B[:, cut:], C[:, cut:], 8,
                            init_state=state1)
    np.testing.assert_allclose(part2.numpy(), full[:, cut:].numpy(), **SSD_TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ssm_block_matches_reference_and_decode_parity(backend):
    """The block's forward and its prefill cache equal the reference's; one
    decode step after the prefill equals the forward's last position."""
    pj, p = _tree(jssm.init_ssm, CFG_J)
    u = (np.random.default_rng(1).standard_normal((2, 17, CFG.d_model))).astype(np.float32)
    tpl = default_template(backend, device="cpu")
    y_full = ssm.ssm_block(tpl, CFG, p, torch.from_numpy(u))
    want = jssm.ssm_block(j_template("xla"), CFG_J, pj, jnp.asarray(u))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    _, cache = ssm.ssm_block(tpl, CFG, p, torch.from_numpy(u[:, :-1]), return_cache=True)
    _, cache_j = jssm.ssm_block(j_template("xla"), CFG_J, pj, jnp.asarray(u[:, :-1]),
                                return_cache=True)
    for name in ("state", "conv"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_j[name]),
                                   atol=1e-4, rtol=1e-4)
    y_dec, new = ssm.ssm_decode_step(tpl, CFG, p, torch.from_numpy(u[:, -1:]), cache)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, -1].numpy(), **DECODE_TOL)
    assert new["state"] is not cache["state"]  # not in place: the cache stays


@given(st.integers(min_value=1, max_value=1000))
@settings(max_examples=25, deadline=None)
def test_rglru_scan_matches_loop(seed):
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.standard_normal((2, 12, 8)))).astype(np.float32)
    gx = rng.standard_normal((2, 12, 8)).astype(np.float32)
    got = rglru._lru_scan(*_t(log_a, gx))
    want = rglru.rglru_reference(*_t(log_a, gx))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LRU_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrglru._lru_scan(log_a, gx)),
                               **LRU_TOL)


@pytest.mark.parametrize("s", [1, 10, 37, 64])
def test_rglru_scan_with_initial_state(s):
    """The carried state folds into the first step, at any length (the
    doubling scan's ragged last step included)."""
    rng = np.random.default_rng(3 + s)
    log_a = -np.log1p(np.exp(rng.standard_normal((1, s, 4)))).astype(np.float32)
    gx = rng.standard_normal((1, s, 4)).astype(np.float32)
    h0 = rng.standard_normal((1, 4)).astype(np.float32)
    got = rglru._lru_scan(*_t(log_a, gx, h0))
    want = rglru.rglru_reference(*_t(log_a, gx, h0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LRU_TOL)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jrglru.rglru_reference(*map(jnp.asarray, (log_a, gx, h0)))),
        **LRU_TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_rglru_block_matches_reference_and_decode_parity(backend):
    pj, p = _tree(jrglru.init_rglru, RCFG_J)
    u = np.random.default_rng(1).standard_normal((2, 13, RCFG.d_model)).astype(np.float32)
    tpl = default_template(backend, device="cpu")
    y_full = rglru.rglru_block(tpl, RCFG, p, torch.from_numpy(u))
    want = jrglru.rglru_block(j_template("xla"), RCFG_J, pj, jnp.asarray(u))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    _, cache = rglru.rglru_block(tpl, RCFG, p, torch.from_numpy(u[:, :-1]),
                                 return_cache=True)
    y_dec, _ = rglru.rglru_decode_step(tpl, RCFG, p, torch.from_numpy(u[:, -1:]), cache)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, -1].numpy(), **DECODE_TOL)


@pytest.mark.parametrize("mixer", ["rec", "ssm"])
def test_decode_inplace_writes_the_cache_it_was_given(mixer):
    """``inplace`` decode writes the new state and conv history into the
    cache's own tensors (a captured step must advance them on every
    replay) and gives the same numbers as the out-of-place step."""
    init, cfg, cfg_j, block, step = (
        (jrglru.init_rglru, RCFG, RCFG_J, rglru.rglru_block, rglru.rglru_decode_step)
        if mixer == "rec" else
        (jssm.init_ssm, CFG, CFG_J, ssm.ssm_block, ssm.ssm_decode_step))
    _, p = _tree(init, cfg_j)
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    tpl = default_template("cuda", device="cpu")
    _, cache = block(tpl, cfg, p, u[:, :-1], return_cache=True)
    want, new = step(tpl, cfg, p, u[:, -1:], cache)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got, same = step(tpl, cfg, p, u[:, -1:], cache, inplace=True)
    assert same is cache and {k: v.data_ptr() for k, v in same.items()} == ptrs
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(cache[k], new[k]), k


def test_rglru_state_stays_bounded():
    """The sqrt(1-a^2) normalization keeps |h| O(|x|) over long sequences."""
    _, p = _tree(jrglru.init_rglru, RCFG_J)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 256, RCFG.d_model)).astype(np.float32))
    _, cache = rglru.rglru_block(default_template("cuda", device="cpu"), RCFG, p, u,
                                 return_cache=True)
    assert float(cache["h"].abs().max()) < 50.0
