"""The port's other model families held against the JAX package: the
configs, and forward, prefill and decode (more decode cases:
``test_torch_families_decode.py``; serving: ``test_torch_families_generate.py``
and ``test_torch_families_serving.py``; the shared setup:
``tests/torch_family_cases.py``).

The nine configs beside qwen2-0.5b, reduced (d 64, head dim 16, f32):
granite-moe and phi3.5-moe (MoE), mamba2 (SSD), recurrentgemma (RG-LRU +
windowed attention), whisper (encoder-decoder), llama-3.2-vision (gated
cross-attention) and the dense qwen2.5-32b, internlm2-1.8b and
mistral-nemo-12b.  Weights come from the reference's ``init_params``, with
numpy draws for every norm scale (rmsnorm scales are zero at init) and the
VLM's ``cross_gate`` (zero at init, which would hide the whole cross path),
and cross over as numpy arrays through ``repro_torch.convert``; tokens and
contexts are numpy draws.  The port runs on the CPU (its kernel wrappers run
their plain versions).

Tolerances: logits and the MoE aux within 1e-4 of the reference's ``xla``
backend (forward, prefill, decode); the port's prefill within 3e-4 and its
decode steps within 5e-4 of its own forward (the reference's
``tests/test_models_smoke.py``).  The VLM is the exception there, and the
reference's: its forward and prefill rotate a cross layer's queries by
RoPE, its decode step does not (``decode_attention(cross=True)``), so with
a live gate its decode departs from its forward; the port reproduces that
gap within 1e-4 of the reference's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.configs import reduced as j_reduced
from repro.configs import shape_applicable as j_shape_applicable
from repro.core.template import default_template as j_template
from repro.models import transformer as JT
from repro_torch.configs import SHAPES, all_configs, reduced, shape_applicable
from repro_torch.core.template import default_template
from repro_torch.models import transformer as T
from torch_family_cases import (
    B,
    FLOAT_TOL,
    NEW,
    S,
    _j,
    _np_tree,
    _t,
    _tok,
    setup_of,
)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(j_all_configs()))
def test_config_params_and_shapes_equal_the_reference(name):
    cfg, cfg_j = all_configs()[name], j_all_configs()[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert (cfg.n_params(), cfg.n_params_active(), cfg.ssm_nheads, cfg.attends_full) == (
        cfg_j.n_params(), cfg_j.n_params_active(), cfg_j.ssm_nheads, cfg_j.attends_full)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(j_reduced(cfg_j))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert {k: v.tokens for k, v in SHAPES.items()} == {k: v.tokens for k, v in J_SHAPES.items()}
    for key in SHAPES:
        assert shape_applicable(cfg, SHAPES[key]) == j_shape_applicable(cfg_j, J_SHAPES[key])


def test_every_reference_config_is_registered():
    assert sorted(all_configs()) == sorted(j_all_configs())


# ---------------------------------------------------------------------------
# forward / prefill / decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_forward_prefill_decode_match_xla(name):
    """Logits (both backends) and the MoE aux within 1e-4 of the reference's
    xla backend; the prefill cache's leaves too."""
    cfg_j, cfg, params_j, params, tokens, ctx = setup_of(name)
    tpl_j = j_template("xla")
    full_j, aux_j = JT.forward(tpl_j, cfg_j, params_j, jnp.asarray(tokens), ctx=_j(ctx),
                               mode="fwd")
    pre_j, cache_j = JT.prefill(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, :S - 1]),
                                ctx=_j(ctx), cache_len=S + 4)
    dec_j, _ = JT.decode_step(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, S - 1:]), S - 1,
                              cache_j)
    cache_j = _np_tree(cache_j)
    for backend in ("torch", "cuda"):
        tpl = default_template(backend, device="cpu")
        full, aux = T.forward(tpl, cfg, params, _tok(tokens), ctx=_t(ctx))
        assert full.shape == (B, S, cfg.vocab)
        np.testing.assert_allclose(full.numpy(), np.asarray(full_j), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
        assert abs(float(aux) - float(aux_j)) <= FLOAT_TOL
        if cfg.family == "moe":
            assert float(aux) > 0
        pre, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :S - 1]), ctx=_t(ctx),
                               cache_len=S + 4)
        np.testing.assert_allclose(pre.numpy(), np.asarray(pre_j), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
        got = jax.tree_util.tree_leaves_with_path(cache_j)
        mine = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(lambda x: x.numpy(), cache)))
        assert len(got) == len(mine)
        for path, want in got:
            np.testing.assert_allclose(mine[path], want, atol=FLOAT_TOL, rtol=FLOAT_TOL,
                                       err_msg=jax.tree_util.keystr(path))
        dec, _ = T.decode_step(tpl, cfg, params, _tok(tokens[:, S - 1:]), S - 1, cache)
        np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=FLOAT_TOL,
                                   rtol=FLOAT_TOL)
