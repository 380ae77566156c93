"""The port's other model families' ``generate`` streams held against the
JAX package's, on both backends, for the nine reduced configs beside
qwen2-0.5b.  Setup and tolerances: ``tests/torch_family_cases.py`` and
``test_torch_families.py``'s docstring.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.template import default_template as j_template
from repro.launch.serve import generate as j_generate
from repro_torch.core.template import default_template
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from torch_family_cases import B, FLOAT_TOL, NEW, _j, _t, _tok, setup_of


def _assert_stream_follows(got, want, logits, tol):
    """Tokens agree at every step until the reference's top-2 margin first
    falls to ``tol`` or below (the streams may part at a near-tie)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for row in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margin[row, i] <= tol:
                break
            assert got[row, i] == want[row, i], (row, i)


@pytest.mark.parametrize("name", NEW)
def test_generate_matches_reference_generate(name):
    cfg_j, cfg, params_j, params, tokens, ctx = setup_of(name)
    gen = 5
    prompts = tokens[:, :8]
    tpl_j = j_template("xla")
    want = np.asarray(j_generate(cfg_j, params_j, jnp.asarray(prompts), _j(ctx), gen=gen,
                                 tpl=tpl_j))
    # the margins come from the port's plain steps teacher-forced on the
    # reference's stream (within 1e-4 of the reference's, test_torch_families)
    tpl = default_template("torch", device="cpu")
    logits, cache = T.prefill(tpl, cfg, params, _tok(prompts), ctx=_t(ctx), cache_len=8 + gen)
    steps = [logits.numpy()]
    for i in range(gen - 1):
        logits, cache = T.decode_step(tpl, cfg, params, _tok(want[:, i:i + 1]), 8 + i, cache)
        steps.append(logits.numpy())
    for backend in ("cuda", "torch"):
        got = serve.generate(cfg, params, _tok(prompts), _t(ctx), gen=gen,
                             tpl=default_template(backend, device="cpu"))
        assert got.shape == (B, gen)
        _assert_stream_follows(got.numpy(), want, np.stack(steps, 1), FLOAT_TOL)
