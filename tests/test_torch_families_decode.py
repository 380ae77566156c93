"""The port's other model families over decode steps, held against the JAX
package: prefill + decode parity with the forward, the recurrent states
advancing (in place too), the sliding-window ring wrapping, and the chunked
attention routes forced by shrinking the threshold.  Setup and tolerances:
``tests/torch_family_cases.py`` and ``test_torch_families.py``'s docstring.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.template import default_template as j_template
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch.core.template import default_template
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T
from torch_family_cases import (
    DECODE_TOL,
    FLOAT_TOL,
    NEW,
    PREFILL_TOL,
    S,
    _j,
    _make,
    _t,
    _tok,
    setup_of,
)


@pytest.mark.parametrize("name", NEW)
def test_prefill_decode_parity_with_forward(name):
    """The port's prefill at S-k-1 and k rolled decode steps equal its own
    forward at the same positions (the VLM: its decode gap equals the
    reference's, see the module docstring)."""
    cfg_j, cfg, params_j, params, tokens, ctx = setup_of(name)
    tpl = default_template("cuda", device="cpu")
    k = 4
    full, _ = T.forward(tpl, cfg, params, _tok(tokens), ctx=_t(ctx))
    pre, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :S - k]), ctx=_t(ctx),
                           cache_len=S)
    np.testing.assert_allclose(pre.numpy(), full[:, S - k - 1].numpy(), atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    gaps = []
    for i in range(k):
        t = S - k + i
        lg, cache = T.decode_step(tpl, cfg, params, _tok(tokens[:, t:t + 1]), t, cache)
        gaps.append(lg.numpy() - full[:, t].numpy())
    if cfg.family != "vlm":
        for i, gap in enumerate(gaps):
            t = S - k + i
            np.testing.assert_allclose(full[:, t].numpy() + gap, full[:, t].numpy(),
                                       atol=DECODE_TOL, rtol=DECODE_TOL,
                                       err_msg=f"decode step {i}")
        return
    tpl_j = j_template("xla")
    full_j, _ = JT.forward(tpl_j, cfg_j, params_j, jnp.asarray(tokens), ctx=_j(ctx),
                           mode="fwd")
    _, cache_j = JT.prefill(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, :S - k]),
                            ctx=_j(ctx), cache_len=S)
    for i in range(k):
        t = S - k + i
        lg_j, cache_j = JT.decode_step(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, t:t + 1]),
                                       t, cache_j)
        gap_j = np.asarray(lg_j) - np.asarray(full_j[:, t])
        assert np.abs(gap_j).max() > DECODE_TOL  # the reference misses its own bound
        np.testing.assert_allclose(gaps[i], gap_j, atol=FLOAT_TOL, rtol=FLOAT_TOL)


def test_recurrent_state_advances_over_decode_steps():
    """mamba2 and recurrentgemma: eight decode steps against the forward at
    5e-4, the in-place step (the captured step's) equal to the out-of-place
    one bit for bit, its state moving every step."""
    for name in ("mamba2-1.3b", "recurrentgemma-9b"):
        _, cfg, _, params, tokens, _ = setup_of(name)
        tpl = default_template("cuda", device="cpu")
        full, _ = T.forward(tpl, cfg, params, _tok(tokens))
        k = 8
        _, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :S - k]), cache_len=S)
        _, twin = T.prefill(tpl, cfg, params, _tok(tokens[:, :S - k]), cache_len=S)
        mixer = "ssm" if cfg.family == "ssm" else "rec"
        state = "state" if mixer == "ssm" else "h"
        for i in range(k):
            t = S - k + i
            before = cache["blocks"][0][mixer][state].clone()
            lg, cache = T.decode_step(tpl, cfg, params, _tok(tokens[:, t:t + 1]), t, cache)
            lg2, same = T.decode_step(tpl, cfg, params, _tok(tokens[:, t:t + 1]), t, twin,
                                      inplace=True)
            assert same is twin and torch.equal(lg, lg2)
            assert not torch.equal(before, cache["blocks"][0][mixer][state])
            assert torch.equal(twin["blocks"][0][mixer][state],
                               cache["blocks"][0][mixer][state])
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=DECODE_TOL,
                                       rtol=DECODE_TOL, err_msg=f"{name} step {i}")


def test_sliding_window_ring_buffer_wraps():
    """recurrentgemma with an 8-token window: the local layer's ring holds
    the window only, decode past it wraps and still equals the windowed
    forward (and the reference's decode)."""
    cfg_j, cfg, params_j, params, tokens, _ = _make("recurrentgemma-9b", window=8)
    s = 24
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (1, s)).astype(np.int32)
    tpl = default_template("cuda", device="cpu")
    full, _ = T.forward(tpl, cfg, params, _tok(tokens))
    _, cache = T.prefill(tpl, cfg, params, _tok(tokens[:, :s - 4]), cache_len=s)
    local = cache["blocks"][2]["attn"]
    assert local["k"].shape[-2] == 8 and local["pos"].shape[-1] == 8
    for i in range(4):
        t = s - 4 + i
        lg, cache = T.decode_step(tpl, cfg, params, _tok(tokens[:, t:t + 1]), t, cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
    pos = cache["blocks"][2]["attn"]["pos"][0].tolist()
    assert sorted(pos) == list(range(s - 8, s))  # the last 8 positions, wrapped
    tpl_j = j_template("xla")
    _, cache_j = JT.prefill(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, :s - 1]),
                            cache_len=s)
    lg_j, _ = JT.decode_step(tpl_j, cfg_j, params_j, jnp.asarray(tokens[:, s - 1:]), s - 1,
                             cache_j)
    _, mine = T.prefill(tpl, cfg, params, _tok(tokens[:, :s - 1]), cache_len=s)
    lg, _ = T.decode_step(tpl, cfg, params, _tok(tokens[:, s - 1:]), s - 1, mine)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["recurrentgemma-9b", "whisper-medium",
                                  "granite-moe-3b-a800m"])
def test_chunked_routes_match_reference(name, backend, monkeypatch):
    """With the chunked threshold and blocks shrunk in both packages, every
    attention takes the chunked route: recurrentgemma's windowed layers
    (window 6 over blocks of 4, so whole blocks fall left of the window) the
    plain online softmax on both backends; on cuda whisper's encoder (8
    frames) the flash kernel non-causal, and each decoder layer flash causal
    then, on its cross layer over the 8 frames, non-causal; granite flash
    causal.  Logits equal the reference's."""
    kw = {"window": 6} if name == "recurrentgemma-9b" else {}
    cfg_j, cfg, params_j, params, tokens, ctx = _make(name, **kw)
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 8)
        monkeypatch.setattr(mod, "_BQ", 4)
        monkeypatch.setattr(mod, "_BK", 4)
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    tpl_j = j_template("xla")
    full_j, _ = JT.forward(tpl_j, cfg_j, params_j, jnp.asarray(tokens), ctx=_j(ctx),
                           mode="fwd")
    tpl = default_template(backend, device="cpu")
    full, _ = T.forward(tpl, cfg, params, _tok(tokens), ctx=_t(ctx))
    np.testing.assert_allclose(full.numpy(), np.asarray(full_j), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    causal = [c["causal"] for c in calls]
    if backend == "torch" or cfg.family == "hybrid":
        assert causal == []
    elif cfg.family == "encdec":
        assert causal == [False] * cfg.n_encoder_layers + [True, False] * cfg.n_layers
    else:
        assert causal == [True] * cfg.n_layers
