"""The other model families' captured decode step on the card.

Reduced mamba2-1.3b, recurrentgemma-9b and granite-moe-3b-a800m in bf16
(random weights from a seed, live rmsnorm scales): eight decode steps, each
one replay of the step's CUDA graph, held against the eager step on the
same state and inputs: the same logits and the same cache bit for bit, the
recurrent states moving every step (a graph that captured freshly
allocated states would replay against the captured buffers and never move
them past the first step).  And the float GEMM at granite-moe's expert
shapes, (128, 1536) @ (1536, 512) on route "wgmma" and (2, 1536) @ (1536,
512) on "splitk", against its plain version (bf16: 2e-2) and repeatable.
Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.kernels import _build
from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain, plan_for
from repro_torch.launch.scheduler import CAPTURE_COUNTS, compiled_steps
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu

STEPS = 8
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda", 0)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _states(tree):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in ([v] if k in ("h", "state") else _states(v))]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _states(v)]
    return []


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
def test_replayed_decode_equals_eager_and_states_advance(dev, name):
    cfg = dataclasses.replace(reduced(get_config(name)), dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg)
    for blk in (*params["blocks"], *params["tail"]):
        for key in ("norm", "ffn_norm"):
            if key in blk:
                blk[key]["scale"].copy_(0.1 * torch.randn(blk[key]["scale"].shape,
                                                          generator=gen, device=dev))
    tpl = default_template("cuda")
    b, s = 2, 24
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (b, STEPS), generator=gen, device=dev)
    clen = s + STEPS
    fns = compiled_steps(tpl, cfg, clen)
    _, cache = T.prefill(tpl, cfg, params, prompts, cache_len=clen)
    c_e, c_g = _clone(cache), _clone(cache)
    caps0 = sum(CAPTURE_COUNTS.values())
    for i in range(STEPS):
        before = [x.clone() for x in _states(c_e)]
        lg_e, c_e = T.decode_step(tpl, cfg, params, toks[:, i:i + 1], s + i, c_e)
        _, lg_g, c_g = fns.decode_next(params, toks[:, i:i + 1], s + i, c_g)
        torch.cuda.synchronize()
        assert torch.equal(lg_e, lg_g), f"step {i}: logits"
        assert _equal(c_e, c_g), f"step {i}: cache"
        assert all(not torch.equal(x, y) for x, y in zip(before, _states(c_g))), i
    assert sum(CAPTURE_COUNTS.values()) - caps0 == 1  # one capture, then replays
    if cfg.family != "moe":
        assert _states(c_g)
    fns.decode_next.release(None)


@pytest.mark.parametrize("m,route", [(128, "wgmma"), (2, "splitk")], ids=["prefill", "decode"])
def test_matmul_fp_at_granite_expert_shapes(dev, m, route):
    k, n = 1536, 512
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    blk = plan_for(x, w)
    assert blk.route == route
    got = matmul_fp_cuda(x, w, block=blk)
    again = matmul_fp_cuda(x, w, block=blk)
    want = matmul_fp_plain(x, w)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.equal(got, again)
