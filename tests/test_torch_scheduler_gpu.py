"""The serve scheduler's captured decode step on the card: a reduced
qwen2-0.5b (random weights from a seed, f32) whose decode step replays one
CUDA graph, held against the eager step on the same state and inputs: the
same logits and the same cache, bit for bit, in float and grid-resident
q16; the launch counts a replay adds equal to an eager step's; no capture
after the first call; ``generate`` and the scheduler on the graph giving
the eager loop's tokens; the sampler's threefry bits equal to the CPU's.
Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest -m gpu``.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (
    CAPTURE_COUNTS,
    Request,
    SchedulerConfig,
    ServeScheduler,
    VirtualClock,
    compiled_steps,
    fold_in,
    prng_key,
    random_bits,
    replay_trace,
    sample_tokens,
)
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model(dev):
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tq = default_template("q16")
    cal = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    pol = T.calibrate_policy(tq, cfg, params, cal)
    return cfg, params, {"float": (default_template("cuda"), None),
                         "q16": (tq, pol)}


def _tree_eq(a, b):
    if isinstance(a, dict):
        return all(_tree_eq(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_tree_eq(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("numerics", ["float", "q16"])
def test_decode_graph_equals_eager(model, dev, numerics):
    cfg, params, runs = model
    tpl, pol = runs[numerics]
    tree = params if pol is None else T.quantize_params(tpl, cfg, params, pol)
    slots, clen = 4, 40
    fns = compiled_steps(tpl, cfg, clen, pol)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (slots, 16), generator=gen, device=dev)
    lens = torch.tensor([16, 5, 11, 9], device=dev)
    _, rows = fns.prefill(tree, toks, None, lens - 1)
    cache = T.insert_cache_rows(T.init_cache(cfg, slots, clen, per_slot=True, policy=pol,
                                             device=dev),
                                rows, src_rows=torch.arange(slots), sel=torch.ones(
                                    slots, dtype=torch.bool), valid_lens=lens)
    tvec = lens.clone()
    tvec[1] = -1
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen, device=dev)
    eng = tpl.engine
    caps = sum(CAPTURE_COUNTS.values())
    _build.reset_launches()
    c0 = collections.Counter(eng.counters)
    lg_e, c_e = T.decode_step(tpl, cfg, tree, tok, tvec, cache, policy=pol)
    eager_launches, eager_counts = dict(_build.launches), eng.counters - c0
    _, lg_g, c_g = fns.decode_next(tree, tok, tvec, _clone(cache))  # captures
    torch.cuda.synchronize()
    assert sum(CAPTURE_COUNTS.values()) == caps + 1
    assert torch.equal(lg_e, lg_g) and _tree_eq(c_e, c_g)
    # a replay counts what an eager step launches (the capture itself ran
    # a warm-up step, counted, and launched nothing)
    _build.reset_launches()
    c0 = collections.Counter(eng.counters)
    _, lg_2, c_2 = fns.decode_next(tree, tok, tvec, _clone(cache))
    torch.cuda.synchronize()
    assert dict(_build.launches) == eager_launches
    assert eng.counters - c0 == eager_counts
    assert torch.equal(lg_2, lg_e) and _tree_eq(c_2, c_e)
    assert sum(CAPTURE_COUNTS.values()) == caps + 1
    # the gated lane's row is untouched, bit for bit
    for name in ("k", "v", "pos"):
        assert torch.equal(c_2["blocks"][0]["attn"][name][:, 1],
                           cache["blocks"][0]["attn"][name][:, 1])


@pytest.mark.parametrize("numerics", ["float", "q16"])
def test_generate_on_the_graph_matches_the_eager_loop(model, dev, numerics):
    cfg, params, runs = model
    tpl, pol = runs[numerics]
    tree = params if pol is None else T.quantize_params(tpl, cfg, params, pol)
    prompts = torch.randint(0, cfg.vocab, (3, 9), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    got = serve.generate(cfg, params, prompts, gen=6, tpl=tpl, policy=pol)
    logits, cache = T.prefill(tpl, cfg, tree, prompts, cache_len=15, policy=pol)
    tok = logits.argmax(-1)
    want = [tok]
    for i in range(5):
        logits, cache = T.decode_step(tpl, cfg, tree, tok[:, None], 9 + i, cache, policy=pol)
        tok = logits.argmax(-1)
        want.append(tok)
    assert torch.equal(got, torch.stack(want, 1))
    caps = dict(CAPTURE_COUNTS)
    assert torch.equal(serve.generate(cfg, params, prompts, gen=6, tpl=tpl, policy=pol), got)
    assert dict(CAPTURE_COUNTS) == caps


def test_scheduler_on_the_card_matches_unbatched(model, dev):
    cfg, params, runs = model
    tpl, _ = runs["float"]
    sched = ServeScheduler(cfg, params, tpl=tpl, clock=VirtualClock(),
                           sched=SchedulerConfig(ladder=(8, 16, 24), slots=3, max_new_limit=6,
                                                 prefill_chunk=8))
    sched.warmup()
    misses, caps = sched.registry.misses, dict(CAPTURE_COUNTS)
    rng = np.random.default_rng(7)
    trace = [Request(prompt=tuple(int(t) for t in rng.integers(0, cfg.vocab, n)), max_new=6,
                     arrival=float(i % 2)) for i, n in enumerate([5, 9, 3, 17, 8, 24, 2])]
    replay_trace(sched, trace, tick=1.0)
    assert sched.counters["completed"] == len(trace) and sched.counters["chunk_steps"] > 0
    assert sched.registry.misses == misses and dict(CAPTURE_COUNTS) == caps
    for r in trace:
        want = serve.generate(cfg, params, torch.tensor([r.prompt], device=dev), gen=6,
                              tpl=tpl)
        assert r.generated == want[0].tolist(), r.rid


def test_sampler_bits_and_draws_match_the_cpu(dev):
    seeds, lanes, pos = torch.tensor([0, 17, 5, 2 ** 32 - 1]), torch.tensor([0, 3, 7, 1]), \
        torch.tensor([1, 9, 4096, 0])
    key_c = fold_in(fold_in(prng_key(seeds), lanes), pos)
    key_g = fold_in(fold_in(prng_key(seeds.to(dev), dev), lanes.to(dev)), pos.to(dev))
    assert torch.equal(random_bits(key_c, 1000), random_bits(key_g, 1000).cpu())
    logits = torch.randn(8, 500, generator=torch.Generator().manual_seed(3)) * 3
    got = sample_tokens(logits.to(dev), 17, torch.arange(8, device=dev),
                        torch.full((8,), 33, device=dev), 0.8, 20)
    want = sample_tokens(logits, 17, torch.arange(8), torch.full((8,), 33), 0.8, 20)
    assert torch.equal(got.cpu(), want)
