"""The port's continuous-batching scheduler, on the CPU.

Two kinds of tests, on a reduced qwen2-0.5b (reference weights carried
across with ``repro_torch.convert``; prompts are numpy draws from fixed
seeds; the reference's fixtures: ladder (8, 16, 24), 6 new tokens at most,
a ``VirtualClock``):

* the reference's ``tests/test_scheduler.py``, case by case, on the port:
  batching decisions, slot lifecycle, FIFO, EOS, preemption, byte-identical
  tokens against the port's own unbatched ``generate()`` (float and q16),
  batched = sequential prefill, chunked prefill, sampled per-seed
  determinism, rejected families and policies, a warm registry that plans
  nothing, no recapture, the memoized steps.  Left out: the plan-store
  round trip (``test_bucket_ladder_round_trips_plan_registry``), which waits
  for the port's JSON plan store (ROADMAP queue 1 item 2);
* the port against the reference on the same traces: the scheduler's event
  history, event for event (admission order, slot, bucket, prefill launches
  a tick, preemption, completion tick) and its greedy tokens; threefry keys
  and random bits bit for bit; sampled tokens equal to the reference's.

On the CPU the compiled decode step runs eagerly; ``CAPTURE_COUNTS`` counts
each input signature it meets, the graphs a CUDA template would capture.
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
from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro.launch.serve import generate as j_generate
from repro.models import transformer as JT
from repro_torch.configs import ArchConfig, get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.engine import reset_plan_caches
from repro_torch.core.quantization import NumericsPolicy
from repro_torch.core.template import default_template
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (
    CAPTURE_COUNTS,
    Request,
    SamplingParams,
    SchedulerConfig,
    ServeScheduler,
    VirtualClock,
    compiled_steps,
    fold_in,
    prng_key,
    random_bits,
    replay_trace,
    request_from_snapshot,
    sampler_fn,
    synthetic_trace,
)
from repro_torch.models import transformer as T

LADDER = (8, 16, 24)
MAX_NEW = 6
MIXED = [5, 9, 3, 17, 8, 24, 2]  # the reference's mixed trace


@pytest.fixture(scope="module")
def setup():
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    params = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    return cfg, params, default_template("cuda", device="cpu"), cfg_j, params_j


def make_sched(setup, *, slots=3, ladder=LADDER, max_new=MAX_NEW, tpl=None, policy=None,
               sampling=None, **kw):
    cfg, params, tpl0, _, _ = setup
    return ServeScheduler(cfg, params, tpl=tpl or tpl0, clock=VirtualClock(), policy=policy,
                          sampling=sampling,
                          sched=SchedulerConfig(ladder=ladder, slots=slots,
                                                max_new_limit=max_new, **kw))


def prompts_of(lengths, vocab=128, seed=7):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, size=n)) for n in lengths]


def unbatched(setup, prompt, gen, tpl=None, policy=None) -> list:
    cfg, params, tpl0, _, _ = setup
    out = serve.generate(cfg, params, torch.tensor([prompt]), gen=gen, tpl=tpl or tpl0,
                         policy=policy)
    return out[0].tolist()


def mixed_trace(max_new=MAX_NEW, arrival=lambda i: float(i % 2)):
    return [Request(prompt=p, max_new=max_new, arrival=arrival(i))
            for i, p in enumerate(prompts_of(MIXED))]


# ---------------------------------------------------------------------------
# batching decisions
# ---------------------------------------------------------------------------


def test_bursty_trace_fills_all_slots(setup):
    sched = make_sched(setup, slots=3)
    trace = [Request(prompt=p, max_new=4, arrival=0.0)
             for p in prompts_of([5, 9, 3, 17, 8, 12])]
    replay_trace(sched, trace, tick=1.0)
    occ = [e["decoded"] for e in sched.history if e["decoded"]]
    assert occ[0] == 3 and max(occ) == 3
    assert sched.counters["completed"] == sched.counters["admitted"] == 6
    assert sched.counters["decode_steps"] < 3 * len(trace)


def test_uniform_trace_trickles(setup):
    sched = make_sched(setup, slots=4)
    trace = [Request(prompt=p, max_new=3, arrival=float(4 * i))
             for i, p in enumerate(prompts_of([6, 6, 6, 6]))]
    replay_trace(sched, trace, tick=1.0)
    assert all(e["decoded"] <= 1 for e in sched.history)
    assert sched.counters["completed"] == 4


def test_adversarial_mixed_lengths(setup):
    sched = make_sched(setup, slots=3)
    lengths = [1, 8, 9, 16, 17, 24, 2, 23]
    trace = [Request(prompt=p, max_new=3, arrival=float(i % 3))
             for i, p in enumerate(prompts_of(lengths))]
    too_long = Request(prompt=prompts_of([25])[0], max_new=3, arrival=0.0)
    stats = replay_trace(sched, trace + [too_long], tick=1.0)
    assert sched.counters["completed"] == len(trace)
    assert sched.counters["rejected"] == 1 and too_long.state == "rejected"
    by_bucket = stats["buckets"]
    assert (by_bucket[8]["admitted"], by_bucket[16]["admitted"],
            by_bucket[24]["admitted"]) == (3, 2, 3)


def _port_cfg(name):
    return ArchConfig(**dataclasses.asdict(j_reduced(j_get_config(name))))


@pytest.mark.parametrize("case", ["mamba2-1.3b", "recurrentgemma-9b", "whisper-medium",
                                  "windowed", "q16 policy on cuda", "mesh", "moe"])
def test_unsupported_families_and_policies_rejected(setup, case):
    """Padding is unsound for recurrent / SSM state, cross-attention and
    windowed rings, and a quantized policy needs the q16 backend: refused
    at construction, as the reference refuses them.  A mesh without ranks
    (a layout only) is refused, for the dense family and for an MoE alike:
    the meshed scheduler runs on ranks (the sharded decode tests)."""
    cfg, params, tpl, _, _ = setup
    kw, err = {}, ValueError
    if case in ("mamba2-1.3b", "recurrentgemma-9b", "whisper-medium"):
        cfg = _port_cfg(case)
    elif case == "windowed":
        cfg = dataclasses.replace(cfg, family="hybrid", pattern=("attn",), window=8)
    elif case == "q16 policy on cuda":
        kw["policy"] = NumericsPolicy("q16")
    elif case == "mesh":
        from repro_torch.launch.mesh import make_test_mesh

        kw["mesh"] = make_test_mesh()
    else:
        from repro_torch.launch.mesh import make_test_mesh

        cfg = _port_cfg("granite-moe-3b-a800m")
        kw["mesh"] = make_test_mesh()
    match = ("requires the 'q16' backend" if "policy" in kw else
             "runs on ranks" if "mesh" in kw else None)
    with pytest.raises(err, match=match):
        ServeScheduler(cfg, params, tpl=tpl, clock=VirtualClock(), **kw)


def test_admission_control_queue_cap(setup):
    sched = make_sched(setup, slots=1, max_queue=2)
    for r in [Request(prompt=p, max_new=2) for p in prompts_of([4, 4, 4, 4, 4])]:
        sched.submit(r)
    assert sched.counters["rejected"] == 3
    sched.drain(tick=1.0)
    assert sched.counters["completed"] == 2


# ---------------------------------------------------------------------------
# slot lifecycle, EOS, preemption, FIFO
# ---------------------------------------------------------------------------


def test_slot_lifecycle_no_leak_and_reuse(setup):
    sched = make_sched(setup, slots=2)
    trace = [Request(prompt=p, max_new=3) for p in prompts_of([4, 6, 8, 5, 7])]
    replay_trace(sched, trace, tick=1.0)
    assert sched._free == [0, 1] and sched.active == {}
    assert all(r.state == "completed" and r.slot is None for r in trace)
    for r in trace:
        assert len(r.slot_history) == 1 + r.preemptions
    used = [s for r in trace for s in r.slot_history]
    assert len(used) == 5 and set(used) == {0, 1}


def test_eos_frees_slot_early(setup):
    sched = make_sched(setup, slots=1)
    prompt = prompts_of([6])[0]
    ref = unbatched(setup, prompt, 5)
    req = Request(prompt=prompt, max_new=5, eos_id=ref[1])
    replay_trace(sched, [req], tick=1.0)
    assert req.finish_reason == "eos"
    stop = ref.index(ref[1])
    assert req.generated == ref[: stop + 1]
    assert sched._free == [0]


def test_preemption_requeues_and_completes(setup):
    sched = make_sched(setup, slots=1, preempt_after=2.0)
    a = Request(prompt=prompts_of([4])[0], max_new=6, arrival=0.0)
    b = Request(prompt=prompts_of([5], seed=9)[0], max_new=2, arrival=1.0)
    replay_trace(sched, [a, b], tick=1.0)
    assert sched.counters["preempted"] == 1 and a.preemptions == 1
    assert len(a.slot_history) == 2
    assert a.state == b.state == "completed"
    assert sched._free == [0]
    for r in (a, b):  # the re-prefill of prompt + generated keeps parity
        assert r.generated == unbatched(setup, r.prompt, r.max_new)


def test_fifo_within_bucket(setup):
    sched = make_sched(setup, slots=1)
    trace = [Request(prompt=p, max_new=2, arrival=float(i) * 0.25)
             for i, p in enumerate(prompts_of([6, 5, 7, 6, 4]))]
    replay_trace(sched, trace, tick=1.0)
    assert [rid for e in sched.history for rid in e["admitted"]] == [r.rid for r in trace]
    times = [sched.results[r.rid].completed_at for r in trace]
    assert times == sorted(times)


def test_export_sessions_resume_byte_identical(setup):
    """Snapshots taken mid-run resume in a fresh scheduler and finish with
    the tokens an uninterrupted run gives."""
    sched = make_sched(setup, slots=2)
    trace = mixed_trace(arrival=lambda i: 0.0)
    for r in trace:
        sched.submit(r)
    for _ in range(3):
        sched.step()
    docs = sched.export_sessions()
    assert [d["rid"] for d in docs[:2]] == [trace[0].rid, trace[1].rid]
    fresh = make_sched(setup, slots=2)
    for d in docs:
        assert fresh.submit(request_from_snapshot(d))
    fresh.drain(tick=1.0)
    for d in docs:
        assert fresh.results[d["rid"]].generated == unbatched(
            setup, tuple(d["prompt"]), d["max_new"])


# ---------------------------------------------------------------------------
# byte-identical generation against the unbatched path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q16_setup(setup):
    cfg, params, _, _, _ = setup
    tpl = default_template("q16", device="cpu")
    cal = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)))
    return tpl, T.calibrate_policy(tpl, cfg, params, cal)


@pytest.mark.parametrize("numerics", ["float", "q16"])
def test_batched_tokens_byte_identical_to_unbatched(setup, q16_setup, numerics):
    """The mixed trace through the coalesced, bucket-padded scheduler equals
    unbatched ``generate()`` token for token; q16 with an int16 slot cache,
    and its warm registry replay makes no DSE search."""
    tpl, policy = q16_setup if numerics == "q16" else (None, None)
    sched = make_sched(setup, slots=3, tpl=tpl, policy=policy)
    if numerics == "q16":
        sched.warmup()
        assert sched.cache is None  # the cache is built on admission
    m0 = sched.registry.misses
    trace = mixed_trace()
    replay_trace(sched, trace, tick=1.0)
    assert sched.counters["completed"] == len(trace)
    if numerics == "q16":
        assert sched.registry.misses == m0
        assert sched.cache["blocks"][0]["attn"]["k"].dtype == torch.int16
    for r in trace:
        assert sched.results[r.rid].generated == unbatched(setup, r.prompt, r.max_new, tpl,
                                                           policy), r.rid


def test_batched_mode_matches_sequential_mode(setup):
    outs, launches = [], []
    for mode in ("batched", "sequential"):
        sched = make_sched(setup, slots=3, prefill_mode=mode)
        trace = mixed_trace(max_new=4, arrival=lambda i: 0.0)
        replay_trace(sched, trace, tick=1.0)
        assert sched.counters["completed"] == len(trace)
        outs.append([sched.results[r.rid].generated for r in trace])
        launches.append(sched.counters["prefill_launches"])
    assert outs[0] == outs[1]
    assert launches[0] < launches[1] == len(MIXED)


def test_prefill_launches_bounded_by_occupied_rungs(setup):
    sched = make_sched(setup, slots=3)
    trace = mixed_trace()
    stats = replay_trace(sched, trace, tick=1.0)
    by_rid = {r.rid: r for r in trace}
    for ev in sched.history:
        assert ev["prefill_launches"] <= len({by_rid[rid].bucket for rid in ev["admitted"]})
    assert stats["prefill_coalescing"] >= 1.0
    assert stats["counters"]["prefill_launches"] < len(MIXED)
    assert stats["ttft"]["n"] == len(MIXED)
    assert stats["ttft"]["p50"] <= stats["ttft"]["p99"]


_BATCH_ENV: dict = {}


@given(st.lists(st.integers(1, 16), min_size=2, max_size=4), st.integers(0, 9))
@settings(max_examples=8, deadline=None)
def test_batched_prefill_rows_bitwise_equal_single(lengths, seed):
    """A coalesced (B, L) prefill over right-padded prompts gives each row
    the bytes of its own (1, L) prefill on the integer path (grid-resident
    q16: every GEMM exact, the float islands row by row).  Float rows agree
    to 1e-5: the CPU's f32 GEMM sums in an order that follows M, as XLA's
    does (the reference's own float case differs in the last ulp, ROADMAP
    queue 3)."""
    if not _BATCH_ENV:
        cfg = reduced(get_config("qwen2-0.5b"))
        params = T.init_params(torch.Generator().manual_seed(0), cfg)
        tq = default_template("q16", device="cpu")
        pol = T.calibrate_policy(tq, cfg, params, torch.randint(
            0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(9)))
        _BATCH_ENV.update(cfg=cfg, runs=(
            (default_template("cuda", device="cpu"), None, params),
            (tq, pol, T.quantize_params(tq, cfg, params, pol))))
    cfg = _BATCH_ENV["cfg"]
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), 16), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, cfg.vocab, size=n)
    last = torch.tensor([n - 1 for n in lengths])
    for tpl, pol, params in _BATCH_ENV["runs"]:
        fns = compiled_steps(tpl, cfg, 24, pol)
        lg_batch = fns.prefill(params, torch.from_numpy(toks), None, last)[0]
        for i in range(len(lengths)):
            lg_one = fns.prefill(params, torch.from_numpy(toks[i:i + 1]), None,
                                 last[i:i + 1])[0][0]
            if pol is None:
                np.testing.assert_allclose(lg_batch[i].numpy(), lg_one.numpy(), atol=1e-5,
                                           rtol=1e-5)
            else:
                assert torch.equal(lg_batch[i], lg_one), (lengths, i)


_PAD_ENV: dict = {}


@given(st.integers(1, 16))
@settings(max_examples=6, deadline=None)
def test_padding_never_changes_real_position_logits(s):
    if not _PAD_ENV:
        cfg = reduced(get_config("qwen2-0.5b"))
        _PAD_ENV.update(cfg=cfg, tpl=default_template("cuda", device="cpu"),
                        params=T.init_params(torch.Generator().manual_seed(0), cfg))
    cfg, tpl, params = _PAD_ENV["cfg"], _PAD_ENV["tpl"], _PAD_ENV["params"]
    toks = torch.randint(0, cfg.vocab, (1, s), generator=torch.Generator().manual_seed(s))
    padded = torch.nn.functional.pad(toks, (0, 16 - s))
    lg_exact, _ = T.prefill(tpl, cfg, params, toks, cache_len=32)
    lg_padded, _ = T.prefill(tpl, cfg, params, padded, cache_len=32, last_pos=s - 1)
    np.testing.assert_allclose(lg_padded.numpy(), lg_exact.numpy(), atol=1e-5, rtol=1e-5)


def test_warm_mixed_trace_zero_misses(setup):
    """After warmup a mixed trace plans nothing and captures nothing."""
    reset_plan_caches()
    sched = make_sched(setup, slots=2, ladder=(8, 16), max_new=3)
    per_bucket = sched.warmup()
    assert all(b["misses"] > 0 for b in per_bucket.values())
    m0, caps = sched.registry.misses, dict(CAPTURE_COUNTS)
    cfg = setup[0]
    trace = synthetic_trace(5, seed=1, vocab=cfg.vocab, ladder=(8, 16), max_new=3)
    stats = replay_trace(sched, trace, tick=1.0)
    assert sched.counters["completed"] == 5
    assert sched.registry.misses == m0 and stats["registry"]["misses"] == m0
    assert dict(CAPTURE_COUNTS) == caps
    reset_plan_caches()


# ---------------------------------------------------------------------------
# chunked prefill / decode interleaving
# ---------------------------------------------------------------------------


def test_chunked_prefill_matches_unbatched(setup):
    sched = make_sched(setup, slots=3, prefill_chunk=8)
    trace = mixed_trace()
    replay_trace(sched, trace, tick=1.0)
    assert sched.counters["completed"] == len(trace)
    assert sched.counters["chunk_steps"] > 0
    assert any(e["chunk_rows"] and e["decoded"] for e in sched.history)
    for r in trace:
        assert sched.results[r.rid].generated == unbatched(setup, r.prompt, r.max_new)


def test_prefill_chunk_step_equivalence(setup):
    """prefill_chunk_step over a prompt reproduces the whole-prompt prefill:
    the same positions, the same next token, logits to 1e-5 (the reference's
    tolerance here), the inactive lane's row untouched."""
    cfg, params, tpl, _, _ = setup
    s, chunk, clen = 13, 5, 24
    toks = np.asarray(prompts_of([s], seed=3)[0], np.int64)[None]
    lg_ref, _ = T.prefill(tpl, cfg, params, torch.from_numpy(toks), cache_len=clen)
    cache = T.init_cache(cfg, 2, clen, per_slot=True)
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        blk = np.zeros((2, chunk), np.int64)
        blk[0, :n] = toks[0, t0:t0 + n]
        logits, cache = T.prefill_chunk_step(tpl, cfg, params, torch.from_numpy(blk),
                                             torch.tensor([t0, -1]), torch.tensor([n, 0]),
                                             cache)
    np.testing.assert_allclose(logits[0].numpy(), lg_ref[0].numpy(), atol=1e-5, rtol=1e-5)
    assert int(logits[0].argmax()) == int(lg_ref[0].argmax())
    pos = cache["blocks"][0]["attn"]["pos"].numpy()
    assert (pos[:, 1] == -1).all()
    assert (np.sort(pos[0, 0][pos[0, 0] >= 0]) == np.arange(s)).all()


# ---------------------------------------------------------------------------
# sampled decode lanes
# ---------------------------------------------------------------------------


def _sampled_run(setup, seed, **kw):
    sched = make_sched(setup, slots=3,
                       sampling=SamplingParams(temperature=0.8, top_k=20, seed=seed), **kw)
    trace = mixed_trace()
    replay_trace(sched, trace, tick=1.0)
    assert sched.counters["completed"] == len(trace)
    return [sched.results[r.rid].generated for r in trace]


def test_sampled_decode_deterministic_per_seed(setup):
    a = _sampled_run(setup, 17)
    assert a == _sampled_run(setup, 17)
    assert a != _sampled_run(setup, 18)
    assert _sampled_run(setup, 17, prefill_chunk=8) == _sampled_run(setup, 17,
                                                                    prefill_chunk=8)


# ---------------------------------------------------------------------------
# compiled steps: memoized, no recapture
# ---------------------------------------------------------------------------


def test_generate_does_not_recapture(setup):
    cfg, params, tpl, _, _ = setup
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(3))
    first = serve.generate(cfg, params, toks, gen=3, tpl=tpl)  # may capture (cold)
    before = dict(CAPTURE_COUNTS)
    for _ in range(3):
        assert torch.equal(serve.generate(cfg, params, toks, gen=3, tpl=tpl), first)
    assert dict(CAPTURE_COUNTS) == before


def test_scheduler_steps_do_not_recapture(setup):
    sched = make_sched(setup, slots=2)
    sched.warmup()
    replay_trace(sched, [Request(prompt=p, max_new=3) for p in prompts_of([4, 9, 17])],
                 tick=1.0)
    before = dict(CAPTURE_COUNTS)
    replay_trace(sched, [Request(prompt=p, max_new=3)
                         for p in prompts_of([6, 12, 20], seed=11)], tick=1.0)
    assert dict(CAPTURE_COUNTS) == before


def test_compiled_steps_memoized(setup):
    cfg, _, tpl, _, _ = setup
    a = compiled_steps(tpl, cfg, 48)
    b = compiled_steps(tpl, cfg, 48)
    assert a[0] is b[0] and a[1] is b[1] and a.decode_next is b.decode_next
    assert compiled_steps(tpl, cfg, 64)[0] is not a[0]


def test_serve_cli_scheduler_runs_on_cpu():
    out = serve.main(["--device", "cpu", "--scheduler", "--prefill-chunk", "8",
                      "--prompts", "4", "--prompt-len", "8", "--gen", "4"])
    assert len(out) == 4 and all(len(g) == 4 for g in out)
    again = serve.main(["--device", "cpu", "--backend", "q16", "--scheduler",
                        "--temperature", "0.7", "--top-k", "5", "--prompts", "3",
                        "--prompt-len", "8", "--gen", "3"])
    assert [len(g) for g in again] == [3, 3, 3]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _ref_sched(setup, **kw):
    _, _, _, cfg_j, params_j = setup
    sampling = kw.pop("sampling", None)
    slots = kw.pop("slots", 3)
    return jsched.ServeScheduler(
        cfg_j, params_j, tpl=j_template(), clock=jsched.VirtualClock(),
        sampling=None if sampling is None else jsched.SamplingParams(**dataclasses.asdict(
            sampling)),
        sched=jsched.SchedulerConfig(ladder=LADDER, slots=slots, max_new_limit=MAX_NEW, **kw))


def _twin_traces(lengths, arrivals, max_new):
    prompts = prompts_of(lengths)
    mine = [Request(prompt=p, max_new=m, arrival=a, rid=10_000 + i)
            for i, (p, a, m) in enumerate(zip(prompts, arrivals, max_new))]
    ref = [jsched.Request(prompt=p, max_new=m, arrival=a, rid=10_000 + i)
           for i, (p, a, m) in enumerate(zip(prompts, arrivals, max_new))]
    return mine, ref


@pytest.mark.parametrize("variant", [
    {"slots": 3},
    {"slots": 3, "prefill_chunk": 8, "prefill_mode": "sequential"},
    {"slots": 2, "preempt_after": 2.0},
])
def test_history_matches_reference(setup, variant):
    """The same trace through both schedulers: the same history, event for
    event, the same slots, buckets, preemptions and completions, and the
    same greedy tokens."""
    lengths = MIXED + [12, 1, 20]
    mine, ref = _twin_traces(lengths, [float(i % 3) for i in range(len(lengths))],
                             [MAX_NEW, 2, 4, MAX_NEW, 1, 3, MAX_NEW, 5, 2, 4])
    ps = make_sched(setup, **variant)
    js = _ref_sched(setup, **variant)
    replay_trace(ps, mine, tick=1.0)
    jsched.replay_trace(js, ref, tick=1.0)
    assert ps.history == js.history
    for a, b in zip(mine, ref):
        assert (a.slot_history, a.bucket, a.preemptions, a.finish_reason, a.completed_at) == (
            b.slot_history, b.bucket, b.preemptions, b.finish_reason, b.completed_at)
        assert a.generated == b.generated, a.rid
    assert ps.counters == js.counters


def test_synthetic_trace_matches_reference():
    for kw in ({}, {"ladder": (8, 16, 24), "max_new": 6, "arrival_every": 0.5}):
        mine = synthetic_trace(9, seed=3, vocab=128, **kw)
        ref = jsched.synthetic_trace(9, seed=3, vocab=128, **kw)
        assert [(r.prompt, r.max_new, r.arrival) for r in mine] == [
            (r.prompt, r.max_new, r.arrival) for r in ref]
    floor = synthetic_trace(40, seed=0, vocab=128, ladder=(64, 128), min_len=40, min_new=3)
    assert min(len(r.prompt) for r in floor) >= 40 and min(r.max_new for r in floor) >= 3


def test_threefry_keys_and_bits_match_jax():
    """PRNGKey, fold_in (twice: lane, then position) and the partitionable
    random bits, bit for bit against ``jax.random``; the uniform draw behind
    the Gumbel as well."""
    seeds, lanes, positions = [0, 17, 2 ** 31 + 5, 2 ** 32 - 1], [0, 3, 7, 1], [1, 9, 4096, 0]
    key = fold_in(fold_in(prng_key(torch.tensor(seeds)), torch.tensor(lanes)),
                  torch.tensor(positions))
    bits = random_bits(key, 300)
    for i, (s, ln, p) in enumerate(zip(seeds, lanes, positions)):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), ln), p)
        kd = np.asarray(jax.random.key_data(k)) if jnp.issubdtype(k.dtype,
                                                                  jax.dtypes.prng_key) \
            else np.asarray(k)
        assert [int(key[0][i]), int(key[1][i])] == kd.astype(np.int64).tolist()
        want = np.asarray(jax.random.bits(k, (300,), jnp.uint32)).astype(np.int64)
        assert np.array_equal(bits[i].numpy(), want)


def test_sampler_matches_reference():
    """The same logits through the reference's jitted sampler and the port's:
    the same token in every row, over seeds, lanes, positions, temperatures
    and top-k; greedy is argmax, not a sampler, in both."""
    rng = np.random.default_rng(0)
    n = 0
    for temp, top_k in ((0.8, 20), (1.3, 0), (0.5, 3)):
        logits = (3 * rng.standard_normal((16, 128))).astype(np.float32)
        lanes = rng.integers(0, 8, 16).astype(np.int32)
        pos = rng.integers(0, 4000, 16).astype(np.int32)
        for seed in (0, 17):
            want = np.asarray(jsched.sampler_fn(temp, top_k)(
                jnp.asarray(logits), jnp.uint32(seed), jnp.asarray(lanes), jnp.asarray(pos)))
            got = sampler_fn(temp, top_k)(torch.from_numpy(logits), seed,
                                          torch.from_numpy(lanes).long(),
                                          torch.from_numpy(pos).long())
            assert np.array_equal(got.numpy(), want), (temp, top_k, seed)
            n += len(want)
    assert n == 96
    for fn in (sampler_fn, jsched.sampler_fn):
        with pytest.raises(ValueError, match="argmax"):
            fn(0.0, 5)


def test_sampled_trace_matches_reference(setup):
    """The mixed trace, sampled (temperature 0.8, top-k 20, seed 17), through
    both schedulers: the same tokens for every request."""
    smp = SamplingParams(temperature=0.8, top_k=20, seed=17)
    mine, ref = _twin_traces(MIXED, [float(i % 2) for i in range(len(MIXED))],
                             [MAX_NEW] * len(MIXED))
    replay_trace(make_sched(setup, sampling=smp), mine, tick=1.0)
    jsched.replay_trace(_ref_sched(setup, sampling=smp), ref, tick=1.0)
    assert [r.generated for r in mine] == [r.generated for r in ref]


def test_sampled_generate_matches_reference(setup):
    """``generate`` with sampled lanes (lane = batch row) gives the
    reference's tokens on the same weights and prompts."""
    cfg, params, tpl, cfg_j, params_j = setup
    prompts = np.asarray(prompts_of([7, 7, 7], seed=5), np.int32)
    smp = SamplingParams(temperature=0.9, top_k=12, seed=23)
    want = j_generate(cfg_j, params_j, jnp.asarray(prompts), gen=5, tpl=j_template(),
                      sampling=jsched.SamplingParams(**dataclasses.asdict(smp)))
    got = serve.generate(cfg, params, torch.from_numpy(prompts).long(), gen=5, tpl=tpl,
                         sampling=smp)
    assert got.tolist() == np.asarray(want).tolist()
