"""Serving under ``SERVE_RULES`` on ``torch.distributed``: heads over
"model", the decode KV ring's sequence over "model" (``seq_kv``,
flash-decoding style), wo and the down projections row-parallel, held
against the reference's single-device decode.

Gloo ranks on the CPU (``launch/mesh.py:spawn_ranks``; both worlds, (1, 2)
and (2, 2), spawned once for the module and run while the test computes
the reference; rank bodies in ``torch_serve_rules_cases.py``), reduced
qwen2, granite-moe (its serve overrides: ``expert_mlp`` over "model", a
row-parallel expert down) and phi3.5-moe (experts over "model"), f32, the
reference's weights carried across as numpy arrays, tokens from numpy
seeds.  The rules are the dry-run's (``launch/dryrun.py:rules_for``), the
weights in their whole layout (``serve_shardings(full=True)``).

Gates:

* the prefill, 12 teacher-forced decode steps, a chunk step
  on a per-slot ring and its decode steps: every rank's logits within
  :data:`TOL` of the reference's ``compiled_steps`` on one device;
* the "wrap" case: a 16-slot ring over 24 steps, so positions wrap across
  the ranks, and rank 1's slots all masked at the first decode step (its
  partial softmax weighs 0 in the combine, never NaN);
* each rank's ring holds its C/M slots (and pos with them);
* ``ServeScheduler(mesh=, rules=SERVE_RULES)`` on (1, 2): the reference's
  single-device scheduler's streams, a token allowed to differ only where
  the reference's top-2 margin is under :data:`FLIP_MARGIN` (counted and
  printed; none so far).

The measured maximum |Δlogit| is printed (``-s``).
"""
import concurrent.futures
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro.models import transformer as JT
from repro_torch.launch.mesh import spawn_ranks

import torch_serve_rules_cases as cases
from torch_family_cases import _make, _np_tree

#: logits against the reference's single-device decode (f32)
TOL = 1e-4
#: a scheduler token may differ from the reference's only at a top-2 margin
#: under this
FLIP_MARGIN = 1e-4
RANKS_TIMEOUT_S = 240
NAMES = sorted({name for _, name, *_ in cases.CASES})
SHAPES = ((1, 2), (2, 2))


def _trace():
    rng = np.random.default_rng(21)
    lens = [3, 12, 7, 16, 5, 10]
    return [(rng.integers(0, 128, n).astype(np.int64), int(rng.integers(4, 9)))
            for n in lens]


def _payload(setups):
    rng = np.random.default_rng(17)
    tokens = {case: rng.integers(0, 128, (cases.B, length + gen)).astype(np.int64)
              for case, _, _, _, length, gen in cases.CASES}
    chunk = {"tokens": rng.integers(0, 128, (cases.B, cases.CHUNK)).astype(np.int64),
             "n_valid": np.asarray(cases.CHUNK_VALID, np.int64),
             "next": rng.integers(0, 128, (cases.B, cases.CHUNK_STEPS)).astype(np.int64)}
    return {"params": {n: _np_tree(setups[n][2]) for n in NAMES}, "tokens": tokens,
            "chunk": chunk, "trace": _trace()}


@pytest.fixture(scope="module")
def ranks():
    setups = {n: _make(n, **({"capacity_factor": 100.0} if "moe" in n else {}))
              for n in NAMES}
    payload = _payload(setups)
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(spawn_ranks, functools.partial(
                    cases.cpu_case, {**payload, "shape": shape}), shape[0] * shape[1],
                    device="cpu", timeout=RANKS_TIMEOUT_S) for shape in SHAPES}
        want = {case: _reference(setups, payload, case) for case in cases.CASES}
        want["scheduler"] = _reference_scheduler(setups, payload)
        got = {shape: f.result() for shape, f in futs.items()}
    return setups, payload, want, got


def _reference(setups, payload, case):
    """The reference's single-device ``compiled_steps`` (``xla``): the
    prefill and teacher-forced decode steps, then a chunk step on a per-slot
    cache and its decode steps."""
    key, name, _, ring, length, gen = case
    cfg_j, _, params_j, _, _, _ = setups[name]
    fns = jsched.compiled_steps(j_template("xla"), cfg_j, ring)
    tokens = jnp.asarray(payload["tokens"][key], jnp.int32)
    logits, cache = fns.prefill(params_j, tokens[:, :length], None, None)
    steps = [np.asarray(logits)]
    for i in range(gen):
        logits, cache = fns.decode(params_j, tokens[:, length + i:length + i + 1],
                                   length + i, cache)
        steps.append(np.asarray(logits))
    out = {"steps": np.stack(steps)}
    if key != "wrap":
        ch = payload["chunk"]
        nv = jnp.asarray(ch["n_valid"], jnp.int32)
        slots = JT.init_cache(cfg_j, cases.B, ring, per_slot=True)
        logits, slots = fns.chunk(params_j, jnp.asarray(ch["tokens"], jnp.int32),
                                  jnp.zeros((cases.B,), jnp.int32), nv, slots)
        chunked = [np.asarray(logits)]
        for i in range(cases.CHUNK_STEPS):
            logits, slots = fns.decode(params_j, jnp.asarray(ch["next"][:, i:i + 1], jnp.int32),
                                       nv + i, slots)
            chunked.append(np.asarray(logits))
        out["chunk"] = np.stack(chunked)
    return out


def _reference_scheduler(setups, payload):
    """The reference's single-device scheduler on the trace: its streams."""
    cfg_j, _, params_j, _, _, _ = setups["qwen2-0.5b"]
    s = jsched.ServeScheduler(cfg_j, params_j, tpl=j_template("xla"),
                              clock=jsched.VirtualClock(),
                              sched=jsched.SchedulerConfig(
                                  ladder=cases.LADDER, slots=cases.SLOTS, max_new_limit=8,
                                  cache_len=cases.SCHED_RING, prefill_chunk=8))
    s.warmup()
    trace = [jsched.Request(prompt=tuple(int(t) for t in p), max_new=n, arrival=0.0,
                            rid=4000 + i) for i, (p, n) in enumerate(payload["trace"])]
    jsched.replay_trace(s, trace)
    return {r.rid: (list(r.prompt), list(r.generated)) for r in trace}


def _margin(setups, prompt, stream, i) -> float:
    """The reference's top-2 margin at generated token ``i`` (its forward
    over the prompt and the stream)."""
    cfg_j, _, params_j, _, _, _ = setups["qwen2-0.5b"]
    seq = prompt + stream[:i]
    logits, _ = JT.forward(j_template("xla"), cfg_j, params_j, jnp.asarray([seq], jnp.int32))
    row = np.sort(np.asarray(logits[0, -1]))
    return float(row[-1] - row[-2])


def _rank_results(got, case):
    return got[case[2]]


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c[0])
def test_serve_rules_decode_equals_the_reference(ranks, case):
    """Prefill, teacher-forced decode steps and a chunk step (with its decode
    steps) under ``rules_for("decode", cfg)`` on every rank: the reference's
    single-device logits within :data:`TOL`."""
    _, _, want, got = ranks
    key = case[0]
    worst = 0.0
    for rank, rec in enumerate(_rank_results(got, case)):
        for part in ("steps", "chunk"):
            if part not in want[case]:
                continue
            err = float(np.abs(rec[key][part] - want[case][part]).max())
            assert np.isfinite(rec[key][part]).all(), (key, part, rank)
            assert err <= TOL, (key, part, rank, err)
            worst = max(worst, err)
    print(f"\n{key}: max |dlogit| against the reference {worst:.3e}")


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c[0])
def test_each_rank_holds_its_slots_of_the_ring(ranks, case):
    """Each rank's k ring and pos hold C / M slots ("model" M = 2), per slot
    too; the sequence's seams ran: the combine's two all-reduces a layer and
    a step, the row-parallel projections' partial sums reduced."""
    _, _, _, got = ranks
    key, _, shape, ring, _, gen = case
    recs = _rank_results(got, case)
    for rec in recs:
        r = rec[key]
        for name in ("prefill_ring", "ring") + (() if key == "wrap" else ("chunk_ring",)):
            assert r[name]["k_shape"][-2] == ring // shape[1], (name, r[name]["k_shape"])
            assert r[name]["pos_shape"][-1] == ring // shape[1]
        assert r["seams"]["kv_max/fwd/model"] == r["seams"]["kv_sum/fwd/model"] > 0
        assert r["seams"]["act_all_reduce/fwd/model"] > 0  # wo and down's partial sums
    if shape[0] == 1:  # the two ranks of "model" hold the two halves of each position
        pos = [rec[key]["ring"]["pos"] for rec in recs]
        held = np.concatenate(pos, axis=-1)
        assert held.shape[-1] == ring


def test_a_rank_whose_slots_are_all_masked(ranks):
    """The "wrap" case: at the first decode step rank 1's slots 8..15 hold
    nothing (every pos -1) and its logits are still the reference's; by the
    end positions 0..27 have wrapped through both ranks' slots."""
    _, _, want, got = ranks
    case = next(c for c in cases.CASES if c[0] == "wrap")
    recs = _rank_results(got, case)
    assert (recs[1]["wrap"]["first_step_ring"]["pos"] < 0).all()
    assert (recs[0]["wrap"]["first_step_ring"]["pos"] >= 0).any()
    final = np.concatenate([r["wrap"]["ring"]["pos"][0] for r in recs], axis=-1)
    length, gen, ring = case[4], case[5], case[3]
    assert sorted(final.tolist()) == list(range(length + gen - ring, length + gen))
    for rec in recs:
        np.testing.assert_allclose(rec["wrap"]["steps"], want[case]["steps"], rtol=0,
                                   atol=TOL)


def test_scheduler_under_serve_rules_equals_the_reference(ranks):
    """``ServeScheduler(mesh=(1, 2), rules=SERVE_RULES)``: the reference's
    single-device streams (chunked admission included); a token differs
    only where the reference's top-2 margin is under :data:`FLIP_MARGIN`,
    and the stream is compared up to it.  Each rank's slot ring holds half
    the slots."""
    setups, _, want, got = ranks
    ref = want["scheduler"]
    flips = []
    for rank, rec in enumerate(got[(1, 2)]):
        sched = rec["scheduler"]
        assert sched["decode_steps"] > 0
        assert sched["ring"]["k_shape"][-2] == cases.SCHED_RING // 2
        for rid, (prompt, stream) in ref.items():
            mine = sched["streams"][rid]
            assert len(mine) == len(stream), rid
            diff = [i for i, (a, b) in enumerate(zip(mine, stream)) if a != b]
            if diff:
                margin = _margin(setups, prompt, stream, diff[0])
                assert margin < FLIP_MARGIN, (rank, rid, diff[0], margin)
                flips.append((rank, rid, diff[0], margin))
    print(f"\nscheduler flips at near-ties: {len(flips)} {flips}")


@pytest.mark.parametrize("name,backend,why", [
    ("mamba2-1.3b", "cuda", "9b"), ("recurrentgemma-9b", "cuda", "9b"),
    ("whisper-medium", "torch", "9b"), ("llama-3.2-vision-90b", "cuda", "9b"),
    ("qwen2-0.5b", "q16", "9c")])
def test_serve_rules_refused_outside_dense_and_moe(name, backend, why):
    """``SERVE_RULES`` (heads and the ring's sequence over "model") runs the
    dense and MoE families on the float templates; the other families and
    the fixed-point template are refused with the ROADMAP item that ports
    them, and still take the column-parallel ``DECODE_RULES``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.launch import scheduler as S
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding as sh

    cfg = reduced(get_config(name))
    tpl = default_template(backend, device="cpu")
    mesh = Mesh((1, 2), ("data", "model")).recording(0)
    with pytest.raises(ValueError, match=f"ROADMAP {why}"):
        S.compiled_steps(tpl, cfg, 16, mesh=mesh, rules=sh.SERVE_RULES)
    S.compiled_steps(tpl, cfg, 16, mesh=mesh, rules=sh.DECODE_RULES)
