"""The port's replica router under injected faults, and the fleet's soaks,
on the CPU.

Everything runs on one :class:`VirtualClock`: the router, its scheduler
replicas and the :class:`FaultPlan` share integer ticks, so a (trace, fault
plan) pair replays identically.  A reduced qwen2-0.5b with the reference's
weights (``repro_torch.convert``), the reference's fixtures (ladder (8, 16,
24), 6 new tokens at most, 3 slots a replica).

* The reference's ``tests/test_router_failover.py``, all of it, on the port:
  a kill at any tick leaves the ledger byte-identical to an unkilled
  one-replica run; no session is served twice; FIFO survives the requeue;
  admission-reject windows and delayed store saves compose with kills; a
  resumed session is budgeted by what it has left.  The property test is
  derandomized.
* A killed incarnation releases its device state: the router keeps its
  incarnation and stats, and its scheduler's decode graphs are gone.
* Against the reference's router on the same traces and fault plans: the
  same assignments, counters and store-save log, and a ledger equal to the
  reference's greedy tokens.
* ``repro_torch.benchmarks.router_soak`` with 2 worker processes and a real
  kill, and ``scheduler_soak``'s warm-store gate, on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.template import default_template as j_template
from repro.launch import router as jrouter
from repro.launch import scheduler as jsched
from repro.models import transformer as JT
from repro.runtime import failover as jfailover
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.engine import PlanRegistry
from repro_torch.core.template import default_template
from repro_torch.launch.router import ReplicaRouter, TokenLedger
from repro_torch.launch.scheduler import (
    CAPTURE_COUNTS,
    Request,
    SchedulerConfig,
    ServeScheduler,
    VirtualClock,
    request_from_snapshot,
    session_snapshot,
)
from repro_torch.runtime.failover import FaultPlan

# Resume headroom: prompts <= 16 and max_new <= 6 keep every resumed
# session's re-prefill (prompt + generated <= 22) inside the 24 top rung.
LADDER = (8, 16, 24)
MAX_NEW = 6
TRACE_KINDS = ("bursty", "uniform", "adversarial")

_SETUP = None


def get_setup():
    """Lazy module-wide (cfg, params, tpl, cfg_j, params_j): shared with the
    property test, which takes no fixtures."""
    global _SETUP
    if _SETUP is None:
        cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
        cfg = reduced(get_config("qwen2-0.5b"))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
        params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j)
        params = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
        _SETUP = (cfg, params, default_template("cuda", device="cpu"), cfg_j, params_j)
    return _SETUP


@pytest.fixture(scope="module")
def setup():
    return get_setup()


def trace_spec(kind: str):
    """(prompt, max_new, arrival) per request of one deterministic trace."""
    rng = np.random.default_rng(11)
    if kind == "bursty":
        lens, arrivals = [5, 9, 3, 15, 8, 16, 2, 11], [0.0] * 8
    elif kind == "uniform":
        lens = [6, 12, 4, 16, 7, 10, 3, 14]
        arrivals = [2.0 * i for i in range(len(lens))]
    else:  # adversarial: big prompts burst first, small ones starve behind
        lens = [16, 16, 15, 2, 3, 2, 16, 2]
        arrivals = [0.0, 0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0]
    return [(tuple(int(t) for t in rng.integers(0, 96, size=n)), 3 + (i % (MAX_NEW - 2)), at)
            for i, (n, at) in enumerate(zip(lens, arrivals))]


def make_trace(kind: str, base_rid: int, cls=Request):
    """Fresh Request objects (the scheduler mutates them) with stable rids."""
    return [cls(prompt=p, max_new=mn, arrival=at, rid=base_rid + i)
            for i, (p, mn, at) in enumerate(trace_spec(kind))]


def make_router(setup, n_replicas, **kw):
    cfg, params, tpl = setup[:3]

    def make_sched(rid, clock):
        return ServeScheduler(cfg, params, tpl=tpl, clock=clock,
                              sched=SchedulerConfig(ladder=LADDER, slots=3,
                                                    max_new_limit=MAX_NEW))

    return ReplicaRouter(make_sched, n_replicas, clock=VirtualClock(), **kw)


_REFERENCE: dict = {}


def reference_ledger(setup, kind: str) -> dict:
    """The unkilled one-replica ledger, keyed by trace position."""
    if kind not in _REFERENCE:
        router = make_router(setup, 1)
        trace = make_trace(kind, base_rid=10_000)
        router.run(trace)
        assert len(router.completed) == len(trace)
        led = router.ledger.as_dict()
        _REFERENCE[kind] = {i: led[r.rid] for i, r in enumerate(trace)}
    return _REFERENCE[kind]


def by_position(router, trace) -> dict:
    led = router.ledger.as_dict()
    return {i: led.get(r.rid) for i, r in enumerate(trace)}


# ---------------------------------------------------------------------------
# the ledger itself
# ---------------------------------------------------------------------------


def test_ledger_exactly_once_protocol():
    led = TokenLedger()
    assert led.record(1, 0, 10) and led.record(1, 1, 11)
    assert not led.record(1, 0, 10)
    assert led.duplicates_suppressed == 1
    assert led.tokens(1) == [10, 11]
    with pytest.raises(RuntimeError, match="divergence"):
        led.record(1, 1, 99)
    with pytest.raises(RuntimeError, match="gap"):
        led.record(1, 5, 12)


def test_session_snapshot_round_trip():
    req = Request(prompt=(3, 1, 4), max_new=5, eos_id=7, arrival=2.0)
    req.generated = [9, 2]
    back = request_from_snapshot(session_snapshot(req))
    assert (back.rid, back.prompt, back.generated) == (req.rid, req.prompt, [9, 2])
    assert back.remaining == 3 and back.state == "new"


# ---------------------------------------------------------------------------
# multi-replica parity without faults
# ---------------------------------------------------------------------------


def test_two_replicas_match_single_replica(setup):
    ref = reference_ledger(setup, "bursty")
    router = make_router(setup, 2)
    trace = make_trace("bursty", base_rid=11_000)
    router.run(trace)
    assert by_position(router, trace) == ref
    router.assert_exactly_once()
    assert {a[0].replica for a in router.assignments.values()} == {0, 1}
    assert router.counters["killed"] == 0


# ---------------------------------------------------------------------------
# kill at a tick: byte-identical ledger, exactly once, FIFO across requeue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", TRACE_KINDS)
@pytest.mark.parametrize("kill_tick", [1, 4])
def test_kill_at_tick_byte_identical(setup, tmp_path, kind, kill_tick):
    ref = reference_ledger(setup, kind)
    router = make_router(setup, 2, fault_plan=FaultPlan(kills=((kill_tick, 0),)),
                         checkpoint_dir=str(tmp_path), checkpoint_every=2)
    trace = make_trace(kind, base_rid=12_000 + 100 * kill_tick)
    router.run(trace)
    assert by_position(router, trace) == ref
    router.verify_against({r.rid: ref[i] for i, r in enumerate(trace)})
    router.assert_exactly_once()
    assert router.counters["killed"] == 1 and router.counters["restarted"] == 1
    killed = [(recs[0].seq, recs[1].seq)
              for recs in router.assignments.values() if len(recs) > 1]
    if killed:
        killed.sort()
        reseq = [second for _, second in killed]
        assert reseq == sorted(reseq), "requeued sessions re-routed out of order"
        assert router.counters["requeued_sessions"] == len(killed)


def test_kill_with_checkpoint_restores_generated(setup, tmp_path):
    ref = reference_ledger(setup, "bursty")
    router = make_router(setup, 2, fault_plan=FaultPlan(kills=((4, 0),)),
                         checkpoint_dir=str(tmp_path), checkpoint_every=1)
    trace = make_trace("bursty", base_rid=13_000)
    router.run(trace)
    assert by_position(router, trace) == ref
    c = router.counters
    assert c["restored_sessions"] > 0 and c["restored_tokens"] > 0
    line = router.stats_line()
    assert "restored=" in line and "requeued=" in line and "r0[" in line


@settings(max_examples=5, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1))
def test_kill_parity_property(seed):
    """Drawn kill times x traces x checkpoint cadence: the ledger always
    equals the unkilled run's."""
    rng = np.random.default_rng(seed)
    kill_tick = int(rng.integers(1, 10))
    kind = TRACE_KINDS[int(rng.integers(0, len(TRACE_KINDS)))]
    checkpoint_every = int(rng.integers(1, 4))
    victim = int(rng.integers(0, 2))
    setup = get_setup()
    ref = reference_ledger(setup, kind)
    with tempfile.TemporaryDirectory() as ckpt:
        router = make_router(setup, 2, fault_plan=FaultPlan(kills=((kill_tick, victim),)),
                             checkpoint_dir=ckpt, checkpoint_every=checkpoint_every)
        trace = make_trace(kind, base_rid=20_000)
        router.run(trace)
    assert by_position(router, trace) == ref
    router.assert_exactly_once()


def test_kill_releases_the_dead_incarnation(setup, tmp_path):
    """The graveyard keeps (incarnation, stats) only; the dead scheduler's
    decode graphs are dropped, and each incarnation captured once."""
    caps = sum(CAPTURE_COUNTS.values())
    router = make_router(setup, 2, fault_plan=FaultPlan(kills=((2, 1),)),
                         checkpoint_dir=str(tmp_path), checkpoint_every=1)
    step = router.replicas[1].sched._decode_next
    dead = id(router.replicas[1].sched)
    router.run(make_trace("bursty", base_rid=17_000))
    (inc, stats), = router.replicas[1].graveyard
    assert inc == 0 and isinstance(stats, dict) and "counters" in stats
    assert not any(key[1] == dead for key in step.graphs)
    assert sum(CAPTURE_COUNTS.values()) - caps == 3, "two warm-ups and one restart"


# ---------------------------------------------------------------------------
# the other fault species
# ---------------------------------------------------------------------------


def test_admission_reject_window_routes_elsewhere(setup):
    ref = reference_ledger(setup, "bursty")
    router = make_router(setup, 2, fault_plan=FaultPlan(reject_windows=((0, 0, 3),)))
    trace = make_trace("bursty", base_rid=14_000)
    router.run(trace)
    assert by_position(router, trace) == ref
    for recs in router.assignments.values():
        for rec in recs:
            assert not (rec.replica == 0 and rec.start_tick <= 3), rec


def test_delayed_store_save_lands_late_but_complete(setup, tmp_path):
    store = str(tmp_path / "plan_store.json")
    router = make_router(setup, 2, fault_plan=FaultPlan(delayed_saves=((0, 2, 3),)),
                         store_path=store, store_save_every=2)
    router.run(make_trace("bursty", base_rid=15_000))
    log = router.store_save_log
    delayed = [e for e in log if e["replica"] == 0 and e["due"] == 2]
    assert delayed and delayed[0]["actual"] == 5, delayed
    on_time = [e for e in log if e["replica"] == 1 and e["due"] == 2]
    assert on_time and on_time[0]["actual"] == 2, on_time
    assert os.path.exists(store)
    PlanRegistry().load(store)  # raises PlanStoreError if torn


def test_faults_compose(setup, tmp_path):
    ref = reference_ledger(setup, "adversarial")
    router = make_router(
        setup, 3,
        fault_plan=FaultPlan(kills=((3, 1),), reject_windows=((2, 0, 2),),
                             delayed_saves=((0, 2, 2),)),
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2,
        store_path=str(tmp_path / "store.json"), store_save_every=2)
    trace = make_trace("adversarial", base_rid=16_000)
    router.run(trace)
    assert by_position(router, trace) == ref
    router.assert_exactly_once()
    assert router.counters["killed"] == 1


def test_submit_budgets_resumed_sessions_by_remaining(setup):
    cfg, params, tpl = setup[:3]
    sched = ServeScheduler(cfg, params, tpl=tpl, clock=VirtualClock(),
                           sched=SchedulerConfig(ladder=LADDER, slots=3,
                                                 max_new_limit=MAX_NEW))
    req = Request(prompt=tuple(range(16)), max_new=MAX_NEW)
    req.generated = [1, 2, 3, 4]
    assert sched.cache_len == 30 and req.seq_len == 20 and req.remaining == 2
    assert sched.submit(req)
    assert sched.counters["resumed_sessions"] == 1
    done = Request(prompt=(1, 2), max_new=2)
    done.generated = [5, 6]
    assert not sched.submit(done)


# ---------------------------------------------------------------------------
# against the reference's router
# ---------------------------------------------------------------------------

FAULTS = {
    "bursty": dict(kills=((4, 0),), delayed_saves=((0, 2, 3),)),
    "uniform": dict(kills=((3, 1),), reject_windows=((0, 0, 2),)),
    "adversarial": dict(kills=((3, 1),), reject_windows=((2, 0, 2),),
                        delayed_saves=((0, 2, 2),)),
}


def _assignments(router, trace) -> list:
    return [[dataclasses.asdict(a) for a in router.assignments[r.rid]] for r in trace]


@pytest.mark.parametrize("kind", TRACE_KINDS)
def test_router_equals_the_reference_router(setup, tmp_path, kind):
    cfg, params, tpl, cfg_j, params_j = setup
    n = 3 if kind == "adversarial" else 2
    tpl_j = j_template()

    def make_j(rid, clock):
        return jsched.ServeScheduler(cfg_j, params_j, tpl=tpl_j, clock=clock,
                                     sched=jsched.SchedulerConfig(ladder=LADDER, slots=3,
                                                                  max_new_limit=MAX_NEW))

    kw = dict(checkpoint_every=2, store_save_every=2)
    ref = jrouter.ReplicaRouter(make_j, n, clock=jsched.VirtualClock(),
                                fault_plan=jfailover.FaultPlan(**FAULTS[kind]),
                                checkpoint_dir=str(tmp_path / "j_ckpt"),
                                store_path=str(tmp_path / "j_store.json"), **kw)
    trace_j = make_trace(kind, base_rid=30_000, cls=jsched.Request)
    ref.run(trace_j)
    router = make_router(setup, n, fault_plan=FaultPlan(**FAULTS[kind]),
                         checkpoint_dir=str(tmp_path / "ckpt"),
                         store_path=str(tmp_path / "store.json"), **kw)
    trace = make_trace(kind, base_rid=30_000)
    router.run(trace)
    assert router.ledger.as_dict() == ref.ledger.as_dict()
    assert _assignments(router, trace) == _assignments(ref, trace_j)
    assert dict(router.counters) == dict(ref.counters)
    assert router.store_save_log == ref.store_save_log
    assert router.counters["killed"] == 1 and router.store_save_log
    assert router.tick_index == ref.tick_index


# ---------------------------------------------------------------------------
# the soaks, as subprocesses on the CPU
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soak(module, *argv, env=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env or {}))
    res = subprocess.run([sys.executable, "-m", module, "--device", "cpu", *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


def test_router_soak_two_workers_and_a_real_kill(tmp_path):
    out = _soak("repro_torch.benchmarks.router_soak", "--workers", "2", "--out",
                str(tmp_path / "router_soak.json"))
    row = json.loads((tmp_path / "router_soak.json").read_text())
    assert "parity OK" in out and "warm fleet OK" in out
    assert row["restored_sessions"] > 0 and row["sessions"] == 24
    assert row["worker_dse_misses"] == {"1": 0, "99": 0}


def test_scheduler_soak_warm_gate(tmp_path):
    env = {"REPRO_TORCH_PLAN_STORE": str(tmp_path / "store.json")}
    args = ("--backend", "q16", "--requests", "16")
    cold = _soak("repro_torch.benchmarks.scheduler_soak", *args, "--save-store", env=env)
    assert "parity OK" in cold and "batched beats sequential" in cold
    warm = _soak("repro_torch.benchmarks.scheduler_soak", *args,
                 env=dict(env, REPRO_PLAN_ASSERT_WARM="1"))
    assert "warm start OK" in warm
    assert json.loads(warm.strip().splitlines()[-1])["new_dse_misses"] == 0
