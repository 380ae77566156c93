"""Front-tier request router over N data-parallel ServeScheduler replicas.

The port's copy of ``repro.launch.router``.  It replicates one
:class:`~repro_torch.launch.scheduler.ServeScheduler` behind a single
admission queue; three design rules keep the composition as deterministic
as its parts:

* **One clock, integer ticks.**  The router drives every replica from the
  same injectable clock, one ``step()`` per router tick.  Faults are
  injected through a :class:`~repro_torch.runtime.failover.FaultPlan` keyed
  to those ticks, so a (trace, fault plan) pair replays to the same token
  stream every run.
* **Exactly-once tokens via the ledger.**  Every generated token is drained
  into a :class:`TokenLedger` (rid -> append-only stream) each tick.  After
  a kill, the dead replica's in-flight sessions are rebuilt from its last
  checkpoint (``checkpoint/manager.py``; ``extra`` carries
  ``export_sessions()`` snapshots), or from the router's own admission
  record when the session was admitted after the last checkpoint, and
  resubmitted in their original FIFO order.  Greedy decode is a function
  of (params, prompt, generated so far), so a resumed session regenerates
  the same tokens; positions the ledger already holds are verified equal
  and suppressed as duplicates.  On the card that holds exactly on the
  integer grid: a resumed session re-prefills prompt + generated through a
  bucket where the unkilled run decoded, and only the grid makes both
  routes agree bit for bit.
* **Loud unrecoverability.**  A resumed session a replica refuses (its
  re-prefill no longer fits the bucket ladder: give the top rung ``max
  prompt + max_new`` headroom) raises instead of silently losing tokens.

Replica death is modeled in-process: the replica's scheduler releases its
device state (KV cache, its CUDA graphs) and is dropped; only its
incarnation number and stats are kept (``_Replica.graveyard``).  A fresh
incarnation warm-starts after ``restart_delay`` ticks.  The cross-process
variant (worker processes killed for real, one flock'd plan store) is
``repro_torch/benchmarks/router_soak.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.engine import save_plan_store
from repro_torch.launch.scheduler import (
    Request,
    VirtualClock,
    request_from_snapshot,
    session_snapshot,
)
from repro_torch.runtime.failover import FaultPlan

__all__ = ["Assignment", "ReplicaRouter", "TokenLedger"]


class TokenLedger:
    """Append-only per-session token streams with duplicate suppression.

    ``record(rid, pos, tok)`` appends when ``pos`` is the next position of
    the stream; re-emissions of an already-recorded position must match
    byte-for-byte (they are a resumed replica regenerating its greedy
    prefix) and are counted, not stored.  A *mismatched* re-emission or a
    gap means the exactly-once protocol broke — both raise immediately
    rather than corrupting the stream.
    """

    def __init__(self) -> None:
        self._streams: dict = {}
        self.duplicates_suppressed = 0

    def record(self, rid: int, pos: int, tok: int) -> bool:
        stream = self._streams.setdefault(rid, [])
        if pos < len(stream):
            if stream[pos] != tok:
                raise RuntimeError(
                    f"ledger divergence: session {rid} position {pos} "
                    f"re-emitted as {tok}, previously {stream[pos]}")
            self.duplicates_suppressed += 1
            return False
        if pos > len(stream):
            raise RuntimeError(
                f"ledger gap: session {rid} emitted position {pos} but "
                f"stream holds {len(stream)} tokens")
        stream.append(int(tok))
        return True

    def tokens(self, rid: int) -> list:
        return list(self._streams.get(rid, ()))

    def as_dict(self) -> dict:
        return {rid: list(s) for rid, s in self._streams.items()}


@dataclasses.dataclass
class Assignment:
    """One (session -> replica incarnation) placement interval.  ``seq`` is
    a router-global routing sequence number: placements are totally ordered
    by it, which is what the requeue-FIFO-preservation asserts compare."""

    replica: int
    incarnation: int
    start_tick: int
    seq: int = 0
    end_tick: Optional[int] = None
    end_reason: str = ""  # "completed" | "killed"


@dataclasses.dataclass
class _Replica:
    rid: int
    sched: object = None
    incarnation: int = 0
    alive: bool = False
    restart_at: Optional[int] = 0  # tick to (re)start at; None while running
    assigned: dict = dataclasses.field(default_factory=dict)  # rid -> Request
    seen: dict = dataclasses.field(default_factory=dict)  # rid -> harvested
    #: (incarnation, stats) of each killed incarnation; its device state is
    #: released at the kill
    graveyard: list = dataclasses.field(default_factory=list)


class ReplicaRouter:
    """Admit requests across N scheduler replicas; survive replica death.

    ``make_scheduler(replica_id, clock)`` builds one replica's
    :class:`ServeScheduler` (the factory decides model, policy, mesh).  All
    replicas share the router's clock; ``checkpoint_dir`` enables per-replica
    session checkpoints every ``checkpoint_every`` ticks (written *after*
    the tick's step + token harvest, so a checkpoint never leads the
    ledger); ``store_path``/``store_save_every`` periodically merge each
    replica's plans into the shared flock'd plan store, honoring
    ``FaultPlan.delayed_saves``.
    """

    def __init__(self, make_scheduler: Callable, n_replicas: int, *,
                 clock=None, fault_plan: Optional[FaultPlan] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, restart_delay: int = 1,
                 store_path: Optional[str] = None, store_save_every: int = 0,
                 warmup: bool = True, tick_dt: float = 1.0) -> None:
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.make_scheduler = make_scheduler
        self.clock = clock or VirtualClock()
        self.fault_plan = fault_plan or FaultPlan()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.restart_delay = max(1, int(restart_delay))
        self.store_path = store_path
        self.store_save_every = int(store_save_every)
        self.warmup = warmup
        self.tick_dt = float(tick_dt)

        self.replicas = [_Replica(rid=i) for i in range(n_replicas)]
        self.pending: collections.deque = collections.deque()
        self.ledger = TokenLedger()
        self.accepted: dict = {}  # rid -> admission-time snapshot (fresh)
        self.assignments: dict = {}  # rid -> [Assignment, ...]
        self.completed: set = set()
        self.rejected: set = set()
        self.counters: collections.Counter = collections.Counter()
        self.store_save_log: list = []
        self._pending_saves: list = []  # (actual_tick, replica, due_tick)
        self._mgrs: dict = {}
        self.tick_index = 0
        for rep in self.replicas:
            self._start(rep, 0)

    # -- replica lifecycle ---------------------------------------------------

    def _ckpt_mgr(self, rep: _Replica) -> Optional[CheckpointManager]:
        if self.checkpoint_dir is None:
            return None
        mgr = self._mgrs.get(rep.rid)
        if mgr is None:
            mgr = CheckpointManager(
                os.path.join(self.checkpoint_dir, f"replica_{rep.rid}"))
            self._mgrs[rep.rid] = mgr
        return mgr

    def _start(self, rep: _Replica, tick: int) -> None:
        rep.sched = self.make_scheduler(rep.rid, self.clock)
        if self.warmup:
            rep.sched.warmup()
        rep.alive = True
        rep.restart_at = None
        rep.seen = {}
        self.counters["replica_starts"] += 1
        if tick > 0:
            self.counters["restarted"] += 1

    def _kill(self, rep: _Replica, tick: int) -> None:
        """Replica death: recover its in-flight sessions, schedule restart.

        The scheduler releases its KV cache and CUDA graphs and is dropped.
        Recovery source of truth, per session and in the replica's original
        assignment (FIFO) order: the last checkpoint's snapshot when present
        (``restored_*`` counters), else the router's admission record (the
        session was admitted after the last checkpoint — requeued fresh).
        Recovered sessions go to the *front* of the router queue so their
        original FIFO standing is preserved relative to not-yet-routed work.
        """
        self.counters["killed"] += 1
        rep.graveyard.append((rep.incarnation, rep.sched.stats()))
        snaps: dict = {}
        mgr = self._ckpt_mgr(rep)
        if mgr is not None:
            _, extra = mgr.latest_extra()
            if extra:
                snaps = {int(s["rid"]): s for s in extra.get("sessions", ())}
        recovered = []
        for rid, req in rep.assigned.items():
            if rid in self.completed:
                continue
            recs = self.assignments.get(rid)
            if recs:
                recs[-1].end_reason = "killed"
                recs[-1].end_tick = tick
            if rid in snaps:
                nreq = request_from_snapshot(snaps[rid])
                self.counters["restored_sessions"] += 1
                self.counters["restored_tokens"] += len(nreq.generated)
            else:
                nreq = request_from_snapshot(self.accepted[rid])
                self.counters["requeued_fresh"] += 1
            recovered.append(nreq)
        self.counters["requeued_sessions"] += len(recovered)
        for nreq in reversed(recovered):
            self.pending.appendleft(nreq)
        rep.assigned = {}
        rep.sched.release()
        rep.sched = None
        rep.alive = False
        rep.incarnation += 1
        rep.restart_at = tick + self.restart_delay

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue at the front tier; replica placement happens at tick."""
        self.counters["submitted"] += 1
        self.pending.append(req)

    def _route(self, tick: int) -> None:
        """Place queued requests FIFO onto the least-loaded live replica
        (ties to the lowest replica id — deterministic), skipping replicas
        in a FaultPlan admission-reject window or with a full queue."""
        while self.pending:
            candidates = [
                rep for rep in self.replicas
                if rep.alive
                and not self.fault_plan.rejects_admission(rep.rid, tick)
                and len(rep.sched.queue) < rep.sched.sched.max_queue
            ]
            if not candidates:
                self.counters["route_stalls"] += 1
                return
            rep = min(candidates,
                      key=lambda r: (len(r.sched.queue) + len(r.sched.active),
                                     r.rid))
            req = self.pending.popleft()
            if not rep.sched.submit(req):
                if req.generated or req.rid in self.accepted:
                    raise RuntimeError(
                        f"unrecoverable: replica {rep.rid} rejected resumed "
                        f"session {req.rid} (seq_len={req.seq_len}, "
                        f"remaining={req.remaining}) — the ladder needs "
                        f"max prompt + max_new headroom in its top rung")
                self.rejected.add(req.rid)
                self.counters["rejected"] += 1
                continue
            if req.rid not in self.accepted:
                self.accepted[req.rid] = session_snapshot(req)
            rep.assigned[req.rid] = req
            rep.seen[req.rid] = len(req.generated)
            self.counters["assignments"] += 1
            self.assignments.setdefault(req.rid, []).append(
                Assignment(rep.rid, rep.incarnation, tick,
                           seq=self.counters["assignments"]))

    # -- the event loop body -------------------------------------------------

    def _harvest(self, rep: _Replica, tick: int) -> None:
        finished = []
        for rid, req in rep.assigned.items():
            cur = rep.seen.get(rid, 0)
            for pos in range(cur, len(req.generated)):
                if self.ledger.record(rid, pos, req.generated[pos]):
                    self.counters["ledger_tokens"] += 1
            rep.seen[rid] = len(req.generated)
            if req.state == "completed":
                self.completed.add(rid)
                recs = self.assignments.get(rid)
                if recs:
                    recs[-1].end_reason = "completed"
                    recs[-1].end_tick = tick
                finished.append(rid)
        for rid in finished:
            rep.assigned.pop(rid)
            rep.seen.pop(rid, None)

    def _store_saves(self, tick: int) -> None:
        if self.store_path and self.store_save_every > 0 and tick > 0:
            if tick % self.store_save_every == 0:
                for rep in self.replicas:
                    if rep.alive:
                        delay = self.fault_plan.save_delay(rep.rid, tick)
                        self._pending_saves.append((tick + delay, rep.rid, tick))
        due_now = [s for s in self._pending_saves if s[0] <= tick]
        self._pending_saves = [s for s in self._pending_saves if s[0] > tick]
        for actual, rid, due in due_now:
            save_plan_store(self.store_path)
            self.counters["store_saves"] += 1
            self.store_save_log.append(
                {"replica": rid, "due": due, "actual": tick})

    def tick(self) -> dict:
        """One router tick: fire kills, restart, route, step every live
        replica, harvest tokens, checkpoint, flush store saves."""
        tick = self.tick_index
        event = {"tick": tick, "killed": [], "restarted": [], "stepped": 0}
        for rid in self.fault_plan.kills_at(tick):
            rep = self.replicas[rid]
            if rep.alive:
                self._kill(rep, tick)
                event["killed"].append(rid)
        for rep in self.replicas:
            if not rep.alive and rep.restart_at is not None \
                    and rep.restart_at <= tick:
                self._start(rep, tick)
                event["restarted"].append(rep.rid)
        self._route(tick)
        for rep in self.replicas:
            if rep.alive and (rep.sched.queue or rep.sched.active):
                rep.sched.step()
                event["stepped"] += 1
        for rep in self.replicas:
            if rep.alive:
                self._harvest(rep, tick)
        if self.checkpoint_dir is not None and \
                tick % self.checkpoint_every == 0:
            for rep in self.replicas:
                if rep.alive:
                    self._ckpt_mgr(rep).save(
                        tick, {"tick": np.asarray(tick, np.int64)},
                        extra={"tick": tick,
                               "sessions": rep.sched.export_sessions()})
                    self.counters["checkpoints"] += 1
        self._store_saves(tick)
        self.clock.sleep(self.tick_dt)
        self.tick_index += 1
        return event

    def _drained(self, arrivals) -> bool:
        if arrivals or self.pending:
            return False
        for rep in self.replicas:
            if not rep.alive:
                if rep.restart_at is not None:
                    return False  # restart still owes us a live replica
            elif rep.sched.queue or rep.sched.active:
                return False
        return True

    def run(self, requests: Sequence[Request], *,
            max_ticks: int = 100_000) -> dict:
        """Drive a scripted arrival trace to completion; returns stats()."""
        arrivals = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        t0 = self.clock.now()
        for _ in range(max_ticks):
            elapsed = self.clock.now() - t0
            while arrivals and arrivals[0].arrival <= elapsed:
                self.submit(arrivals.popleft())
            if self._drained(arrivals):
                return self.stats()
            self.tick()
        raise RuntimeError(f"router did not drain in {max_ticks} ticks")

    # -- exactly-once verification (the harness asserts) ---------------------

    def verify_against(self, reference: dict) -> None:
        """Byte-compare the ledger to a reference {rid: tokens} run.

        Zero lost tokens (every reference stream present and complete) and
        zero duplicated tokens (no extra sessions or over-long streams; any
        re-emission already had to match byte-for-byte to be suppressed).
        """
        led = self.ledger.as_dict()
        missing = set(reference) - set(led)
        extra = set(led) - set(reference)
        if missing or extra:
            raise AssertionError(
                f"ledger session mismatch: missing={sorted(missing)} "
                f"extra={sorted(extra)}")
        for rid, want in reference.items():
            if led[rid] != list(want):
                raise AssertionError(
                    f"session {rid} stream diverged: {led[rid]} != {list(want)}")

    def assert_exactly_once(self) -> None:
        """Every completed session was served exactly once per incarnation:
        all non-final placements ended by a kill, the final one completed."""
        for rid in self.completed:
            recs = self.assignments[rid]
            for rec in recs[:-1]:
                if rec.end_reason != "killed":
                    raise AssertionError(
                        f"session {rid} left replica {rec.replica} with "
                        f"reason {rec.end_reason!r} but was re-placed")
            if recs[-1].end_reason != "completed":
                raise AssertionError(
                    f"session {rid} final placement ended "
                    f"{recs[-1].end_reason!r}, not completed")

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        per = {}
        for rep in self.replicas:
            if rep.sched is not None:
                s = rep.sched.stats()
                per[rep.rid] = {
                    "incarnation": rep.incarnation,
                    "alive": rep.alive,
                    "mean_occupancy": s["mean_occupancy"],
                    "ttft": s["ttft"],
                    "counters": s["counters"],
                }
        return {
            "ticks": self.tick_index,
            "counters": dict(self.counters),
            "completed": len(self.completed),
            "rejected": len(self.rejected),
            "duplicates_suppressed": self.ledger.duplicates_suppressed,
            "ledger_sessions": len(self.ledger.as_dict()),
            "replicas": per,
        }

    def stats_line(self) -> str:
        """One-line per-replica occupancy/TTFT rollup + failover counters."""
        c = self.counters
        per = []
        for rep in self.replicas:
            if rep.sched is None:
                per.append(f"r{rep.rid}[dead]")
                continue
            s = rep.sched.stats()
            ttft = s["ttft"].get("p50", 0.0)
            per.append(
                f"r{rep.rid}[inc={rep.incarnation} "
                f"occ={s['mean_occupancy']:.2f} ttft_p50={ttft:.2f} "
                f"done={s['counters'].get('completed', 0)}]")
        return (
            f"router: replicas={len(self.replicas)} ticks={self.tick_index} "
            f"submitted={c['submitted']} completed={len(self.completed)} "
            f"rejected={len(self.rejected)} killed={c['killed']} "
            f"restarted={c['restarted']} requeued={c['requeued_sessions']} "
            f"restored={c['restored_sessions']} "
            f"restored_tokens={c['restored_tokens']} "
            f"dup_suppressed={self.ledger.duplicates_suppressed} "
            f"store_saves={c['store_saves']} | " + " ".join(per)
        )
