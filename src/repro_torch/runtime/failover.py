"""Fault-tolerance runtime: heartbeats, straggler policy, restart loop.

The port's copy of ``repro.runtime.failover``, expression for expression
(pure Python; ``tests/test_torch_checkpoint.py`` holds its outputs equal to
the reference's).

At 1000+ node scale the MTBF of the *job* is hours even when per-node MTBF is
months; the runtime therefore treats failure as the steady state:

* :class:`HeartbeatMonitor` — per-host step-time reports; hosts silent for
  ``timeout_steps`` are declared dead.  On a real deployment heartbeats ride
  the coordination service (GCS / etcd); here they are process-local state
  with the identical decision logic, unit-tested by simulation.
* :func:`detect_stragglers` — median-based outlier policy (a host is a
  straggler when its step time exceeds ``factor`` x the fleet median for
  ``patience`` consecutive steps).  The mitigation at mesh level is elastic:
  drop the replica's hosts and re-mesh (checkpoint restore handles the
  re-shard — see checkpoint/manager.py).
* :func:`run_with_restarts` — the crash-loop driver: run the step function,
  on failure restore the latest checkpoint and continue, up to
  ``max_failures``.  Training state is (params, opt, step) + a pure-function
  data pipeline, so resume is exact.
* :class:`FailureInjector` — deterministic fault injection for tests and
  chaos drills (fail at given steps, or with given probability).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "SimulatedFailure",
    "FailureInjector",
    "FaultPlan",
    "HeartbeatMonitor",
    "detect_stragglers",
    "run_with_restarts",
    "ElasticPlan",
    "plan_elastic_remesh",
]


class SimulatedFailure(RuntimeError):
    """A injected/hardware failure surfaced to the restart loop."""


@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedFailure at chosen steps (deterministic chaos)."""

    fail_at_steps: Sequence[int] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, replayable fault schedule keyed to *virtual ticks*.

    The serving analogue of :class:`FailureInjector`: instead of raising at
    training steps, it tells the :class:`~repro_torch.launch.router.ReplicaRouter`
    what goes wrong at which tick of its event loop, so the same trace +
    the same FaultPlan replays to the same token stream every run
    (the reference's DESIGN.md §9).  Three fault species:

    * ``kills``: ``(tick, replica)`` — replica dies at the *start* of the
      tick (its last completed step was ``tick - 1``); the router drives
      checkpoint-restore + requeue of its in-flight sessions.
    * ``reject_windows``: ``(replica, first_tick, last_tick)`` — admission
      to the replica is refused for ticks in the inclusive window (brown-out
      / drain semantics); pending requests route elsewhere or wait.
    * ``delayed_saves``: ``(replica, due_tick, delay_ticks)`` — the
      replica's periodic plan-store write due at ``due_tick`` lands
      ``delay_ticks`` late (slow-disk fault); the flock'd merge must still
      converge to a complete store.
    """

    kills: tuple = ()
    reject_windows: tuple = ()
    delayed_saves: tuple = ()

    def kills_at(self, tick: int) -> List[int]:
        """Replica ids scheduled to die at the start of ``tick``."""
        return [r for (t, r) in self.kills if t == tick]

    def rejects_admission(self, replica: int, tick: int) -> bool:
        return any(
            r == replica and lo <= tick <= hi
            for (r, lo, hi) in self.reject_windows
        )

    def save_delay(self, replica: int, due_tick: int) -> int:
        for (r, t, d) in self.delayed_saves:
            if r == replica and t == due_tick:
                return int(d)
        return 0


class HeartbeatMonitor:
    """Track last-seen step + step times per host; flag dead/slow hosts."""

    def __init__(self, hosts: Sequence[str], timeout_steps: int = 3):
        self.hosts = list(hosts)
        self.timeout_steps = timeout_steps
        self.last_step: Dict[str, int] = {h: -1 for h in self.hosts}
        self.step_times: Dict[str, List[float]] = {h: [] for h in self.hosts}

    def report(self, host: str, step: int, step_time_s: float):
        self.last_step[host] = step
        self.step_times[host].append(step_time_s)

    def dead_hosts(self, current_step: int) -> List[str]:
        return [
            h
            for h in self.hosts
            if current_step - self.last_step[h] > self.timeout_steps
        ]

    def stragglers(self, factor: float = 2.0, patience: int = 3) -> List[str]:
        return detect_stragglers(self.step_times, factor=factor, patience=patience)


def detect_stragglers(
    step_times: Dict[str, List[float]], factor: float = 2.0, patience: int = 3
) -> List[str]:
    """Hosts whose last ``patience`` steps all exceed factor x fleet median."""
    recent = {h: t[-patience:] for h, t in step_times.items() if len(t) >= patience}
    if not recent:
        return []
    all_last = sorted(t[-1] for t in recent.values())
    median = all_last[len(all_last) // 2]
    if median <= 0:
        return []
    return [
        h for h, t in recent.items() if all(x > factor * median for x in t)
    ]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Decision record for shrinking the mesh after host loss."""

    old_shape: tuple
    new_shape: tuple
    dropped_axis: str
    note: str


def plan_elastic_remesh(mesh_shape: dict, lost_hosts: int, hosts_per_replica: int) -> Optional[ElasticPlan]:
    """Shrink the data axis by whole replicas to exclude lost hosts.

    Model-parallel groups are indivisible (they hold a param shard each), so
    elasticity always drops along the (pod, data) axes.  Returns None when the
    loss fits inside spare capacity (0 replicas to drop).
    """
    replicas_lost = -(-lost_hosts // hosts_per_replica)
    if replicas_lost <= 0:
        return None
    data = mesh_shape.get("data", 1)
    new_data = data - replicas_lost
    if new_data < 1:
        raise SimulatedFailure("not enough healthy replicas to continue")
    old = tuple(mesh_shape.values())
    new_shape = dict(mesh_shape, data=new_data)
    return ElasticPlan(
        old_shape=old,
        new_shape=tuple(new_shape.values()),
        dropped_axis="data",
        note=f"dropped {replicas_lost} data replicas after losing {lost_hosts} hosts",
    )


def run_with_restarts(
    *,
    num_steps: int,
    step_fn: Callable[[int], dict],
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    checkpoint_every: int = 10,
    max_failures: int = 3,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
) -> dict:
    """Crash-loop training driver.

    ``step_fn(step)`` runs one step (may raise SimulatedFailure);
    ``save_fn(step)`` checkpoints; ``restore_fn()`` -> resume step (state is
    restored by the caller's closure).  Returns run statistics.
    """
    failures = 0
    restarts: List[int] = []
    step = restore_fn()
    while step < num_steps:
        try:
            step_fn(step)
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                save_fn(step)
        except SimulatedFailure as e:
            failures += 1
            if on_failure is not None:
                on_failure(step, e)
            if failures > max_failures:
                raise
            step = restore_fn()
            restarts.append(step)
    return {"steps": step, "failures": failures, "restarts": restarts}
