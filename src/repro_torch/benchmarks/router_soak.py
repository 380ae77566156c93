"""Router soak: N scheduler worker processes, one shared plan store, one
real kill; zero lost or duplicated tokens and zero cold DSE searches.

    PYTHONPATH=src python -m repro_torch.benchmarks.router_soak --device cpu \
        --workers 2 --requests 24 --out router_soak.json

The port's copy of the reference's ``benchmarks/router_soak.py``; its
workers run the port.  The parent:

1. replays the whole trace through ONE in-process scheduler (the reference
   ledger) and merges its plans into a shared flock'd plan store;
2. partitions the trace round-robin across N worker subprocesses
   (``--worker``: a ServeScheduler per process, warm-started from the shared
   store), each streaming ``T rid pos tok`` ledger lines and ``C rid``
   completion markers on stdout and checkpointing its in-flight sessions
   every ``--checkpoint-every`` ticks;
3. kills worker 0 for real (``--die-at-tick`` -> ``os._exit(137)``, its
   stdout torn wherever it was), recovers its unfinished sessions from its
   last checkpoint (or the original request when a session was never
   checkpointed) and replays them through a recovery worker;
4. merges every stream into one :class:`TokenLedger` (a regenerated token
   must equal the one recorded to be suppressed) and gates on:

   * the ledger byte-identical to the reference (zero lost, zero duplicated);
   * every surviving worker and the recovery worker reporting **zero** DSE
     misses over its whole run, warm-up included;
   * at least one session restored from a checkpoint.

Exits non-zero on any gate failure; ``--out`` writes the stats JSON.
``--device`` is ``cuda`` unless the caller asks for the CPU; ``--backend``
picks the template (``q16`` runs per-op fixed point, as the reference's).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import repro_torch

#: trace prompts sweep only up to 24 while the schedulers run a 32 top rung:
#: a resumed session re-prefills prompt + generated (<= 24 + 6 = 30), so the
#: recovery path always finds a bucket (resumability headroom)
TRACE_LADDER = (8, 16, 24)
SCHED_LADDER = (8, 16, 32)
MAX_NEW = 6
MAX_NEW_LIMIT = 8


def build_scheduler(args):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.launch.scheduler import SchedulerConfig, ServeScheduler, VirtualClock
    from repro_torch.models import transformer as T

    cfg = reduced(get_config(args.arch))
    tpl = default_template(args.backend, device=args.device)
    params = T.init_params(torch.Generator(device=tpl.engine.device).manual_seed(args.seed),
                           cfg)
    sched = ServeScheduler(
        cfg, params, tpl=tpl, clock=VirtualClock(),
        sched=SchedulerConfig(ladder=SCHED_LADDER, slots=args.slots,
                              max_new_limit=MAX_NEW_LIMIT,
                              max_queue=max(256, args.requests)),
    )
    return cfg, sched


# ---------------------------------------------------------------------------
# worker mode: one real scheduler process on the shared store
# ---------------------------------------------------------------------------


def worker_main(args) -> None:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.engine import plan_store_stats, warm_start_plan_store
    from repro_torch.launch.scheduler import request_from_snapshot

    _, loaded = warm_start_plan_store()
    before = plan_store_stats()
    _, sched = build_scheduler(args)
    sched.warmup()

    with open(args.reqfile) as f:
        snaps = json.load(f)
    seen = {}
    for snap in snaps:
        req = request_from_snapshot(snap)
        seen[req.rid] = len(req.generated)  # resume point: emit only new
        if not sched.submit(req):
            raise RuntimeError(f"worker rejected session {req.rid}")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    done = set()
    tick = 0
    while sched.queue or sched.active:
        if args.die_at_tick >= 0 and tick == args.die_at_tick:
            sys.stdout.flush()
            os._exit(137)  # the injected kill: no cleanup, no final line
        sched.step()
        for req in list(sched.active.values()) + list(sched.results.values()):
            cur = seen.get(req.rid, 0)
            for pos in range(cur, len(req.generated)):
                print(f"T {req.rid} {pos} {req.generated[pos]}")
            seen[req.rid] = len(req.generated)
            if req.state == "completed" and req.rid not in done:
                done.add(req.rid)
                print(f"C {req.rid}")
        if mgr is not None and tick % args.checkpoint_every == 0:
            mgr.save(tick, {"tick": np.asarray(tick, np.int64)},
                     extra={"tick": tick, "sessions": sched.export_sessions()})
        tick += 1

    after = plan_store_stats()
    print(json.dumps({
        "worker": args.worker_id,
        "warm_entries": loaded,
        "dse_misses": after["misses"] - before["misses"],
        "completed": len(done),
        "ticks": tick,
        "mean_occupancy": sched.stats()["mean_occupancy"],
        "ttft_p50": sched.stats()["ttft"].get("p50", 0.0),
    }))


# ---------------------------------------------------------------------------
# parent mode
# ---------------------------------------------------------------------------


def _spawn(args, wid, reqfile, ckpt_dir, store, die_at=-1):
    cmd = [
        sys.executable, "-m", "repro_torch.benchmarks.router_soak", "--worker",
        "--worker-id", str(wid), "--reqfile", reqfile,
        "--ckpt-dir", ckpt_dir, "--die-at-tick", str(die_at),
        "--checkpoint-every", str(args.checkpoint_every),
        "--arch", args.arch, "--backend", args.backend, "--device", args.device,
        "--slots", str(args.slots), "--seed", str(args.seed),
        "--requests", str(args.requests),
    ]
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, REPRO_TORCH_PLAN_STORE=store,
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)


def _consume(ledger, text, counters):
    """Feed one worker's streamed stdout into the shared ledger.  A worker
    killed mid-write may tear its last line — malformed lines are dropped
    (their tokens are exactly what recovery re-derives)."""
    completed = set()
    last_json = None
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "T":
            rid, pos, tok = (int(p) for p in parts[1:])
            if ledger.record(rid, pos, tok):
                counters["ledger_tokens"] += 1
        elif len(parts) == 2 and parts[0] == "C":
            completed.add(int(parts[1]))
        elif line.startswith("{"):
            last_json = json.loads(line)
        else:
            counters["torn_lines"] += 1
    return completed, last_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--reqfile", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--die-at-tick", type=int, default=-1)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda", "q16"])
    ap.add_argument("--device", default="cuda",
                    help="where every scheduler runs: cuda (the kernels) or cpu")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-tick", type=int, default=3,
                    help="tick at which worker 0 dies (-1 = no kill); the "
                         "default lands mid-drain for the stock 24-request "
                         "trace (worker 0 needs ~6 ticks)")
    ap.add_argument("--out", default="",
                    help="stats JSON artifact path ('' = skip)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker_main(args)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.engine import (plan_store_stats, save_plan_store,
                                         warm_start_plan_store)
    from repro_torch.launch.router import TokenLedger
    from repro_torch.launch.scheduler import (replay_trace, session_snapshot,
                                              synthetic_trace)

    t_start = time.time()
    _, warm_loaded = warm_start_plan_store()
    before = plan_store_stats()

    # 1. the reference ledger (one in-process scheduler, whole trace) — this
    #    also plants every plan the workers will need
    cfg, ref_sched = build_scheduler(args)
    ref_sched.warmup()
    trace = synthetic_trace(args.requests, seed=args.seed, vocab=cfg.vocab,
                            ladder=TRACE_LADDER, max_new=MAX_NEW)
    snapshots = {r.rid: session_snapshot(r) for r in trace}
    replay_trace(ref_sched, trace)
    reference = {r.rid: list(ref_sched.results[r.rid].generated)
                 for r in trace}
    parent_misses = plan_store_stats()["misses"] - before["misses"]
    print(f"[router-soak] reference: {len(reference)} sessions, "
          f"{sum(len(v) for v in reference.values())} tokens, "
          f"{parent_misses} parent DSE misses (warm_loaded={warm_loaded})")
    if os.environ.get("REPRO_PLAN_ASSERT_WARM") == "1" and parent_misses > 0:
        raise RuntimeError(
            f"ASSERT_WARM: reference run searched {parent_misses} times "
            "against a populated store")

    work = tempfile.mkdtemp(prefix="router_soak_")
    store = os.path.join(work, "plan_store.json")
    save_plan_store(store)  # merged: warm-started entries + reference plans

    # 2. partition round-robin and launch the worker fleet
    parts = {w: [] for w in range(args.workers)}
    for i, r in enumerate(trace):
        parts[i % args.workers].append(snapshots[r.rid])
    procs = {}
    for wid, part in parts.items():
        reqfile = os.path.join(work, f"reqs_{wid}.json")
        with open(reqfile, "w") as f:
            json.dump(part, f)
        ckpt = os.path.join(work, f"ckpt_{wid}")
        die_at = args.kill_tick if wid == 0 else -1
        procs[wid] = (_spawn(args, wid, reqfile, ckpt, store, die_at), ckpt)

    ledger = TokenLedger()
    counters = {"ledger_tokens": 0, "torn_lines": 0}
    worker_rows = []
    victim_completed = set()
    for wid, (proc, ckpt) in procs.items():
        out, _ = proc.communicate(timeout=1200)
        completed, row = _consume(ledger, out, counters)
        if wid == 0 and args.kill_tick >= 0:
            assert proc.returncode == 137, (
                f"victim exited {proc.returncode}, expected the injected kill")
            victim_completed = completed
            print(f"[router-soak] worker 0 killed at tick {args.kill_tick} "
                  f"({len(completed)} of {len(parts[0])} sessions done)")
        else:
            assert proc.returncode == 0, f"worker {wid} failed rc={proc.returncode}"
            assert row is not None and len(completed) == len(parts[wid])
            worker_rows.append(row)

    # 3. recover the victim's unfinished sessions: last checkpoint first,
    #    original request when admitted after it — then a recovery worker
    restored = requeued_fresh = restored_tokens = 0
    if args.kill_tick >= 0:
        _, ckpt0 = procs[0]
        _, extra = CheckpointManager(ckpt0).latest_extra()
        ckpt_snaps = {int(s["rid"]): s
                      for s in (extra or {}).get("sessions", ())}
        recovered = []
        for snap in parts[0]:
            rid = snap["rid"]
            if rid in victim_completed:
                continue
            if rid in ckpt_snaps:
                restored += 1
                restored_tokens += len(ckpt_snaps[rid]["generated"])
                recovered.append(ckpt_snaps[rid])
            else:
                requeued_fresh += 1
                recovered.append(snap)
        assert recovered, "kill tick too late: nothing left to recover"
        assert restored > 0, (
            "kill must catch checkpointed in-flight sessions (restore path)")
        reqfile = os.path.join(work, "reqs_recovery.json")
        with open(reqfile, "w") as f:
            json.dump(recovered, f)
        rproc, _ = procs["recovery"] = (
            _spawn(args, 99, reqfile, os.path.join(work, "ckpt_r"), store), None)
        out, _ = rproc.communicate(timeout=1200)
        completed, row = _consume(ledger, out, counters)
        assert rproc.returncode == 0, f"recovery worker rc={rproc.returncode}"
        assert len(completed) == len(recovered)
        worker_rows.append(row)
        print(f"[router-soak] recovery: {restored} restored "
              f"(+{restored_tokens} checkpointed tokens), "
              f"{requeued_fresh} requeued fresh, "
              f"{ledger.duplicates_suppressed} duplicate tokens suppressed")

    # 4. the gates
    led = ledger.as_dict()
    assert set(led) == set(reference), (
        f"session mismatch: missing={sorted(set(reference) - set(led))} "
        f"extra={sorted(set(led) - set(reference))}")
    for rid, want in reference.items():
        assert led[rid] == want, (
            f"session {rid} diverged across the kill: {led[rid]} != {want}")
    print(f"[router-soak] parity OK: {len(reference)} sessions "
          "byte-identical to the single-process reference — "
          "zero lost, zero duplicated")
    cold = {r["worker"]: r["dse_misses"] for r in worker_rows}
    assert all(m == 0 for m in cold.values()), (
        f"cold DSE searches in warm workers: {cold}")
    assert all(r["warm_entries"] > 0 for r in worker_rows)
    print(f"[router-soak] warm fleet OK: 0 DSE searches across "
          f"{len(worker_rows)} worker processes (shared store)")

    row = {
        "bench": "router_soak",
        "arch": cfg.name, "backend": args.backend, "device": args.device,
        "workers": args.workers, "requests": args.requests,
        "slots": args.slots, "seed": args.seed,
        "kill_tick": args.kill_tick,
        "checkpoint_every": args.checkpoint_every,
        "sessions": len(reference),
        "tokens": sum(len(v) for v in reference.values()),
        "ledger_tokens": counters["ledger_tokens"],
        "duplicates_suppressed": ledger.duplicates_suppressed,
        "torn_lines": counters["torn_lines"],
        "restored_sessions": restored,
        "restored_tokens": restored_tokens,
        "requeued_fresh": requeued_fresh,
        "victim_completed": len(victim_completed),
        "parent_dse_misses": parent_misses,
        "worker_dse_misses": cold,
        "workers_detail": worker_rows,
        "wall_s": time.time() - t_start,
    }
    print(json.dumps({k: v for k, v in row.items() if k != "workers_detail"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
            f.write("\n")
        print(f"[router-soak] stats written to {args.out}")
    return row


if __name__ == "__main__":
    main()
