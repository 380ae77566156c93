"""Scheduler soak: batched against sequential prefill on the virtual clock.

    PYTHONPATH=src python -m repro_torch.benchmarks.scheduler_soak --device cpu \\
        --requests 48 --out scheduler_stats.json

The port's copy of the reference's ``benchmarks/scheduler_soak.py``.  It
replays ONE deterministic mixed prompt-length burst (every rung of the
ladder sees traffic, every arrival at t = 0, admission driven by slot frees)
through the continuous-batching scheduler twice: in
``prefill_mode="sequential"`` (one (1, L) prefill launch per admission) and
in the default batched mode.  Both runs use a :class:`VirtualClock` with a
per-launch cost, so throughput and TTFT are in deterministic virtual
seconds.  Gates: both modes generate byte-identical tokens per request, and
the batched run beats the sequential one on prefill launches, virtual
tokens/s and p99 TTFT.

With ``REPRO_PLAN_ASSERT_WARM=1`` the soak is a warm-store gate: the store
named by ``REPRO_TORCH_PLAN_STORE`` must warm-start the registry, and the
whole soak, warm-ups included, must make no DSE search.  The soak writes the
store only when asked (``--save-store``, never with the gate on), so a
failing gate cannot heal itself on a retry.  The reference's stored-baseline
comparison is not ported: its baseline row is the reference's backend.
``--device`` is ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import (
    plan_store_stats,
    save_plan_store,
    warm_start_plan_store,
)
from repro_torch.core.template import default_template
from repro_torch.launch.scheduler import (
    SchedulerConfig,
    ServeScheduler,
    VirtualClock,
    replay_trace,
    synthetic_trace,
)
from repro_torch.models import transformer as T

LADDER = (8, 16, 32)


def build_trace(args, vocab):
    """The soak trace: a closed-loop burst, every request at t = 0 (timed
    arrivals would couple the trace to each mode's launch costs).  Rebuilt
    per run: the scheduler mutates its requests."""
    return synthetic_trace(args.requests, seed=args.seed, vocab=vocab, ladder=LADDER,
                           max_new=args.gen)


def run_mode(args, cfg, tpl, params, *, mode: str, chunk: int) -> dict:
    sched = ServeScheduler(
        cfg, params, tpl=tpl, clock=VirtualClock(),
        sched=SchedulerConfig(ladder=LADDER, slots=args.slots, max_new_limit=args.gen,
                              max_queue=max(256, args.requests), prefill_mode=mode,
                              prefill_chunk=chunk),
    )
    t0 = time.perf_counter()
    sched.warmup()
    warm_s = time.perf_counter() - t0
    trace = build_trace(args, cfg.vocab)
    t0 = time.perf_counter()
    stats = replay_trace(sched, trace, tick=args.tick, launch_cost=args.launch_cost)
    soak_s = time.perf_counter() - t0
    if sched.counters["completed"] != args.requests:
        raise RuntimeError(f"soak[{mode}] incomplete: {sched.counters['completed']}"
                           f"/{args.requests} requests completed")
    c = sched.counters
    vt = sched.clock.now()
    ttft = stats["ttft"]
    return {
        "mode": mode,
        "prefill_chunk": chunk,
        "warmup_s": warm_s,
        "soak_s": soak_s,
        "tokens": c["tokens"],
        "tokens_per_s_wall": c["tokens"] / max(soak_s, 1e-9),
        "virtual_time": vt,
        "tokens_per_vs": round(c["tokens"] / max(vt, 1e-9), 3),
        "prefill_launches": c["prefill_launches"],
        "prefill_coalescing": stats["prefill_coalescing"],
        "chunk_steps": c["chunk_steps"],
        "decode_steps": c["decode_steps"],
        "launches": c["prefill_launches"] + c["chunk_steps"] + c["decode_steps"],
        "ttft_p50": round(ttft.get("p50", 0.0), 3),
        "ttft_p99": round(ttft.get("p99", 0.0), 3),
        "ttft_mean": round(ttft.get("mean", 0.0), 3),
        "stats": stats,
        # keyed by trace position: rids are unique across runs
        "generated": {i: list(sched.results[r.rid].generated) for i, r in enumerate(trace)},
        "stats_line": sched.stats_line(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda", "q16"])
    ap.add_argument("--device", default="cuda",
                    help="where the template runs: cuda (the kernels) or cpu")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--gen", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk width for the batched run (0 = whole bucket)")
    ap.add_argument("--tick", type=float, default=0.25,
                    help="virtual seconds per scheduler tick")
    ap.add_argument("--launch-cost", type=float, default=0.05,
                    help="virtual seconds charged per compute launch")
    ap.add_argument("--save-store", action="store_true",
                    help="merge this run's plans into $REPRO_TORCH_PLAN_STORE at the end "
                         "(refused under REPRO_PLAN_ASSERT_WARM=1)")
    ap.add_argument("--out", default="",
                    help="write the comparison JSON here ('' = skip)")
    args = ap.parse_args(argv)
    assert_warm = os.environ.get("REPRO_PLAN_ASSERT_WARM") == "1"
    if assert_warm and args.save_store:
        raise SystemExit("--save-store under REPRO_PLAN_ASSERT_WARM=1: the gate's run "
                         "never writes the store")

    store_path, loaded = warm_start_plan_store()
    if loaded:
        print(f"[soak] plan store: warm-started {loaded} entries from {store_path}")
    before = plan_store_stats()

    cfg = reduced(get_config(args.arch))
    tpl = default_template(args.backend, device=args.device)
    dev = tpl.engine.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    knobs = {"arch": cfg.name, "backend": args.backend, "device": str(dev),
             "requests": args.requests, "slots": args.slots, "gen": args.gen,
             "seed": args.seed, "ladder": list(LADDER), "tick": args.tick,
             "launch_cost": args.launch_cost}

    seq = run_mode(args, cfg, tpl, params, mode="sequential", chunk=0)
    bat = run_mode(args, cfg, tpl, params, mode="batched", chunk=args.prefill_chunk)
    for r in (seq, bat):
        print(f"[soak] {r['mode']:>10}: launches={r['launches']} "
              f"(prefill {r['prefill_launches']}, chunk {r['chunk_steps']}, "
              f"decode {r['decode_steps']}) vtime={r['virtual_time']} "
              f"tok/vs={r['tokens_per_vs']} ttft_p50={r['ttft_p50']} "
              f"ttft_p99={r['ttft_p99']} wall={r['soak_s']:.3f}s")
        print(f"[soak] {r['stats_line']}")

    # coalescing (and chunking) must never change a generated token
    if seq["generated"] != bat["generated"]:
        bad = [i for i in seq["generated"] if seq["generated"][i] != bat["generated"].get(i)]
        raise RuntimeError(f"batched mode changed generated tokens for requests {bad[:5]}")
    print(f"[soak] parity OK: {len(seq['generated'])} requests byte-identical across modes")
    if not bat["prefill_launches"] < seq["prefill_launches"]:
        raise RuntimeError(f"no launch saving: batched {bat['prefill_launches']} vs "
                           f"sequential {seq['prefill_launches']}")
    if not bat["tokens_per_vs"] > seq["tokens_per_vs"]:
        raise RuntimeError(f"no virtual-throughput win: batched {bat['tokens_per_vs']} vs "
                           f"sequential {seq['tokens_per_vs']} tok/vs")
    if not bat["ttft_p99"] <= seq["ttft_p99"]:
        raise RuntimeError(f"p99 TTFT regressed: batched {bat['ttft_p99']} vs sequential "
                           f"{seq['ttft_p99']}")
    print(f"[soak] batched beats sequential: launches {seq['launches']}->"
          f"{bat['launches']}, tok/vs {seq['tokens_per_vs']}->{bat['tokens_per_vs']}, "
          f"ttft_p99 {seq['ttft_p99']}->{bat['ttft_p99']}")

    after = plan_store_stats()
    new_misses = after["misses"] - before["misses"]
    row = {
        "bench": "scheduler_soak",
        **knobs,
        "new_dse_misses": new_misses,
        "warm_started_entries": loaded,
        "sequential": {k: v for k, v in seq.items()
                       if k not in ("generated", "stats", "stats_line")},
        "batched": {k: v for k, v in bat.items()
                    if k not in ("generated", "stats", "stats_line")},
        **{k: v for k, v in bat["stats"].items() if k != "counters"},
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
            f.write("\n")
        print(f"[soak] comparison stats written to {args.out}")
    if assert_warm:
        if not loaded:
            raise RuntimeError("REPRO_PLAN_ASSERT_WARM set but no plan store was loaded")
        if new_misses > 0:
            raise RuntimeError(f"warm start failed: the soak made {new_misses} DSE "
                               f"searches against a populated store")
        print("[soak] warm start OK: zero DSE searches across the whole soak")
    if args.save_store:
        print(f"[soak] plan store: saved to {save_plan_store()}")
    print(json.dumps({k: v for k, v in row.items()
                      if k not in ("sequential", "batched", "buckets")}))
    return row


if __name__ == "__main__":
    main()
