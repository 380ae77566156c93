"""Fault-tolerance drill: train with injected failures, atomic checkpoints,
auto-resume, and straggler detection, end to end.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train --device cpu

The port's copy of the reference's ``examples/fault_tolerant_train.py``:
``launch.train`` on the reduced internlm2-1.8b, 24 steps of 4 x 64 tokens,
checkpoints every 6 steps into a temporary directory, failures injected at
steps 8 and 17 (each resumed from the newest checkpoint); then the
heartbeat / straggler policy and the elastic re-mesh decision of
``runtime.failover``.  ``--steps`` shrinks the run (failures at a third and
at seven tenths of it).  Asserts that the loss went down.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import main as train_main
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.runtime.failover import plan_elastic_remesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where it runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    steps = args.steps
    fails = (8, 17) if steps == 24 else (steps // 3, steps * 7 // 10)
    every = max(steps // 4, 1)
    with tempfile.TemporaryDirectory() as ckpt:
        print(f"== crash-loop training: failures injected at steps {fails[0]} and "
              f"{fails[1]} ==")
        stats, history = train_main([
            "--arch", "internlm2-1.8b", "--steps", str(steps), "--batch", "4",
            "--seq", "64", "--ckpt-every", str(every), "--ckpt-dir", ckpt,
            "--fail-at", str(fails[0]), "--fail-at", str(fails[1]),
            "--log-every", str(every), "--device", args.device,
        ])
        print(f"survived {stats['failures']} failures, "
              f"restarted from checkpoints at {stats['restarts']}")
        assert history[-1] < history[0]

    print("\n== heartbeat / straggler policy ==")
    mon = HeartbeatMonitor([f"host{i}" for i in range(8)], timeout_steps=3)
    for step in range(6):
        for i in range(8):
            if i == 5 and step >= 3:
                continue  # host5 dies at step 3
            t = 1.0 if i != 2 else (1.0 if step < 2 else 3.5)  # host2 slows
            mon.report(f"host{i}", step, t)
    print("dead hosts:", mon.dead_hosts(current_step=5))
    print("stragglers:", mon.stragglers(factor=2.0, patience=3))

    print("\n== elastic re-mesh decision after losing 8 hosts ==")
    plan = plan_elastic_remesh({"pod": 2, "data": 16, "model": 16},
                               lost_hosts=8, hosts_per_replica=4)
    print(f"mesh {plan.old_shape} -> {plan.new_shape}: {plan.note}")
    print("(a checkpoint restore re-shards the state onto the shrunken mesh: "
          "checkpoint.restore(shardings=))")
    return stats, history


if __name__ == "__main__":
    main()
