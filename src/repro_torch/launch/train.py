"""End-to-end fault-tolerant training driver, in the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50 \\
        --reduced --batch 8 --seq 128 --ckpt-dir CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 14 \\
        --fail-at 9 --batch 4 --seq 64

The port's copy of ``repro.launch.train``: the same flags and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` runs on the host).  The
step is :func:`repro_torch.launch.steps.make_train_step` on the ``torch``
template (plain tensor ops, the reference's ``xla`` backend), AdamW with a
cosine warm-up schedule.  Features:

  * a restart-safe data pipeline: each batch a pure function of the step
  * atomic checkpoints (``CheckpointManager(keep=3)``) and auto-resume from
    the newest one in ``--ckpt-dir``
  * crash-loop restarts with injected failures (``--fail-at``)
  * the plan store's warm start and save (``--plan-store``)

``--mesh single|multi`` (data-parallel / FSDP training over the
production meshes) is not ported: ROADMAP queue 1 item 7b.
:func:`main` returns (stats, history): the restart loop's statistics, with
each step's wall seconds and grad norm and each checkpoint save's and
restore's wall seconds added, and every step's loss in the order run
(steps re-run after a restart included).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager, restore
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.engine import (
    PLAN_STORE_ENV,
    plan_store_stats,
    save_plan_store,
    warm_start_plan_store,
)
from repro_torch.core.template import default_template
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_init, cosine_warmup
from repro_torch.runtime import FailureInjector, run_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="inject a failure at this step (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--plan-store", default=None,
                    help=f"persisted plan-store path (default: ${PLAN_STORE_ENV})")
    ap.add_argument("--device", default="cuda",
                    help="where the step runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: data-parallel / FSDP training on torch.distributed is "
            f"not ported yet (ROADMAP queue 1 item 7b); run with --mesh none")

    store_path, n = warm_start_plan_store(args.plan_store)
    if n:
        print(f"[train] plan store: warm-started {n} entries from {store_path}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tpl = default_template("torch", device=args.device)
    dev = tpl.engine.device

    opt = AdamW(lr=cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    train_step = make_train_step(cfg, tpl=tpl, opt=opt, accum=args.accum)
    pipe = make_pipeline(cfg, SHAPES["train_4k"], seed=args.seed, global_batch=args.batch,
                         seq_len=args.seq, device=dev)

    def build_state():
        params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
        return params, adamw_init(params)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    injector = FailureInjector(fail_at_steps=args.fail_at)
    state = {}
    timing = {"step_seconds": [], "save_seconds": [], "restore_seconds": [], "grad_norms": []}

    def restore_fn() -> int:
        state.clear()  # the failed incarnation's tensors go before the new ones come
        params, opt_state = build_state()
        step = ckpt.latest()
        if step is None:
            state["params"], state["opt"] = params, opt_state
            return 0
        t0 = time.perf_counter()
        loaded = restore(args.ckpt_dir, step, {"params": params, "opt": opt_state})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing["restore_seconds"].append(time.perf_counter() - t0)
        state["params"], state["opt"] = loaded["params"], loaded["opt"]
        print(f"[train] resumed from checkpoint step {step}")
        return step

    history = []

    def step_fn(step: int):
        injector.check(step)
        batch = pipe.batch(step)
        t0 = time.time()
        state["params"], state["opt"], metrics = train_step(state["params"], state["opt"],
                                                            batch)
        loss = float(metrics["loss"])
        timing["step_seconds"].append(time.time() - t0)
        timing["grad_norms"].append(float(metrics["grad_norm"]))
        history.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"[train] step {step:4d} loss {loss:8.4f} "
                f"gnorm {timing['grad_norms'][-1]:8.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({time.time() - t0:.2f}s)",
                flush=True,
            )

    def save_fn(step: int):
        t0 = time.perf_counter()
        ckpt.save(step, {"params": state["params"], "opt": state["opt"]},
                  extra={"arch": cfg.name})
        timing["save_seconds"].append(time.perf_counter() - t0)

    stats = run_with_restarts(
        num_steps=args.steps,
        step_fn=step_fn,
        save_fn=save_fn,
        restore_fn=restore_fn,
        checkpoint_every=args.ckpt_every,
        max_failures=max(len(args.fail_at), 1),
    )
    stats.update(timing)
    if history:
        first, last = history[0], sum(history[-5:]) / len(history[-5:])
        print(
            f"[train] done: {stats['steps']} steps, {stats['failures']} failures, "
            f"restarts at {stats['restarts']}, loss {first:.4f} -> {last:.4f}"
        )
    else:
        print(f"[train] done: checkpoint step {stats['steps']} in {args.ckpt_dir} already "
              f"reaches --steps {args.steps}; nothing to run")
    pst = plan_store_stats()
    print(f"[train] plan registry: {pst['gemm_blocks']} GEMM blocks + "
          f"{pst['conv_tiles']} conv tiles, {pst['misses']} DSE searches")
    if store_path:
        save_plan_store(store_path)
        print(f"[train] plan store: saved to {store_path}")
    return stats, history


if __name__ == "__main__":
    main()
