"""End-to-end fault-tolerant training driver, in the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50 \\
        --reduced --batch 8 --seq 128 --ckpt-dir CKPT
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 14 \\
        --fail-at 9 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --mesh single \\
        --ranks 4 --steps 6 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --mesh single \\
        --ranks 4 --model 2 --steps 6 --batch 8 --seq 64

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

``--mesh single|multi`` trains on ``--ranks`` processes
(``launch.mesh.spawn_ranks``: NCCL with a card per rank, else gloo, every
rank on the one card or on the host; or, when :func:`main` is called on
every rank of a process group that is already up, on those ranks, as the
reference's ``main`` runs on every host of a job) under ``TRAIN_RULES`` with the
config's rule overrides, on the reference's production meshes mapped onto
the ranks: ``single`` maps its (16, 16) ("data", "model") mesh onto (N / M,
M), ``multi`` its (2, 16, 16) ("pod", "data", "model") onto (2, N / 2M, M),
M being ``--model`` (default 1).  Batch over the data axes, FSDP over
"data" (pod x data is hybrid-sharded: each pod holds a whole copy), tensor
parallelism with sequence-parallel activations over "model" (heads, qkv,
mlp, vocab, experts, ssm_inner and rec; the residual stream's sequence).
Each rank builds its state shard by
shard, keeps its rows of every batch, saves checkpoints gathered to their
logical shapes (rank 0 writes) and restores onto its shardings, so a run
resumes on another mesh or on one device.  Only rank 0 prints.
:func:`main` returns (stats, history): the restart loop's statistics, with
each step's wall seconds and grad norm and each checkpoint save's and
restore's wall seconds added (on the card also its peak memory, and on a
mesh every rank's), and every step's loss in the order run (steps re-run
after a restart included); on a mesh, rank 0's (called on the ranks, each
rank's own).  ``--ckpt-every 0`` turns checkpoints off: nothing is saved
or restored, and a failure restarts from step 0.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import torch
import torch.distributed as dist

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
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.launch.steps import make_train_step, state_shardings
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_init, cosine_warmup
from repro_torch.parallel.sharding import TRAIN_RULES
from repro_torch.runtime import FailureInjector, run_with_restarts


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="train on --ranks processes on the reference's production "
                         "meshes: 'single' maps its (16, 16) (data, model) mesh onto "
                         "(N/M, M), 'multi' its (2, 16, 16) (pod, data, model) onto "
                         "(2, N/2M, M), M = --model; TRAIN_RULES' batch and FSDP over "
                         "the data axes, tensor parallelism over 'model'")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of a --mesh run (default: one per visible card, or 2 "
                         "with --device cpu)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of a --mesh run's 'model' axis, the size the production "
                         "mesh's 16-wide 'model' axis maps onto (tensor parallelism with "
                         "sequence-parallel activations); --ranks must be a multiple")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false",
                    help="on a --mesh, replicate the parameters over the data axes "
                         "(TRAIN_RULES with 'embed' None): plain data parallelism")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint every this many steps and at the end; 0: never")
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
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh == "none":
        return _train(args)
    joined = dist.is_available() and dist.is_initialized()
    ranks = args.ranks
    if ranks is None:
        ranks = (dist.get_world_size() if joined else torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else 2)
    train_mesh(ranks, args.mesh == "multi", model=args.model)  # a bad count: before any rank
    if joined:  # called on every rank of a running group: train on its ranks
        if dist.get_world_size() != ranks:
            raise ValueError(f"--ranks {ranks} on a process group of "
                             f"{dist.get_world_size()} ranks")
        return _train_rank(args, dist.get_rank(), ranks, args.device)
    return spawn_ranks(functools.partial(_train_rank, args), ranks, device=args.device)[0]


def _train_rank(args, rank: int, world: int, device):
    """One rank of a ``--mesh`` run (``spawn_ranks``' ``fn``)."""
    mesh = train_mesh(world, args.mesh == "multi", model=args.model).init_groups()
    return _train(args, mesh=mesh, device=device)


def _train(args, mesh=None, device=None):
    """The training run of :func:`main`; on a rank of ``mesh`` this rank's
    part of it (only rank 0 prints)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    store_path, n = warm_start_plan_store(args.plan_store)
    if n:
        say(f"[train] plan store: warm-started {n} entries from {store_path}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tpl = default_template("torch", device=str(device or args.device))
    dev = tpl.engine.device
    rules = TRAIN_RULES.with_overrides(**dict(cfg.rule_overrides))
    if not args.fsdp:
        rules = rules.with_overrides(embed=None)
    shardings = None
    if mesh is not None:
        p_sh, o_sh = state_shardings(cfg, mesh, rules)
        shardings = {"params": p_sh, "opt": o_sh}

    opt = AdamW(lr=cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    train_step = make_train_step(cfg, tpl=tpl, opt=opt, accum=args.accum, mesh=mesh,
                                 rules=rules)
    pipe = make_pipeline(cfg, SHAPES["train_4k"], seed=args.seed, mesh=mesh, rules=rules,
                         global_batch=args.batch, seq_len=args.seq, device=dev,
                         accum=args.accum)

    def build_state():
        """The initial state; on a rank its shard, each sub-module cut as it
        is drawn."""
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = T.init_params(gen, cfg, shardings=shardings and shardings["params"])
        return params, adamw_init(params)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    injector = FailureInjector(fail_at_steps=args.fail_at)
    state = {}
    timing = {"step_seconds": [], "save_seconds": [], "restore_seconds": [], "grad_norms": []}

    def restore_fn() -> int:
        state.clear()  # the failed incarnation's tensors go before the new ones come
        params, opt_state = build_state()
        step = ckpt.latest() if args.ckpt_every else None
        if step is None:
            state["params"], state["opt"] = params, opt_state
            return 0
        t0 = time.perf_counter()
        loaded = restore(args.ckpt_dir, step, {"params": params, "opt": opt_state},
                         shardings)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing["restore_seconds"].append(time.perf_counter() - t0)
        state["params"], state["opt"] = loaded["params"], loaded["opt"]
        say(f"[train] resumed from checkpoint step {step}")
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
            say(
                f"[train] step {step:4d} loss {loss:8.4f} "
                f"gnorm {timing['grad_norms'][-1]:8.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({time.time() - t0:.2f}s)",
                flush=True,
            )

    def save_fn(step: int):
        if not args.ckpt_every:
            return
        t0 = time.perf_counter()
        ckpt.save(step, {"params": state["params"], "opt": state["opt"]},
                  extra={"arch": cfg.name}, shardings=shardings)
        timing["save_seconds"].append(time.perf_counter() - t0)

    stats = run_with_restarts(
        num_steps=args.steps,
        step_fn=step_fn,
        save_fn=save_fn,
        restore_fn=restore_fn,
        checkpoint_every=args.ckpt_every or args.steps + 1,
        max_failures=max(len(args.fail_at), 1),
    )
    stats.update(timing)
    if dev.type == "cuda":
        stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        if mesh is not None:  # every rank's, on rank 0's stats too
            peaks = [None] * mesh.size
            torch.distributed.all_gather_object(peaks, stats["peak_mem_bytes"])
            stats["peak_mem_bytes_by_rank"] = peaks
    if history:
        first, last = history[0], sum(history[-5:]) / len(history[-5:])
        say(
            f"[train] done: {stats['steps']} steps, {stats['failures']} failures, "
            f"restarts at {stats['restarts']}, loss {first:.4f} -> {last:.4f}"
        )
    else:
        say(f"[train] done: checkpoint step {stats['steps']} in {args.ckpt_dir} already "
              f"reaches --steps {args.steps}; nothing to run")
    pst = plan_store_stats()
    say(f"[train] plan registry: {pst['gemm_blocks']} GEMM blocks + "
        f"{pst['conv_tiles']} conv tiles, {pst['misses']} DSE searches")
    if store_path and lead:
        save_plan_store(store_path)
        say(f"[train] plan store: saved to {store_path}")
    return stats, history


if __name__ == "__main__":
    main()
