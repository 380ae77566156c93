"""Serving driver: prefill a batch of prompts and decode, or serve a
mixed-length request set through the continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --backend cuda --prompts 2 --prompt-len 8 --gen 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --scheduler --prefill-chunk 8 --prompts 4 --prompt-len 8 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve --backend q8 \\
        --precision-budget 0.5 --prompts 2 --prompt-len 8 --gen 3

The port's copy of ``repro.launch.serve``: the config is reduced as the
reference's driver reduces it, the weights are random from ``--seed``, and
the run goes through :func:`generate` (or, with ``--scheduler``, a
:class:`ServeScheduler`; it admits the dense and MoE families) on the CUDA
kernels (``--backend cuda``, the default), grid-resident fixed point
(``q16``, after a max-abs calibration pass), mixed int8 / int16 fixed point
(``q8``: the q16 template, with the precision DSE choosing each layer
group's grid at ``--precision-budget``) or plain tensor ops (``torch``).
``--device cpu`` runs the kernels' plain versions.  ``--arch`` takes every
registered config; an encoder-decoder or VLM config gets a context drawn
from ``--seed`` (:func:`draw_context`).  ``--temperature`` / ``--top-k``
sample each token from a per-lane RNG stream, reproducible per ``--seed``.  ``--scheduler --replicas
N`` routes the request set across N scheduler replicas behind a
:class:`~repro_torch.launch.router.ReplicaRouter` (tokens drain into its
exactly-once ledger).  ``--plan-store PATH`` (default
``$REPRO_TORCH_PLAN_STORE``) warm-starts the plan registry from a JSON store
and writes the run's plans back to it: a warm run makes no DSE search.
``--scheduler --shards N`` runs tensor-parallel decode over an N-way
"model" axis: N ranks (``launch/mesh.py:spawn_ranks``), each serving the
same requests on its column shard of the weights, the token streams byte
for byte the single-device ones; only rank 0 prints.  On one card the ranks
share it over ``gloo`` and decode eagerly (no CUDA graph holds a gloo
collective).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --backend q16 \
        --scheduler --replicas 2 --plan-store /tmp/plans.json --prompts 4 \
        --prompt-len 8 --gen 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --scheduler \
        --shards 2 --prompts 4 --prompt-len 8 --gen 3
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import (
    PLAN_STORE_ENV,
    save_plan_store,
    warm_start_plan_store,
)
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.launch.router import ReplicaRouter
from repro_torch.launch.scheduler import (
    Request,
    SamplingParams,
    SchedulerConfig,
    ServeScheduler,
    SystemClock,
    compiled_steps,
    replay_trace,
    sample_tokens,
)
from repro_torch.models import transformer as T

__all__ = ["draw_context", "generate", "main", "run_router", "run_scheduler", "shards_mesh"]


def generate(cfg, params, tokens, ctx=None, *, gen: int = 16, cache_len=None,
             tpl=None, policy=None, sampling=None):
    """Prefill + autoregressive decode.  tokens: (B, S) prompts -> (B, gen)
    generated tokens: the prefill's pick, then ``gen - 1`` decode steps.

    The steps come from the :func:`~repro_torch.launch.scheduler.compiled_steps`
    memo the scheduler shares (keyed by template, config, cache_len,
    numerics policy): on a CUDA template each decode step replays one
    captured CUDA graph, which picks the next token inside it, and nothing
    is read back to the host until the end.

    ``policy``: a quantized :class:`NumericsPolicy` runs the whole loop
    grid-resident (weights quantized once through the engine's qparam
    cache, raw KV cache, float only at the designated islands).
    ``sampling``: a :class:`SamplingParams` with temperature > 0 draws each
    token from a per-row RNG lane (lane = batch row, position = the drawn
    token's absolute position); None / temperature <= 0 is greedy.
    """
    tpl = tpl or default_template()
    if policy is not None and policy.quantized:
        params = T.quantize_params(tpl, cfg, params, policy)
    b, s = tokens.shape
    cache_len = cache_len or (s + gen)
    fns = compiled_steps(tpl, cfg, cache_len, policy)
    sampled = sampling is not None and not sampling.greedy
    lanes = torch.arange(b, device=tokens.device)
    logits, cache = fns.prefill(params, tokens, ctx, None)
    tok = (sample_tokens(logits, sampling.seed, lanes, s, sampling.temperature,
                         sampling.top_k) if sampled else torch.argmax(logits, dim=-1))
    out = [tok]
    for i in range(gen - 1):
        tok, _, cache = fns.decode_next(params, tok[:, None], s + i, cache,
                                        sampling=sampling, lanes=lanes, positions=s + i + 1)
        tok = tok.clone()  # the step's output buffer is rewritten by its next call
        out.append(tok)
    return torch.stack(out, dim=1)


def draw_context(cfg, batch: int, *, seed: int, device, dtype=torch.float32):
    """The context input of an encoder-decoder or VLM config, as the
    reference's serve script draws it (N(0, 0.1²)): whisper's frame embeddings
    (batch, n_frames, d) or the image embeddings (batch, n_image_tokens, d),
    from a generator seeded with ``seed`` on ``device``; None for the other
    families."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    n = cfg.n_frames if cfg.family == "encdec" else cfg.n_image_tokens
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = torch.randn((batch, n, cfg.d_model), generator=gen, device=device) * 0.1
    return ctx.to(dtype)


def _trace(cfg, *, requests: int, prompt_len: int, gen: int, seed: int) -> list:
    """The reference driver's request set: lengths drawn in [prompt_len // 2,
    2 * prompt_len] from ``seed``, prompts from ``synthetic_batch``."""
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(requests):
        length = int(rng.integers(max(2, prompt_len // 2), 2 * prompt_len + 1))
        prompt = synthetic_batch(seed, len(trace), 1, length, cfg.vocab)
        trace.append(Request(prompt=tuple(int(t) for t in prompt[0]), max_new=gen))
    return trace


def shards_mesh(shards: int):
    """An ("data", "model") mesh with a ``shards``-way model axis over this
    process group's ranks, its groups made (1 = no mesh, single-device
    decode).  Call it on every rank, inside ``spawn_ranks``."""
    import torch.distributed as dist

    if shards <= 1:
        return None
    n = dist.get_world_size()
    if n % shards:
        raise SystemExit(f"--shards {shards} does not divide the {n} ranks")
    return Mesh((n // shards, shards), ("data", "model")).init_groups()


def run_scheduler(cfg, params, tpl, *, requests: int, prompt_len: int, gen: int,
                  seed: int, clock=None, policy=None, sampling=None,
                  prefill_chunk: int = 0, mesh=None) -> ServeScheduler:
    """Serve a mixed-length synthetic request set, all arriving at t = 0,
    through the continuous-batching scheduler (4 slots, the ladder
    {prompt_len // 2, prompt_len, 2 * prompt_len}); ``prefill_chunk`` > 0
    streams long prompts in chunks beside decode; ``mesh`` runs this rank's
    share of tensor-parallel decode."""
    ladder = tuple(sorted({max(4, prompt_len // 2), prompt_len, 2 * prompt_len}))
    sched = ServeScheduler(
        cfg, params, tpl=tpl, clock=clock or SystemClock(), policy=policy,
        sampling=sampling, mesh=mesh,
        # the whole burst must fit the queue: rejection is not the policy here
        sched=SchedulerConfig(ladder=ladder, slots=4, max_new_limit=max(gen, 1),
                              max_queue=max(256, requests), prefill_chunk=prefill_chunk),
    )
    sched.warmup()
    replay_trace(sched, _trace(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                               seed=seed), tick=0.0)
    return sched


def run_router(cfg, params, tpl, *, replicas: int, requests: int, prompt_len: int, gen: int,
               seed: int, policy=None, sampling=None, mesh=None) -> ReplicaRouter:
    """Serve the request set of :func:`run_scheduler` across ``replicas``
    scheduler replicas (each as :func:`run_scheduler` configures one, each
    on the same tensor-parallel ``mesh`` or none) behind a
    :class:`ReplicaRouter` on the system clock; the tokens drain into the
    router's exactly-once ledger."""
    ladder = tuple(sorted({max(4, prompt_len // 2), prompt_len, 2 * prompt_len}))

    def make_sched(rid, clock):
        return ServeScheduler(
            cfg, params, tpl=tpl, clock=clock, policy=policy, sampling=sampling, mesh=mesh,
            sched=SchedulerConfig(ladder=ladder, slots=4, max_new_limit=max(gen, 1),
                                  max_queue=max(256, requests)),
        )

    router = ReplicaRouter(make_sched, replicas, clock=SystemClock(), tick_dt=0.0)
    router.run(_trace(cfg, requests=requests, prompt_len=prompt_len, gen=gen, seed=seed))
    return router


def _rank_serve(args, rank: int, world: int, device):
    """One rank of ``--shards``: the run on this rank's mesh; only rank 0
    prints.  Returns the rank's streams."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out) if rank else contextlib.nullcontext():
        return [list(row) for row in _serve(args, mesh=shards_mesh(args.shards))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda", "q16", "q8"])
    ap.add_argument("--precision-budget", type=float, default=0.99,
                    help="with --backend q8: the least solo-flip argmax agreement at "
                         "which the precision DSE drops a layer group to the int8 rung")
    ap.add_argument("--device", default="cuda",
                    help="where the template runs: cuda (the kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the prompts, the weights and the sampled-decode lanes")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampled decode temperature; 0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampled decode to the k highest logits (0 = all)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --scheduler: stream prompts longer than this into their "
                         "slot in fixed-width chunks beside decode (0 = whole bucket)")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the continuous-batching scheduler")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --scheduler: route the requests across N scheduler "
                         "replicas behind the ReplicaRouter")
    ap.add_argument("--shards", type=int, default=1,
                    help="with --scheduler: run the decode tensor-parallel over an "
                         "N-way model axis, on N ranks (bitwise the single-device "
                         "streams; dense and MoE arches)")
    ap.add_argument("--plan-store", default=None,
                    help=f"JSON plan-store path (default: ${PLAN_STORE_ENV})")
    args = ap.parse_args(argv)
    if args.shards > 1:
        if not args.scheduler:
            raise SystemExit("--shards N serves through --scheduler (tensor-parallel "
                             "decode)")
        return spawn_ranks(functools.partial(_rank_serve, args), args.shards,
                           device=args.device)[0]
    return _serve(args)


def _serve(args, mesh=None):
    """The run ``main`` parses its arguments for (``mesh``: this rank's
    tensor-parallel mesh under ``--shards``)."""
    # a restart with a populated store makes no DSE search
    store_path, n = warm_start_plan_store(args.plan_store)
    if n:
        print(f"[serve] plan store: warm-started {n} entries from {store_path}")

    cfg = reduced(get_config(args.arch))
    # q8 is the mixed-precision tier of the q16 template: the kernels take
    # every int8 / int16 mix, and the precision DSE picks each group's grid
    backend = "q16" if args.backend == "q8" else args.backend
    tpl = default_template(backend, device=args.device)
    dev = tpl.engine.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    policy = None
    if backend == "q16":
        cal = synthetic_batch(args.seed + 1, 7, 2, max(args.prompt_len, 8), cfg.vocab,
                              device=dev)
        # a calibration error raises, with or without --scheduler: no
        # fallback to per-op fixed point as in the reference's generate path
        policy = T.calibrate_policy(tpl, cfg, params, cal)
        if args.backend == "q8":
            policy = T.calibrate_precision(tpl, cfg, params, cal,
                                           budget=args.precision_budget, policy=policy)
            n8 = sum(1 for _, f in policy.layer_fmts if f.total_bits == 8)
            print(f"[serve] numerics: mixed int8/int16 grid-resident, base "
                  f"{policy.fmt.name}, {n8}/{len(policy.layer_fmts)} groups on the int8 "
                  f"rung (budget {args.precision_budget})")
        else:
            print(f"[serve] numerics: q16 grid-resident, activations {policy.fmt.name} "
                  f"(calibrated), weights per-tensor")
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed)
    if not sampling.greedy:
        print(f"[serve] sampling: temperature={sampling.temperature} "
              f"top_k={sampling.top_k} seed={sampling.seed} (per-lane RNG)")
    t0 = time.perf_counter()
    if args.scheduler and args.replicas > 1:
        try:
            router = run_router(cfg, params, tpl, replicas=args.replicas,
                                requests=args.prompts, prompt_len=args.prompt_len,
                                gen=args.gen, seed=args.seed, policy=policy,
                                sampling=sampling, mesh=mesh)
        except ValueError as err:
            raise SystemExit(f"--replicas: {err}") from err
        dt = time.perf_counter() - t0
        ledger = router.ledger.as_dict()
        n_tok = sum(len(row) for row in ledger.values())
        print(f"[serve] arch={cfg.name} backend={args.backend} device={dev} router "
              f"replicas={args.replicas} shards={args.shards} requests={args.prompts} "
              f"generated={n_tok} tokens "
              f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
        print(f"[serve] {router.stats_line()}")
        out = [ledger[r] for r in sorted(ledger)]
    elif args.scheduler:
        try:
            sched = run_scheduler(cfg, params, tpl, requests=args.prompts,
                                  prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                                  policy=policy, sampling=sampling,
                                  prefill_chunk=args.prefill_chunk, mesh=mesh)
        except ValueError as err:  # admission policy lives in ServeScheduler
            raise SystemExit(f"--scheduler: {err}") from err
        dt = time.perf_counter() - t0
        n_tok = sched.counters["tokens"]
        print(f"[serve] arch={cfg.name} backend={args.backend} device={dev} scheduler "
              f"shards={args.shards} requests={args.prompts} generated={n_tok} tokens "
              f"in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s)")
        print(f"[serve] {sched.stats_line()}")
        out = [sched.results[r].generated for r in sorted(sched.results)]
    else:
        tokens = synthetic_batch(args.seed, 0, args.prompts, args.prompt_len, cfg.vocab,
                                 device=dev)
        ctx = draw_context(cfg, args.prompts, seed=args.seed, device=dev,
                           dtype=params["embed"].dtype)
        out = generate(cfg, params, tokens, ctx, gen=args.gen, tpl=tpl, policy=policy,
                       sampling=sampling)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[serve] arch={cfg.name} backend={args.backend} device={dev} "
              f"batch={args.prompts} prompt={args.prompt_len} generated={out.shape[1]} "
              f"tokens in {dt:.2f}s ({args.prompts * args.gen / dt:.1f} tok/s)")
    st = tpl.engine.plan_cache.stats()
    print(f"[serve] plan registry: {st['gemm_blocks']} GEMM blocks + {st['conv_tiles']} "
          f"conv tiles planned, {st['precision']} precision pins ({st['measured']} "
          f"measured), {st['misses']} DSE searches, {st['hits']} cache hits")
    if store_path:
        save_plan_store(store_path)
        print(f"[serve] plan store: saved to {store_path} ({len(tpl.engine.plan_cache)} "
              f"entries of this spec, {st['measured']} measured)")
    print("[serve] sample generations:")
    for row in out[: min(2, len(out))]:
        print("   ", row.tolist() if isinstance(row, torch.Tensor) else row)
    return out


if __name__ == "__main__":
    main()
