"""Serving driver: prefill a batch of prompts and decode, or serve a
mixed-length request set through the continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --backend cuda --prompts 2 --prompt-len 8 --gen 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --scheduler --prefill-chunk 8 --prompts 4 --prompt-len 8 --gen 4

The port's copy of ``repro.launch.serve``: the config is reduced as the
reference's driver reduces it, the weights are random from ``--seed``, and
the run goes through :func:`generate` (or, with ``--scheduler``, a
:class:`ServeScheduler`) on the CUDA kernels (``--backend cuda``, the
default), grid-resident fixed point (``q16``, after a max-abs calibration
pass) or plain tensor ops (``torch``).  ``--device cpu`` runs the kernels'
plain versions.  ``--temperature`` / ``--top-k`` sample each token from a
per-lane RNG stream, reproducible per ``--seed``.  Replicas, shards, the
plan store and the int8 mix exit with "not ported yet" and the ROADMAP
item that brings them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
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

__all__ = ["generate", "main", "run_scheduler"]


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


def run_scheduler(cfg, params, tpl, *, requests: int, prompt_len: int, gen: int,
                  seed: int, clock=None, policy=None, sampling=None,
                  prefill_chunk: int = 0) -> ServeScheduler:
    """Serve a mixed-length synthetic request set, all arriving at t = 0,
    through the continuous-batching scheduler (4 slots, the ladder
    {prompt_len // 2, prompt_len, 2 * prompt_len}); ``prefill_chunk`` > 0
    streams long prompts in chunks beside decode."""
    ladder = tuple(sorted({max(4, prompt_len // 2), prompt_len, 2 * prompt_len}))
    sched = ServeScheduler(
        cfg, params, tpl=tpl, clock=clock or SystemClock(), policy=policy,
        sampling=sampling,
        # the whole burst must fit the queue: rejection is not the policy here
        sched=SchedulerConfig(ladder=ladder, slots=4, max_new_limit=max(gen, 1),
                              max_queue=max(256, requests), prefill_chunk=prefill_chunk),
    )
    sched.warmup()
    replay_trace(sched, _trace(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                               seed=seed), tick=0.0)
    return sched


def _not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported yet (ROADMAP queue 1 {item})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda", "q16", "q8"])
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
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--plan-store", default=None)
    args = ap.parse_args(argv)
    if args.backend == "q8":
        _not_ported("--backend q8 (the int8 / int16 precision DSE)", "items 1 and 3")
    if args.replicas > 1:
        _not_ported("--replicas (the replica router)", "item 4")
    if args.shards > 1:
        _not_ported("--shards (tensor-parallel decode)", "item 5")
    if args.plan_store:
        _not_ported("--plan-store (the JSON plan store)", "item 2")

    cfg = reduced(get_config(args.arch))
    tpl = default_template(args.backend, device=args.device)
    dev = tpl.engine.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    policy = None
    if args.backend == "q16":
        cal = synthetic_batch(args.seed + 1, 7, 2, max(args.prompt_len, 8), cfg.vocab,
                              device=dev)
        policy = T.calibrate_policy(tpl, cfg, params, cal)
        print(f"[serve] numerics: q16 grid-resident, activations {policy.fmt.name} "
              f"(calibrated), weights per-tensor")
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed)
    if not sampling.greedy:
        print(f"[serve] sampling: temperature={sampling.temperature} "
              f"top_k={sampling.top_k} seed={sampling.seed} (per-lane RNG)")
    t0 = time.perf_counter()
    if args.scheduler:
        try:
            sched = run_scheduler(cfg, params, tpl, requests=args.prompts,
                                  prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                                  policy=policy, sampling=sampling,
                                  prefill_chunk=args.prefill_chunk)
        except ValueError as err:  # admission policy lives in ServeScheduler
            raise SystemExit(f"--scheduler: {err}") from err
        dt = time.perf_counter() - t0
        n_tok = sched.counters["tokens"]
        print(f"[serve] arch={cfg.name} backend={args.backend} device={dev} scheduler "
              f"requests={args.prompts} generated={n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s)")
        print(f"[serve] {sched.stats_line()}")
        out = [sched.results[r].generated for r in sorted(sched.results)]
    else:
        tokens = synthetic_batch(args.seed, 0, args.prompts, args.prompt_len, cfg.vocab,
                                 device=dev)
        out = generate(cfg, params, tokens, gen=args.gen, tpl=tpl, policy=policy,
                       sampling=sampling)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[serve] arch={cfg.name} backend={args.backend} device={dev} "
              f"batch={args.prompts} prompt={args.prompt_len} generated={out.shape[1]} "
              f"tokens in {dt:.2f}s ({args.prompts * args.gen / dt:.1f} tok/s)")
    st = tpl.engine.plan_cache.stats()
    print(f"[serve] plan registry: {st['gemm_blocks']} GEMM blocks planned, "
          f"{st['misses']} DSE searches, {st['hits']} cache hits")
    print("[serve] sample generations:")
    for row in out[: min(2, len(out))]:
        print("   ", row.tolist() if isinstance(row, torch.Tensor) else row)
    return out


if __name__ == "__main__":
    main()
