"""Batched serving driver: prefill a batch of prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --backend cuda --prompts 2 --prompt-len 8 --gen 3

The port's copy of ``repro.launch.serve`` without the scheduler: the
config is reduced as the reference's driver reduces it, the weights are
random from ``--seed``, and the run goes through :func:`generate` on the
CUDA kernels (``--backend cuda``, the default), grid-resident fixed point
(``q16``, after a max-abs calibration pass) or plain tensor ops
(``torch``).  ``--device cpu`` runs the kernels' plain versions.  The
scheduler, replicas, shards, the plan store, the int8 mix and sampled
decoding exit with "not ported yet" and the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import transformer as T

__all__ = ["generate", "main"]


def generate(cfg, params, tokens, ctx=None, *, gen: int = 16, cache_len=None,
             tpl=None, policy=None):
    """Greedy prefill + autoregressive decode.  tokens: (B, S) prompts ->
    (B, gen) generated tokens: the prefill's argmax, then ``gen - 1``
    decode steps.

    ``policy``: a quantized :class:`NumericsPolicy` runs the whole loop
    grid-resident (weights quantized once through the engine's qparam
    cache, raw KV cache, float only at the designated islands).
    """
    tpl = tpl or default_template()
    if policy is not None and policy.quantized:
        params = T.quantize_params(tpl, cfg, params, policy)
    b, s = tokens.shape
    cache_len = cache_len or (s + gen)
    logits, cache = T.prefill(tpl, cfg, params, tokens, ctx=ctx, cache_len=cache_len,
                              policy=policy)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = T.decode_step(tpl, cfg, params, tok, s + i, cache, policy=policy)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def _not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


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
    ap.add_argument("--seed", type=int, default=0, help="seeds the prompts and weights")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduler", action="store_true")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--plan-store", default=None)
    args = ap.parse_args(argv)
    if args.backend == "q8":
        _not_ported("--backend q8 (the int8 / int16 precision DSE)", "6")
    if args.temperature > 0:
        _not_ported("sampled decoding (--temperature > 0)", "7")
    if args.scheduler:
        _not_ported("--scheduler", "7")
    if args.replicas > 1:
        _not_ported("--replicas", "8")
    if args.shards > 1:
        _not_ported("--shards", "9")
    if args.plan_store:
        _not_ported("--plan-store", "4")

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
    tokens = synthetic_batch(args.seed, 0, args.prompts, args.prompt_len, cfg.vocab,
                             device=dev)
    t0 = time.perf_counter()
    out = generate(cfg, params, tokens, gen=args.gen, tpl=tpl, policy=policy)
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
        print("   ", row.tolist())
    return out


if __name__ == "__main__":
    main()
