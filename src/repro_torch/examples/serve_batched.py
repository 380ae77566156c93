"""Batched serving across architectures: prefill a prompt batch, decode with
ring-buffer KV caches and recurrent states, and hold the decode against the
teacher-forced forward.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu [arch ...]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched [arch ...]   # on the card

The port's copy of the reference's ``examples/serve_batched.py``: reduced
configs, random weights from seed 0, 4 prompts of 24 tokens and 12
generated, through :func:`repro_torch.launch.serve.generate` on the
``cuda`` backend (the kernels on the card, their plain versions with
``--device cpu``).  Prints each architecture's tokens/s and the largest
|Δlogit| between a decode step after prefill and the forward at the same
position.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import all_configs, reduced
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.serve import draw_context, generate
from repro_torch.models import transformer as T

DEFAULT = ["qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b", "whisper-medium"]


def run(name: str, device: str = "cuda"):
    """Serve one reduced architecture; returns (generated tokens (4, 12),
    the decode-parity error)."""
    cfg = reduced(all_configs()[name])
    tpl = default_template("cuda", device=device)
    dev = tpl.engine.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b, s, gen = 4, 24, 12
    prompts = synthetic_batch(0, 0, b, s, cfg.vocab, device=dev)
    ctx = draw_context(cfg, b, seed=1, device=dev, dtype=params["embed"].dtype)

    # correctness: the decode continuation equals the forward's logits
    logits_full, _ = T.forward(tpl, cfg, params, prompts, ctx=ctx)
    _, cache = T.prefill(tpl, cfg, params, prompts[:, :-1], ctx=ctx, cache_len=s + gen)
    lg_dec, _ = T.decode_step(tpl, cfg, params, prompts[:, -1:], s - 1, cache)
    err = float((lg_dec - logits_full[:, -1]).abs().max())

    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, ctx, gen=gen, tpl=tpl)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{name:24s} batch={b} prompt={s} +{gen} tok  {b * gen / dt:8.1f} tok/s  "
          f"decode-parity err {err:.1e}", flush=True)
    return out, err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=DEFAULT)
    ap.add_argument("--device", default="cuda",
                    help="where the template runs: cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    print(f"{'arch':24s} throughput (reduced configs, device {args.device})")
    return {name: run(name, args.device) for name in args.archs}


if __name__ == "__main__":
    main()
