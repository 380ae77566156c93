"""Quickstart: train a small LM on the unified compute unit, then sample.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port's copy of the reference's ``examples/quickstart.py``: the reduced
qwen2-0.5b config, random weights from seed 0, 120 AdamW steps (cosine
warm-up to 2e-3) on the ``torch`` template over synthetic token batches of
8 x 128, then 12 tokens sampled greedily after two 16-token prompts through
``generate`` on the ``cuda`` template (the kernels; their plain versions
with ``--device cpu``).  ``--steps`` / ``--batch`` / ``--seq`` shrink the
run.  Asserts that the loss went down.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import all_configs, reduced
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_init, cosine_warmup


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="where it runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    cfg = reduced(all_configs()["qwen2-0.5b"])
    print(f"arch: {cfg.name} ({cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab})")

    tpl = default_template("torch", device=args.device)
    dev = tpl.engine.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = AdamW(lr=cosine_warmup(2e-3, max(args.steps // 12, 1), args.steps))
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, tpl=tpl, opt=opt)

    losses = []
    last = args.steps - 1
    for step in range(args.steps):
        batch = {"tokens": synthetic_batch(0, step, args.batch, args.seq, cfg.vocab,
                                           device=dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == last:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}")

    assert losses[-1] < losses[0], "loss should decrease"
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")

    prompts = synthetic_batch(1, 0, 2, 16, cfg.vocab, device=dev)
    out = generate(cfg, params, prompts, gen=12,
                   tpl=default_template("cuda", device=args.device))
    print("sampled continuations:")
    for row in out:
        print("  ", row.tolist())
    return losses, out


if __name__ == "__main__":
    main()
