"""LeNet on the unified compute unit with Qm.n quantization-aware training,
deployed on the grid-resident QTensor path.

    PYTHONPATH=src python -m repro_torch.examples.train_lenet_q214 [--fmt q17]
    PYTHONPATH=src python -m repro_torch.examples.train_lenet_q214 --device cpu

The port's copy of the reference's ``examples/train_lenet_q214.py``, the
paper's deployment story in miniature, in four stages:

  1. train float: conv and FC layers through the template's compute unit on
     the ``torch`` backend (autograd; the reference trains on ``xla``);
  2. fine-tune with fake quantization (the straight-through estimator) on
     the chosen grid: Q2.14 trains activations into [-2, 2); ``--fmt q17``
     clamps them into [-1, 1) so the network is int8-ready on the Q1.7 rung;
  3. deploy on the ``q16`` template: calibrate the activation grid from one
     batch, quantize the weights once into QTensors, and run the whole
     network in fixed point on the kernels (the card's conv and GEMM
     kernels; their plain versions with ``--device cpu``): one quantize
     (the input) and one dequantize (the classifier's read-out) a forward;
  4. the precision DSE: each layer's drift against the fake-quant forward,
     and every layer that tolerates it dropped to the int8 rung.

``--float-steps`` / ``--qat-steps`` / ``--batch`` shrink the run (the
reference's 60 / 30 / 32 by default).  :func:`main` returns the run's
results (losses, the trained weights, the policies and the deployed
logits) for a caller that holds them to something else.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.quantization import Q1_7, Q2_14
from repro_torch.core.template import default_template
from repro_torch.data.pipeline import synthetic_images
from repro_torch.models.cnn import (
    LENET,
    calibrate_cnn_policy,
    calibrate_cnn_precision,
    cnn_forward,
    init_cnn,
    quantize_cnn_params,
)
from repro_torch.optim import AdamW, adamw_init, adamw_update
from repro_torch.optim.tree import tree_flatten, tree_unflatten


def accuracy(tpl, params, step0, dev, n=4, quantized=False, fmt=Q2_14):
    hits = tot = 0
    with torch.no_grad():
        for s in range(n):
            img, lab = synthetic_images(99, step0 + s, 32, LENET.input_hw, LENET.input_ch,
                                        LENET.n_classes, device=dev)
            logits = cnn_forward(tpl, LENET, params, img, quantized=quantized, fmt=fmt)
            hits += int((torch.argmax(logits, -1) == lab).sum())
            tot += lab.shape[0]
    return hits / tot


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", choices=["q214", "q17"], default="q214",
                    help="fake-quant grid for the QAT fine-tune: q214 trains "
                         "activations into [-2,2), q17 into [-1,1)")
    ap.add_argument("--float-steps", type=int, default=60)
    ap.add_argument("--qat-steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where it runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    fq = Q1_7 if args.fmt == "q17" else Q2_14

    tpl = default_template("torch", device=args.device)
    dev = tpl.engine.device
    params = init_cnn(torch.Generator().manual_seed(0), LENET, scale=0.4, device=dev)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    opt_state = adamw_init(params)

    def train_step(p, o, img, lab, quantized):
        leaves, treedef = tree_flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        logits = cnn_forward(tpl, LENET, tree_unflatten(treedef, live), img,
                             quantized=quantized, fmt=fq)
        onehot = torch.nn.functional.one_hot(lab, LENET.n_classes).to(torch.float32)
        loss = -(onehot * torch.log_softmax(logits.to(torch.float32), -1)).sum(-1).mean()
        grads = tree_unflatten(treedef, torch.autograd.grad(loss, live))
        p, o, _ = adamw_update(opt, grads, o, p)
        return p, o, loss.detach()

    float_losses, qat_losses = [], []
    print("phase 1: float training")
    for step in range(args.float_steps):
        img, lab = synthetic_images(0, step, args.batch, 32, 1, 10, device=dev)
        params, opt_state, l = train_step(params, opt_state, img, lab, False)
        float_losses.append(float(l))
        if step % 20 == 0:
            print(f"  step {step:3d} loss {float(l):.4f}")

    print(f"phase 2: {fq.name} quantization-aware fine-tune (STE)")
    for step in range(args.float_steps, args.float_steps + args.qat_steps):
        img, lab = synthetic_images(0, step, args.batch, 32, 1, 10, device=dev)
        params, opt_state, l = train_step(params, opt_state, img, lab, True)
        qat_losses.append(float(l))
    if qat_losses:
        print(f"  final QAT loss {qat_losses[-1]:.4f}")

    acc_f = accuracy(tpl, params, 1000, dev, quantized=False)
    acc_q = accuracy(tpl, params, 1000, dev, quantized=True, fmt=fq)
    print(f"\naccuracy float={acc_f:.2%}  fake-quant {fq.name}={acc_q:.2%}")

    # deployment numerics: calibrate once, quantize weights once, then run
    # the whole network grid-resident in int16 (the QTensor path)
    tpl_q16 = default_template("q16", device=args.device)
    cal_img, _ = synthetic_images(7, 0, 16, 32, 1, 10, device=dev)
    policy = calibrate_cnn_policy(tpl_q16, LENET, params, cal_img)
    qparams = quantize_cnn_params(tpl_q16, LENET, params, policy)
    print(f"\ndeploy: activations on {policy.fmt.name} (max-abs calibrated), "
          f"weights per-tensor Qm.n, quantized once")

    eng = tpl_q16.engine
    q0, d0 = eng.counters["quantize_calls"], eng.counters["dequantize_calls"]
    img, lab = synthetic_images(99, 2000, 16, 32, 1, 10, device=dev)
    with torch.no_grad():
        lf = cnn_forward(tpl, LENET, params, img, quantized=True, fmt=fq)
    lq = cnn_forward(tpl_q16, LENET, qparams, img, policy=policy)
    islands = (eng.counters["quantize_calls"] - q0, eng.counters["dequantize_calls"] - d0)
    agree = float((torch.argmax(lf, -1) == torch.argmax(lq, -1)).float().mean())
    print(f"grid-resident q16 vs float-backend argmax agreement: {agree:.2%} "
          f"(max |logit diff| {float((lf - lq).abs().max()):.4f})")
    print(f"float islands crossed per forward: {islands[0]} quantize / {islands[1]} "
          f"dequantize (input + classifier read-out only)")

    # quantize-once: a second call reuses the cached qparams
    b0 = eng.counters["qparam_builds"]
    qparams2 = quantize_cnn_params(tpl_q16, LENET, params, policy)
    assert qparams2 is qparams and eng.counters["qparam_builds"] == b0
    print(f"qparam cache: {eng.counters['qparam_builds']} build(s), "
          f"{eng.counters['qparam_cache_hits']} hit(s) — weights quantized once")

    # precision DSE: the QAT clamp is part of the trained model, so the
    # fake-quant forward is the accuracy reference
    ref = torch.argmax(lf, -1)
    mixed = calibrate_cnn_precision(tpl_q16, LENET, params, img, budget=0.99,
                                    policy=policy, ref=ref)
    plan = dict(mixed.layer_fmts)
    int8 = sorted(n for n, f in plan.items() if f.total_bits == 8)
    print(f"\nprecision DSE (budget 0.99): base {mixed.fmt.name}, "
          f"{len(int8)}/{len(plan)} layers on the int8 rung -> "
          f"{ {n: f.name for n, f in sorted(plan.items())} }")
    lm = None
    if int8:
        lm = cnn_forward(tpl_q16, LENET, quantize_cnn_params(tpl_q16, LENET, params, mixed),
                         img, policy=mixed)
        am = float((torch.argmax(lf, -1) == torch.argmax(lm, -1)).float().mean())
        print(f"mixed int8/int16 argmax agreement vs fake-quant ref: {am:.2%}")
    return {"float_losses": float_losses, "qat_losses": qat_losses, "params": params,
            "accuracy": {"float": acc_f, "fake_quant": acc_q}, "policy": policy,
            "qparams": qparams, "images": img, "fake_quant_logits": lf, "grid_logits": lq,
            "argmax_agreement": agree, "islands": islands, "mixed": mixed,
            "mixed_logits": lm}


if __name__ == "__main__":
    main()
