"""The training step, in the port.

The port's copy of the train half of ``repro.launch.steps``:
:func:`make_train_step` and :func:`default_optimizer`.  (The reference's
abstract specs, shardings and per-cell GEMM plans serve its dry-run
tooling, ROADMAP queue 1 item 8.)

The step differentiates ``models.transformer.loss_fn`` with autograd on the
``torch`` template, the port's counterpart of the reference's ``xla``
backend, on which the reference trains: its Pallas kernels have no VJP, and
the port's CUDA kernels are launched through ``ctypes``, outside autograd.
A ``cuda`` or ``q16`` template is refused: on the card every
kernel-computed leaf would silently get no gradient, while on the CPU (the
kernels' plain versions) it would seem to train.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.template import Template, default_template
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_update, cosine_warmup
from repro_torch.optim.tree import tree_flatten, tree_unflatten

__all__ = ["make_train_step", "default_optimizer", "loss_and_grads"]


def default_optimizer(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=cosine_warmup(3e-4, min(2000, total_steps // 10 + 1), total_steps))


def _check_template(tpl: Template) -> Template:
    """``tpl`` if autograd can differentiate it (the ``torch`` backend),
    else a ValueError naming why not."""
    backend = tpl.config.backend
    if backend != "torch":
        raise ValueError(
            f"training runs on the 'torch' template (plain tensor ops, the reference's "
            f"'xla' backend); a {backend!r} template launches kernels that autograd "
            f"cannot differentiate (the reference's Pallas backend has no VJP either), "
            f"so the grads of every kernel-computed leaf would be missing")
    return tpl


def loss_and_grads(tpl, cfg, params, batch):
    """(loss, metrics, grads) of ``models.transformer.loss_fn`` at
    ``params`` (a tree of plain tensors), by autograd; grads in each
    parameter's dtype, zeros for a leaf the loss does not reach."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = T.loss_fn(tpl, cfg, tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


def make_train_step(cfg, tpl: Optional[Template] = None, opt: Optional[AdamW] = None,
                    accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum`` > 1 splits the global batch into ``accum`` microbatches (rows
    in order) and sums their grads in f32, then averages: the activation
    memory of one microbatch.  Metrics: "loss", "ce", "aux", "grad_norm",
    "lr", 0-d tensors on the device (nothing is read back to the host).
    ``tpl`` defaults to ``default_template("torch")`` on the card."""
    tpl = _check_template(tpl or default_template("torch"))
    opt = opt or default_optimizer()

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(tpl, cfg, params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % accum:
                raise ValueError(f"a batch of {rows} rows does not split into {accum} "
                                 f"microbatches")
            mb = rows // accum
            flat, treedef = tree_flatten(params)
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            auxsum = torch.zeros_like(lsum)
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, m, g = loss_and_grads(tpl, cfg, params, micro)
                for acc, gi in zip(gsum, tree_flatten(g)[0]):
                    acc.add_(gi.to(torch.float32))
                del g
                lsum, auxsum = lsum + l, auxsum + m["aux"]
            grads = tree_unflatten(treedef, [acc.div_(accum) for acc in gsum])
            loss = lsum / accum
            metrics = {"ce": loss, "aux": auxsum / accum}
        new_params, new_opt, om = adamw_update(opt, grads, opt_state, params)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step
