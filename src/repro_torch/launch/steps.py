"""The training step and the training state's shardings, in the port.

The port's copy of the train half of ``repro.launch.steps``:
:func:`make_train_step`, :func:`default_optimizer`, :func:`state_shardings`
and :func:`batch_shardings`.  (The reference's other abstract specs, its
cache shardings and per-cell GEMM plans serve its dry-run tooling, ROADMAP
queue 1 item 8.)

The step differentiates ``models.transformer.loss_fn`` with autograd on the
``torch`` template, the port's counterpart of the reference's ``xla``
backend, on which the reference trains: its Pallas kernels have no VJP, and
the port's CUDA kernels are launched through ``ctypes``, outside autograd.
A ``cuda`` or ``q16`` template is refused: on the card every
kernel-computed leaf would silently get no gradient, while on the CPU (the
kernels' plain versions) it would seem to train.

With ``mesh=`` the step is one rank's part of the step under
``TRAIN_RULES`` (batch over ("pod", "data"), "embed" over "data", the
heads, qkv, mlp, vocab, experts, ssm_inner and rec dims and the residual
stream's sequence over "model"): the params and the optimizer state are
this rank's shards (:func:`state_shardings`), the batch its rows
(``DataPipeline`` with the same mesh, rules and ``accum``; ranks that
share a data coordinate hold the same rows).  FSDP shards are gathered
where the model uses them and their grads come back reduce-scattered
through the gather's backward; over "model" the layers' seams gather the
sequence for the column-parallel projections and reduce-scatter the
row-parallel outputs, each with its adjoint in the backward.  A rank's
loss is its part over the batch axes and the sequence's; the leaves those
axes replicate get ``grad_all_reduce``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core.template import Template, default_template
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, OptState, adamw_update, cosine_warmup
from repro_torch.optim.tree import tree_flatten, tree_unflatten
from repro_torch.parallel import sharding as sh

__all__ = ["make_train_step", "default_optimizer", "loss_and_grads", "abstract_params",
           "state_shardings", "batch_shardings", "check_train_mesh"]


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


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def abstract_params(cfg):
    """``init_params``' tree as shapes only: fake tensors, nothing allocated
    or drawn (no generator lives on the "meta" device, and a host
    generator draws a 0.5 B model for seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return T.init_params(torch.Generator(), cfg)


def state_shardings(cfg, mesh, rules: sh.ShardingRules):
    """(param_shardings, opt_shardings) NamedSharding trees: each leaf by
    its ``param_axes`` under ``rules`` and the drop rule; the optimizer's
    step replicated, its moments as the params."""
    p_sh = sh.tree_shardings(mesh, rules, abstract_params(cfg), T.param_axes(cfg))
    return p_sh, OptState(step=sh.NamedSharding(mesh, sh.PartitionSpec()), m=p_sh, v=p_sh)


def _input_shapes(cfg, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": (b, s), "labels": (b, s)}
    if cfg.family == "encdec":
        out["ctx"] = (b, cfg.n_frames, cfg.d_model)
    elif cfg.family == "vlm":
        out["ctx"] = (b, cfg.n_image_tokens, cfg.d_model)
    return out


def batch_shardings(cfg, shape, mesh, rules: sh.ShardingRules) -> dict:
    """NamedShardings of a training batch of ``shape`` (a ``ShapeSpec``):
    tokens and labels ("batch", None), a context ("batch", "ctx", None)."""
    shapes = {k: torch.empty(v, device="meta") for k, v in _input_shapes(cfg, shape).items()}
    axes = {k: ("batch", "ctx", None) if k == "ctx" else ("batch", None) for k in shapes}
    return sh.tree_shardings(mesh, rules, shapes, axes)


def check_train_mesh(mesh, rules: sh.ShardingRules) -> None:
    """Raise unless ``mesh`` has ranks and every axis of it of size above 1
    is one the rules train over: a batch axis, or the axis the rules shard
    the sequence over ("model", tensor parallelism with sequence-parallel
    activations)."""
    if not mesh.has_groups:
        raise ValueError(f"a meshed train step runs on ranks (spawn_ranks); {mesh} is a "
                         f"layout only")
    known = set(sh.loss_axes(mesh, rules))
    wide = [a for a in mesh.axis_names if a not in known and mesh.shape[a] > 1]
    if wide:
        raise ValueError(
            f"training on {mesh} under these rules shards over {wide}, which the rules "
            f"use neither for the batch nor for the sequence (seq_act)")


@contextlib.contextmanager
def _on_mesh(mesh, rules):
    """Yields the loss's axes (``sharding.loss_axes``: the batch axes, then
    the sequence's): under ``use_mesh`` and ``batch_split`` over the batch
    axes when ``mesh`` is given, else () with nothing entered."""
    if mesh is None:
        yield ()
        return
    with sh.use_mesh(mesh, rules):
        with sh.batch_split(sh.axis_size(mesh, sh.batch_axes())):
            yield sh.loss_axes()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _loss_and_grads(tpl, cfg, params, batch):
    """This rank's (loss, metrics, grads): on a mesh its part of the global
    mean and of each grad (an FSDP leaf's summed already)."""
    leaves, treedef = tree_flatten(params)
    live = [sh.carry_marks(p, p.detach().requires_grad_(True)) for p in leaves]
    with torch.enable_grad():
        loss, metrics = T.loss_fn(tpl, cfg, tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [sh.carry_marks(p, torch.zeros_like(p) if g is None else g)
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


def _reduce(axes, loss, metrics, grads):
    """The global loss, metrics and grads from this rank's parts: the grads
    of the leaves an axis of the loss replicates all-reduced, the scalars
    summed."""
    if not axes:
        return loss, metrics, grads
    grads = sh.grad_all_reduce(grads, axes)
    names = sorted(metrics)
    total = sh.psum(torch.stack([loss.float()] + [metrics[k].float() for k in names]), axes)
    return total[0], dict(zip(names, total[1:])), grads


def _accumulated(tpl, cfg, params, batch, accum: int):
    """This rank's (loss, metrics, grads) over ``accum`` microbatches (rows
    in order): grads summed in f32, then averaged, as the reference's scan
    does."""
    if accum == 1:
        return _loss_and_grads(tpl, cfg, params, batch)
    rows = batch["tokens"].shape[0]
    if rows % accum:
        raise ValueError(f"a batch of {rows} rows does not split into {accum} microbatches")
    mb = rows // accum
    flat, treedef = tree_flatten(params)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    auxsum = torch.zeros_like(lsum)
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, m, g = _loss_and_grads(tpl, cfg, params, micro)
        for acc, gi in zip(gsum, tree_flatten(g)[0]):
            acc.add_(gi.to(torch.float32))
        del g
        lsum, auxsum = lsum + l, auxsum + m["aux"]
    grads = tree_unflatten(treedef, [sh.carry_marks(p, acc.div_(accum))
                                     for p, acc in zip(flat, gsum)])
    loss = lsum / accum
    return loss, {"ce": loss, "aux": auxsum / accum}, grads


def loss_and_grads(tpl, cfg, params, batch, *, accum: int = 1, mesh=None, rules=None):
    """(loss, metrics {"ce", "aux"}, grads) of ``models.transformer.loss_fn``
    at ``params`` (a tree of plain tensors), by autograd; grads in each
    parameter's dtype (f32 when ``accum`` > 1 splits the batch into
    microbatches), zeros for a leaf the loss does not reach.  With ``mesh``
    (``rules`` default ``TRAIN_RULES``): this rank's shards of the global
    batch's grads from its rows of the batch (see :func:`make_train_step`),
    and the global loss and metrics."""
    if mesh is not None:
        rules = rules or sh.TRAIN_RULES
        check_train_mesh(mesh, rules)
    with _on_mesh(mesh, rules) as axes:
        return _reduce(axes, *_accumulated(tpl, cfg, params, batch, accum))


def make_train_step(cfg, tpl: Optional[Template] = None, opt: Optional[AdamW] = None,
                    accum: int = 1, *, mesh=None, rules: Optional[sh.ShardingRules] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum`` > 1 splits the batch into ``accum`` microbatches (rows in
    order) and sums their grads in f32, then averages: the activation
    memory of one microbatch.  Metrics: "loss", "ce", "aux", "grad_norm",
    "lr", 0-d tensors on the device (nothing is read back to the host).
    ``tpl`` defaults to ``default_template("torch")`` on the card.

    ``mesh`` (a mesh with ranks; ``rules`` default ``TRAIN_RULES``): this
    rank's step on its shards of the params and optimizer state and its
    rows of the batch, its microbatch i being its rows of the logical
    microbatch i (``DataPipeline(accum=)`` lays them out so); the metrics
    are the global step's on every rank."""
    tpl = _check_template(tpl or default_template("torch"))
    opt = opt or default_optimizer()
    if mesh is not None:
        rules = rules or sh.TRAIN_RULES
        check_train_mesh(mesh, rules)

    def train_step(params, opt_state, batch):
        with _on_mesh(mesh, rules) as axes:
            loss, metrics, grads = _reduce(axes, *_accumulated(tpl, cfg, params, batch,
                                                               accum))
            new_params, new_opt, om = adamw_update(opt, grads, opt_state, params)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step
