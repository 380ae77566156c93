"""Step functions and abstract input / state specs, in the port: shared by
the dry-run (``launch/dryrun.py``), the training driver and the serving
driver.

The port's copy of ``repro.launch.steps``: the train, prefill and decode
steps; every input, parameter, optimizer-state and cache tree as shapes on
fake tensors (nothing allocated or drawn: qwen2.5-32b's ``long_500k`` cache
alone is terabytes); their :class:`~repro_torch.parallel.sharding.NamedSharding`
trees from the logical-axis rules; a cell's local GEMM plans
(:func:`cell_gemm_plans`) and the one-call assembly of a dry-run cell
(:func:`step_and_specs`).  Where the reference hands its cell to
``jax.jit(...).lower().compile()``, the port's dry-run reads the specs
directly: the port compiles nothing ahead of a call.

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
import dataclasses
from typing import Optional

import torch

from repro_torch.core.template import Template, default_template
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, OptState, adamw_init, adamw_update, cosine_warmup
from repro_torch.optim.tree import tree_flatten, tree_unflatten
from repro_torch.parallel import sharding as sh

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "input_specs",
           "default_optimizer", "loss_and_grads", "abstract_params", "abstract_opt_state",
           "abstract_cache", "state_shardings", "batch_shardings", "cache_shardings",
           "cell_gemm_plans", "CellSpec", "step_and_specs", "check_train_mesh"]


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
# abstract shapes (fake tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _ctx_shape(cfg, batch: int):
    if cfg.family == "encdec":
        return (batch, cfg.n_frames, cfg.d_model)
    if cfg.family == "vlm":
        return (batch, cfg.n_image_tokens, cfg.d_model)
    return None


def input_specs(cfg, shape) -> dict:
    """Fake-tensor stand-ins for every model input of a cell of ``shape`` (a
    ``ShapeSpec``).  decode: {token (b, 1), t ()} int32; train: {tokens,
    labels} (b, s) int32; prefill: {tokens}; train and prefill add ``ctx``
    f32 for an encoder-decoder or a VLM."""
    b = shape.global_batch
    with _fake():
        if shape.kind == "decode":
            return {"token": torch.empty((b, 1), dtype=torch.int32),
                    "t": torch.empty((), dtype=torch.int32)}
        specs = {"tokens": torch.empty((b, shape.seq_len), dtype=torch.int32)}
        if shape.kind == "train":
            specs["labels"] = torch.empty((b, shape.seq_len), dtype=torch.int32)
        ctx = _ctx_shape(cfg, b)
        if ctx is not None:
            specs["ctx"] = torch.empty(ctx, dtype=torch.float32)
    return specs


def abstract_params(cfg):
    """``init_params``' tree as shapes only: fake tensors, nothing allocated
    or drawn (no generator lives on the "meta" device, and a host
    generator draws a 0.5 B model for seconds)."""
    with _fake():
        return T.init_params(torch.Generator(), cfg)


def abstract_opt_state(cfg, params=None) -> OptState:
    """``adamw_init``'s state for :func:`abstract_params` (or the fake
    ``params`` given), as fake tensors."""
    params = abstract_params(cfg) if params is None else params
    with _fake():
        return adamw_init(params)


def abstract_cache(cfg, batch: int, cache_len: int):
    """``init_cache(cfg, batch, cache_len)`` as fake tensors."""
    with _fake():
        return T.init_cache(cfg, batch, cache_len)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def state_shardings(cfg, mesh, rules: sh.ShardingRules, params=None):
    """(param_shardings, opt_shardings) NamedSharding trees: each leaf by
    its ``param_axes`` under ``rules`` and the drop rule; the optimizer's
    step replicated, its moments as the params.  ``params``: the
    :func:`abstract_params` tree, when the caller has it."""
    params = abstract_params(cfg) if params is None else params
    p_sh = sh.tree_shardings(mesh, rules, params, T.param_axes(cfg))
    return p_sh, OptState(step=sh.NamedSharding(mesh, sh.PartitionSpec()), m=p_sh, v=p_sh)


def batch_shardings(cfg, shape, mesh, rules: sh.ShardingRules) -> dict:
    """NamedShardings of :func:`input_specs`: tokens, labels and a decode
    token ("batch", None), a context ("batch", "ctx", None), the decode
    position replicated."""
    specs = input_specs(cfg, shape)
    axes = {k: ("batch", "ctx", None) if k == "ctx" else None if k == "t" else ("batch", None)
            for k in specs}
    return sh.tree_shardings(mesh, rules, specs, axes)


def cache_shardings(cfg, cache_shapes, mesh, rules: sh.ShardingRules):
    """NamedShardings of a cache tree (:func:`abstract_cache`) by
    ``models.transformer.cache_axes``."""
    return sh.tree_shardings(mesh, rules, cache_shapes, T.cache_axes(cfg, cache_shapes))


def check_train_mesh(mesh, rules: sh.ShardingRules) -> None:
    """Raise unless ``mesh`` has ranks and every axis of it of size above 1
    is one the rules train over: a batch axis, or the axis the rules shard
    the sequence over ("model", tensor parallelism with sequence-parallel
    activations)."""
    if not mesh.has_groups:
        raise ValueError(f"a meshed train step runs on ranks (spawn_ranks); {mesh} is a "
                         f"layout only")
    _check_train_axes(mesh, rules)


def _check_train_axes(mesh, rules: sh.ShardingRules) -> None:
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

    ``mesh`` (``rules`` default ``TRAIN_RULES``): this rank's step on its
    shards of the params and optimizer state and its rows of the batch, its
    microbatch i being its rows of the logical microbatch i
    (``DataPipeline(accum=)`` lays them out so); the metrics are the global
    step's on every rank.  The step runs on a mesh with ranks; a layout
    (the dry-run's production meshes) builds it, and running it raises."""
    tpl = _check_template(tpl or default_template("torch"))
    opt = opt or default_optimizer()
    if mesh is not None:
        rules = rules or sh.TRAIN_RULES
        _check_train_axes(mesh, rules)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            check_train_mesh(mesh, rules)
        with _on_mesh(mesh, rules) as axes:
            loss, metrics, grads = _reduce(axes, *_accumulated(tpl, cfg, params, batch,
                                                               accum))
            new_params, new_opt, om = adamw_update(opt, grads, opt_state, params)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step


def make_prefill_step(cfg, tpl: Optional[Template] = None, cache_len: Optional[int] = None):
    """(params, batch {tokens [, ctx]}) -> (last-position logits, the filled
    decode cache) through ``models.transformer.prefill``; ``tpl`` defaults
    to ``default_template()`` (the card's ``cuda`` backend)."""
    tpl = tpl or default_template()

    def prefill_step(params, batch):
        return T.prefill(tpl, cfg, params, batch["tokens"], ctx=batch.get("ctx"),
                         cache_len=cache_len)

    return prefill_step


def make_decode_step(cfg, tpl: Optional[Template] = None):
    """(params, cache, batch {token, t}) -> (logits, new cache) through
    ``models.transformer.decode_step``."""
    tpl = tpl or default_template()

    def decode_step(params, cache, batch):
        return T.decode_step(tpl, cfg, params, batch["token"], batch["t"], cache)

    return decode_step


# ---------------------------------------------------------------------------
# sharding-aware GEMM planning for a cell
# ---------------------------------------------------------------------------


def cell_gemm_plans(cfg, shape, mesh, rules: sh.ShardingRules,
                    tpl: Optional[Template] = None) -> dict:
    """The cell's dominant GEMMs planned at their local per-shard shapes:
    {qkv, attn_out, mlp_up, mlp_down, lm_head: GemmPlan}.

    M is the cell's tokens, sharded by the rules' "batch"; N by each
    projection's own logical axis ("qkv" / "mlp" / "vocab"); attn_out and
    mlp_down contract over the sharded heads / ff dim.  Each plan is
    ``Engine.plan_gemm(mesh=, partition=)`` in the config's dtype: under
    ``H100`` the route and tile a rank runs (with the logical shape's k
    order), under ``TPU_V5E`` the reference's plans; the ``torch`` backend
    records the local geometry with no block.  Where a shard cannot take its
    logical shape's route (a column shard the tensor cores cannot address,
    which the engine refuses at run time), the projection's entry is the
    planner's refusal, a string."""
    tpl = tpl or default_template()
    eng = tpl.engine
    m, d = shape.tokens, cfg.d_model
    dtype = T._dtype(cfg.dtype)

    def plan(n, k, n_axis=None, k_axis=None):
        part = sh.PartitionSpec(rules.get("batch"), rules.get(n_axis) if n_axis else None,
                                rules.get(k_axis) if k_axis else None)
        try:
            return eng.plan_gemm(m, n, k, mesh=mesh, partition=part, dtype=dtype)
        except ValueError as e:
            return str(e)

    return {
        "qkv": plan((cfg.eff_heads + 2 * cfg.n_kv_heads) * cfg.head_dim, d, n_axis="qkv"),
        "attn_out": plan(d, cfg.eff_heads * cfg.head_dim, k_axis="qkv"),
        "mlp_up": plan(cfg.d_ff, d, n_axis="mlp"),
        "mlp_down": plan(d, cfg.d_ff, k_axis="mlp"),
        "lm_head": plan(cfg.vocab, d, n_axis="vocab"),
    }


# ---------------------------------------------------------------------------
# one-call assembly for a dry-run cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellSpec:
    """Everything one (arch x shape x mesh) cell's step takes: the step, its
    arguments as fake tensors, in order, and their NamedSharding trees."""

    step_fn: object
    args: tuple
    in_shardings: tuple
    out_shardings: object
    donate_argnums: tuple
    kind: str
    #: local per-shard GemmPlans of the cell's dominant projections
    #: (qkv / attn_out / mlp_up / mlp_down / lm_head), from cell_gemm_plans
    gemm_plans: dict = dataclasses.field(default_factory=dict)


def step_and_specs(cfg, shape, mesh, rules: sh.ShardingRules, accum: int = 1,
                   tpl: Optional[Template] = None) -> CellSpec:
    """One cell's step, abstract arguments and shardings.  ``tpl`` goes to
    the step and to the cell's GEMM planning; a train cell's step is
    :func:`make_train_step` on ``mesh`` (built on a layout, run on ranks),
    whose template must be the ``torch`` backend.  Outputs: a train step's
    params and optimizer state as its inputs, its metrics replicated; a
    prefill's or decode's cache by :func:`cache_shardings`, its logits
    unconstrained (None)."""
    repl = sh.NamedSharding(mesh, sh.PartitionSpec())
    specs = input_specs(cfg, shape)
    b_sh = batch_shardings(cfg, shape, mesh, rules)
    p_shapes = abstract_params(cfg)
    p_sh, o_sh = state_shardings(cfg, mesh, rules, p_shapes)
    plans = cell_gemm_plans(cfg, shape, mesh, rules, tpl)
    if shape.kind == "train":
        metrics = dict.fromkeys(("ce", "aux", "grad_norm", "lr", "loss"), repl)
        return CellSpec(step_fn=make_train_step(cfg, tpl=tpl, accum=accum, mesh=mesh,
                                                rules=rules),
                        args=(p_shapes, abstract_opt_state(cfg, p_shapes), specs),
                        in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, metrics),
                        donate_argnums=(0, 1), kind="train", gemm_plans=plans)
    c_shapes = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    c_sh = cache_shardings(cfg, c_shapes, mesh, rules)
    if shape.kind == "prefill":
        return CellSpec(step_fn=make_prefill_step(cfg, tpl=tpl, cache_len=shape.seq_len),
                        args=(p_shapes, specs), in_shardings=(p_sh, b_sh),
                        out_shardings=(None, c_sh), donate_argnums=(), kind="prefill",
                        gemm_plans=plans)
    return CellSpec(step_fn=make_decode_step(cfg, tpl=tpl), args=(p_shapes, c_shapes, specs),
                    in_shardings=(p_sh, c_sh, b_sh), out_shardings=(None, c_sh),
                    donate_argnums=(1,), kind="decode", gemm_plans=plans)
