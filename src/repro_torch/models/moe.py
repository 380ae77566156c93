"""Mixture-of-Experts FFN with grouped capacity-based dispatch (GShard style),
in the port.

The port's copy of ``repro.models.moe``.  Tokens split into groups of
``cfg.moe_group``; each group routes its tokens top-k over the experts, and
each expert takes at most ``cap`` tokens a group (``capacity_factor``),
queued choice-major (every first choice before any second choice); a
token that overflows loses that choice (the residual path keeps it).  The
dispatch and combine tensors are dense (G, S, E, C) one-hots, so the whole
routing is fixed-shape tensor work: no host sync, no boolean indexing, no
``nonzero``, and a decode step that holds an MoE layer captures into one
CUDA graph.

The expert FFNs are GEMMs on the template's compute unit: on the ``cuda``
and ``q16`` backends one ``tpl.matmul`` per (group, expert), as the
reference's ``vmap`` of ``tpl.matmul`` over (group, expert) issues them; on
``torch`` one batched ``einsum`` a projection, as the reference's ``xla``
branch.  The per-(group, expert) loop costs G·E·3 launches a layer (a
grouped launch over (group, expert) is a later lever).  Routing, dispatch
and combine are plain tensor ops (the "PS plane").

On a rank whose rows are a part of the logical batch (``sharding.batch_split``
above 1: a data-parallel training step, a data-split decode step) the
groups are the logical batch's: the group size reads the batch's token
count.  A rank that holds whole groups routes them alone, and its aux loss
is its sum over its groups over the batch's group count.  Where a group
spans ranks (a decode step: a few slots a rank, one group over the batch)
the tokens are gathered over the batch axes, every data rank routes and
dispatches the whole groups as one device does and keeps its own rows of
the combine, so capacity drops are the single device's; a training step
(autograd recording) must hold whole groups instead (a ValueError).

Under column-parallel decode rules (``DECODE_RULES``) the expert weights
are cut by the columns they produce: with ``expert_mlp`` over "model"
gate / up hold a column shard of the hidden, which is gathered before down
contracts it, so every contraction stays whole; with ``embed`` over
"model" down holds a column shard of the output, gathered by the caller's
seam.  Under ``SERVE_RULES`` with granite-moe's serve overrides
(``expert_mlp`` over "model") the rules' own layout cuts down's rows too:
the hidden's shard contracts against the rank's rows (a row-parallel
down), and the combine's output is a partial sum over "model", reduced by
the caller's seam.  With experts over "model" (phi3.5-moe) and the weights
in the rules' layout a rank runs its experts: the dispatched inputs and
the combine weights are cut to them, and the combine is a partial sum.

Under tensor-parallel training (``TRAIN_RULES`` with "model" above 1) a
sequence-parallel input is gathered whole first and the routing runs
replicated over "model" (the aux loss a rank returns is its share, the
whole over the axis size).  The rules then cut the expert work: experts
over "model" (phi3.5-moe: expert parallelism, each rank its experts) or,
by granite-moe's ``rule_overrides``, ``expert_cap`` over "model" (each rank
its capacity slots of every expert); the combine over a rank's share is a
partial sum, which the caller's seam reduce-scatters onto the sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh

from .layers import init_dense, init_normal

__all__ = ["init_moe", "moe_axes", "moe_ffn", "moe_ffn_dense_ref"]


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32, *, lead: tuple = (),
             shardings=None):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(name, shape, scale):
        return init_normal(gen, shape, scale, dtype, lead=lead,
                           sharding=sh.subtree(shardings, name))

    return {
        "router": init_dense(gen, d, e, dtype=torch.float32, lead=lead,
                             shardings=sh.subtree(shardings, "router")),
        "gate": experts("gate", (e, d, ff), d ** -0.5),
        "up": experts("up", (e, d, ff), d ** -0.5),
        "down": experts("down", (e, ff, d), ff ** -0.5),
    }


def moe_axes(cfg) -> dict:
    return {
        "router": {"w": ("embed", None)},
        "gate": ("experts", "embed", "expert_mlp"),
        "up": ("experts", "embed", "expert_mlp"),
        "down": ("experts", "expert_mlp", "embed"),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(cfg, router_w, xt):
    """Top-k routing for flat token groups.  xt: (G, S, d).  Returns (gates
    (G,S,k) normalized, idx (G,S,k), probs (G,S,E))."""
    # the logits accumulate in f64 and round once to f32: an f32 sum's order
    # (the CPU BLAS's or cuBLAS's, against XLA's) moves logits of magnitude
    # ~20 by several ulps, and the top-k gates with them
    logits = torch.einsum("gsd,de->gse", xt.to(torch.float64),
                          router_w.to(torch.float64)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _split() -> int:
    """How many ranks' rows make up the logical batch (1 off a mesh)."""
    return sh.active_batch_split() if sh.active_mesh() is not None else 1


def _group_size(cfg, tokens: int) -> int:
    """The tokens of one routing group, for a logical batch of ``tokens``."""
    return min(getattr(cfg, "moe_group", 512) or 512, tokens)


def _groups(cfg, x):
    """(B, S, d) -> the padded token groups (G, S_g, d), the token count and
    the capacity a group gives each expert.  The group size reads the
    logical batch's token count (this rank's times :func:`_split`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    sg = _group_size(cfg, t * _split())
    xt = x.reshape(t, d)
    pad = (-t) % sg
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xt = xt.reshape(-1, sg, d)
    cap = min(int(max(k, -(-sg * k // e) * cfg.capacity_factor)), sg)
    return xt, t, cap


def _queue_positions(cfg, idx):
    """Each (token, choice)'s place in its expert's queue, choice-major (all
    first choices queue before any second choice), and the one-hots of the
    choices (G, S, k, E)."""
    g, sg, k = idx.shape
    e = cfg.n_experts
    onehot = _one_hot(idx, e, torch.int32)  # (G, S, k, E)
    cm = onehot.permute(0, 2, 1, 3)  # (G, k, S, E) choice-major
    cum = torch.cumsum(cm.reshape(g, k * sg, e), dim=1).reshape(g, k, sg, e)
    pos = (cum - cm).permute(0, 2, 1, 3)  # back to (G, S, k, E)
    return (pos * onehot).sum(-1), onehot


def _cols(w) -> tuple:
    """The shard mark of ``w``'s columns (its last dim), which the output of
    a GEMM by ``w`` takes; marks count dims from the end, so an expert's
    slice ``w[e]`` keeps it."""
    return tuple(mk for mk in sh.shard_marks(w) if mk[0] == -1)


def _whole_groups(tpl: Template, cfg, p, x: torch.Tensor, split: int):
    """:func:`moe_ffn` of a rank whose rows are a part of groups that span
    ranks (a data-split decode step: a few slots a rank, one group over the
    batch): the tokens are gathered over the batch axes, every data rank
    routes and dispatches the whole groups as one device does, and keeps
    its own rows of the combine.  The aux loss is the rank's share."""
    axes = sh.batch_axes()
    whole = sh.gather(x, 0, axes)
    lo, hi = sh.local_rows(whole.shape[0], sh.active_mesh(), axes)
    with sh.batch_split(1):
        out, aux = moe_ffn(tpl, cfg, p, whole)
    return sh.carry_marks(out, out[lo:hi]), aux / split


def moe_ffn(tpl: Template, cfg, p, x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d), the Switch-style load-balancing aux loss)."""
    # the router and the groups read the logical tokens: a sequence shard is
    # gathered whole, and the routing runs replicated over its axes
    replicas = sh.axis_size(sh.active_mesh(), sh.seq_parallel_axes()) \
        if sh.active_mesh() is not None else 1
    x = sh.constrain(x, "batch", "seq", "act_embed")
    split = _split()
    t = x.shape[0] * x.shape[1]
    sg = _group_size(cfg, t * split)
    if split > 1 and t % sg:
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError(
                f"MoE groups of {sg} tokens: this rank holds {t} of the batch's "
                f"{t * split} tokens ({split} ranks), so a group would span two ranks; "
                f"a training step takes a multiple of {sg} tokens a rank")
        return _whole_groups(tpl, cfg, p, x, split)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt, t, cap = _groups(cfg, x)
    xt = sh.constrain(xt, "batch", None, "act_embed")
    g, sg = xt.shape[0], xt.shape[1]
    gates, idx, probs = _route(cfg, p["router"]["w"], xt)
    pos, onehot = _queue_positions(cfg, idx)
    keep = pos < cap

    # combine weights (G, S, E, C) built choice by choice (k is small), so
    # the (G, S, k, E, C) intermediate never exists
    dt = x.dtype
    combine = torch.zeros((g, sg, e, cap), dtype=dt, device=x.device)
    for j in range(k):
        oe = _one_hot(idx[:, :, j], e, dt)  # (G,S,E)
        oc = _one_hot(pos[:, :, j], cap, dt)  # (G,S,C); a dropped choice is all zeros
        w = (gates[:, :, j] * keep[:, :, j]).to(dt)  # (G,S)
        combine = combine + w[..., None, None] * oe[..., None] * oc[:, :, None, :]
    dispatch = (combine > 0).to(dt)
    # expert inputs (G, E, C, d), cut by the rules to this rank's work: its
    # experts (experts over "model", phi3.5) or its capacity slots of every
    # expert (expert_cap over "model", granite)
    ex_in = torch.einsum("gsec,gsd->gecd", dispatch, xt)
    ex_in = sh.constrain(ex_in, "batch", "experts", "expert_cap", None)
    combine = sh.constrain(combine, "batch", None, "experts", "expert_cap")
    # weights cut to this rank's experts (the rules' layout under
    # SERVE_RULES, whose activations the seams do not cut) take its share
    cut = [mk for mk in sh.shard_marks(p["gate"]) if mk[0] == -3]
    if cut and not any(mk[0] == -3 for mk in sh.shard_marks(ex_in)):
        ex_in = sh.take_shard(ex_in, 1, cut[0][1])
        combine = sh.take_shard(combine, 2, cut[0][1])

    # an expert GEMM's output takes the columns its weight holds: under
    # column-parallel decode rules gate / up hold a column shard of
    # expert_mlp (and down, under embed over "model", of embed); a hidden
    # that holds the expert_mlp rows a row-parallel down holds contracts
    # them into a partial sum over their axis (f32 on a kernel template)
    def bmm(a, w):
        rows = [mk for mk in sh.shard_marks(w) if mk[0] == -2]
        part = () if not rows else (rows[0][1],) if isinstance(rows[0][1], str) else rows[0][1]
        if tpl.config.backend == "torch":
            y = torch.einsum("gecd,edf->gecf", a, w.to(a.dtype))
        else:
            k_mark = tuple(mk for mk in sh.shard_marks(a) if mk[0] == -1)
            y = torch.stack([torch.stack([
                tpl.matmul(sh.mark_shard(a[gi, ei], k_mark), sh.carry_marks(w, w[ei]))
                for ei in range(a.shape[1])]) for gi in range(g)])
        return sh.mark_partial(sh.mark_shard(y, _cols(w)), part, a.dtype)

    h = F.silu(bmm(ex_in, p["gate"])) * bmm(ex_in, p["up"])
    h = sh.mark_shard(sh.carry_marks(ex_in, h), sh.shard_marks(ex_in) + _cols(p["up"]))
    h = sh.constrain(h, "batch", "experts", "expert_cap", "expert_mlp")
    down_rows = [mk for mk in sh.shard_marks(p["down"]) if mk[0] == -2]
    if down_rows:  # row-parallel down: the hidden on its expert_mlp shard
        hk = [mk for mk in sh.shard_marks(h) if mk[0] == -1]
        if not hk or hk[0][1] != down_rows[0][1]:
            h = sh.take_shard(sh.replicated(h, dims=(-1,)), -1, down_rows[0][1])
    else:  # a column shard of the hidden is gathered: down contracts it whole
        h = sh.replicated(h, dims=(-1,))
    ex_out = bmm(h, p["down"])

    # the combine contracts the experts and their slots: over a rank's
    # share of them the output is a partial sum over their axes (and over
    # a row-parallel down's)
    out = torch.einsum("gsec,gecd->gsd", combine.to(ex_out.dtype), ex_out)
    out = out.reshape(g * sg, out.shape[-1])[:t].reshape(b, s, out.shape[-1])
    part = sh.mark_axes(ex_in) + tuple(a for a in sh.partial_axes(ex_out)
                                       if a not in sh.mark_axes(ex_in))
    out = sh.mark_partial(sh.mark_shard(out, _cols(ex_out)), part, x.dtype)

    # Switch-style load-balancing aux loss (mean over the batch's groups)
    density = onehot.to(torch.float32).sum(2).mean(1)  # (G, E) routed fraction
    router_prob = probs.mean(1)  # (G, E)
    per_group = torch.sum(density * router_prob, dim=-1)
    aux = e * (torch.mean(per_group) if split == 1 else per_group.sum() / (g * split))
    if not sh.partial_axes(out):
        out = sh.carry_marks(out, out.to(x.dtype))
    return out, aux / replicas  # a partial sum takes x's dtype once reduced


def moe_ffn_dense_ref(cfg, p, x: torch.Tensor):
    """Oracle: every expert computed for every token, weighted by the same
    top-k gates with the same capacity-drop mask.  O(T·E·ff): tests only."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt, t, cap = _groups(cfg, x)
    g, sg = xt.shape[0], xt.shape[1]
    gates, idx, _ = _route(cfg, p["router"]["w"], xt)
    pos, _ = _queue_positions(cfg, idx)
    keep = pos < cap

    def expert(eid):
        h = F.silu(xt @ p["gate"][eid]) * (xt @ p["up"][eid])
        return h @ p["down"][eid]

    alle = torch.stack([expert(i) for i in range(e)], dim=2)  # (G,S,E,d)
    w = torch.zeros((g, sg, e), dtype=x.dtype, device=x.device)
    for j in range(k):
        oe = _one_hot(idx[:, :, j], e, x.dtype)
        w = w + (gates[:, :, j] * keep[:, :, j]).to(x.dtype)[..., None] * oe
    out = torch.einsum("gse,gsed->gsd", w, alle).reshape(g * sg, d)[:t]
    return out.reshape(b, s, d).to(x.dtype)
