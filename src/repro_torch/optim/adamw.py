"""AdamW with global-norm clipping, in the port.

The port's copy of ``repro.optim.adamw``: plain functions on the parameter
tree (no ``torch.optim``).  The moments m and v mirror the parameter tree
in f32 whatever the parameters' dtype; the step counter is a 0-d int32
tensor on the parameters' device, so the learning-rate schedule and the
bias corrections (``b ** step`` in f32) are evaluated there, with no host
read.  Weight decay applies only to leaves of rank 2 or more; clipping
scales every gradient by ``min(1, clip / max(gnorm, 1e-9))`` cast to the
gradient's dtype.  The update runs under ``torch.no_grad()`` and returns
new tensors (the caller drops the old ones, as the reference's donated
buffers are dropped).

On a mesh (a data-parallel / FSDP training step under ``use_mesh``) every
leaf is this rank's shard: the moments and the new parameters carry the
parameters' shard marks, and :func:`global_norm` sums each leaf's squares
over the axes it is sharded on, so the clip scale and the update act on
shards unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.parallel import sharding as sh

from .tree import tree_flatten, tree_leaves, tree_leaves_like, tree_map, tree_unflatten

__all__ = ["AdamW", "OptState", "adamw_init", "adamw_update", "global_norm"]


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> OptState:
        return adamw_init(params)

    def update(self, grads, state: OptState, params):
        return adamw_update(self, grads, state, params)


def adamw_init(params) -> OptState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: sh.carry_marks(p, torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device))
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf.  Under an active mesh a leaf with
    shard marks adds its local squares summed over the axes it is sharded
    on (one sum a distinct set of axes); a replicated leaf is counted once,
    as it is."""
    leaves = tree_leaves(tree)
    mesh = sh.active_mesh()
    total = 0.0
    if mesh is None or not any(sh.shard_marks(g) for g in leaves):
        for g in leaves:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    sharded = {}
    for g in leaves:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = tuple(a for _, ax, _ in sh.shard_marks(g)
                     for a in ((ax,) if isinstance(ax, str) else ax))
        if axes:
            sharded[axes] = sharded.get(axes, 0.0) + sq
        else:
            total = total + sq
    for axes, sq in sharded.items():
        total = total + sh.psum(sq, axes, mesh)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(opt: AdamW, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if opt.clip_norm is not None:
        scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    lr = (opt.lr(step) if callable(opt.lr)
          else torch.full((), opt.lr, dtype=torch.float32, device=step.device))
    b1, b2 = opt.b1, opt.b2
    s32 = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, s32)
    c2 = 1.0 - torch.pow(b2, s32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + opt.eps)
        if opt.weight_decay and p.ndim >= 2:  # decay matrices only
            delta = delta + opt.weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return tuple(sh.carry_marks(p, t) for t in (new, m_new, v_new))

    flat_p, treedef = tree_flatten(params)
    flat = zip(flat_p, *(tree_leaves_like(params, t) for t in (grads, state.m, state.v)))
    out = [upd(p, g, m, v) for p, g, m, v in flat]
    new_p = tree_unflatten(treedef, [o[0] for o in out])
    new_m = tree_unflatten(treedef, [o[1] for o in out])
    new_v = tree_unflatten(treedef, [o[2] for o in out])
    return new_p, OptState(step=step, m=new_m, v=new_v), {"grad_norm": gnorm, "lr": lr}
