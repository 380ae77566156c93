"""int8 gradient compression with error feedback, in the port.

The port's copy of ``repro.optim.compress``: per-tensor symmetric int8
quantization, the error-feedback state update (Seide et al., 1-bit SGD;
Karimireddy et al. 2019), and a data-parallel all-reduce whose wire format
is int8 plus one f32 scale per tensor.  The collectives run over the
process group of one axis of the port's :class:`~repro_torch.launch.mesh.Mesh`
(a mesh with groups, :meth:`Mesh.init_groups`): a ``MAX`` all-reduce of the
scales, then a ``SUM`` all-reduce of the int8 raws requantized against the
shared scale, carried as int32 partial sums.  Under ``gloo`` a CUDA tensor
is staged through the host, as the port's other collectives are.

A library: the training driver does not call it (its data-parallel
reduction is ``parallel.sharding.grad_all_reduce``, in f32; the reference's
driver has no compression flag either).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .tree import tree_flatten, tree_leaves_like, tree_map, tree_unflatten

__all__ = [
    "compress_int8",
    "decompress_int8",
    "apply_error_feedback",
    "init_error_feedback",
    "compressed_grad_reduce",
    "compressed_psum",
]


def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    g32 = g.to(torch.float32)
    absmax = torch.max(torch.abs(g32))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def apply_error_feedback(grads, ef_state, compress_fn, decompress_fn):
    """g' = C(g + e);  e' = (g + e) - g'.  Returns (compressed_grads, new_ef)."""

    def one(g, e):
        corrected = g.to(torch.float32) + e
        restored = decompress_fn(compress_fn(corrected))
        return restored.to(g.dtype), corrected - restored

    flat_g, treedef = tree_flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, tree_leaves_like(grads, ef_state))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def _all_reduce(t: torch.Tensor, op, mesh, axis: str) -> torch.Tensor:
    """``t`` all-reduced with ``op`` over the ranks of this rank's ``axis``
    line (a size-1 axis: ``t`` itself)."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    stage = mesh.backend == "gloo" and t.device.type == "cuda"
    buf = t.cpu() if stage else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def compressed_psum(g: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """Sum of ``g`` over the ranks of ``axis_name`` whose wire format is int8
    plus one f32 scale: quantize locally, take the largest scale of the
    axis, requantize against it so the integer sum is coherent, sum the raws
    as int32 and dequantize with the shared scale.  ``mesh`` defaults to the
    active mesh (``parallel.sharding.use_mesh``); it must have groups."""
    if mesh is None:
        from repro_torch.parallel.sharding import active_mesh

        mesh = active_mesh()
    if mesh is None or not mesh.has_groups:
        raise ValueError("compressed_psum needs a mesh with process groups "
                         "(Mesh.init_groups inside torch.distributed)")
    _, scale = compress_int8(g)
    scale_max = _all_reduce(scale, dist.ReduceOp.MAX, mesh, axis_name)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale_max), -127, 127).to(torch.int8)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, mesh, axis_name)
    return (total.to(torch.float32) * scale_max).to(g.dtype)


def compressed_grad_reduce(grads, mesh, axis: str = "data",
                           ef_state: Optional[dict] = None):
    """All-reduce a per-rank gradient tree over ``axis`` in int8 and average.

    ``grads`` are this rank's own (computed on its shard of the batch).
    Returns (reduced_grads, new_ef_state); with ``ef_state``, error feedback
    is applied before the wire quantization."""
    if ef_state is not None:
        grads, ef_state = apply_error_feedback(
            grads, ef_state, compress_int8, lambda p: decompress_int8(*p))
    n = mesh.shape[axis]
    return tree_map(lambda x: compressed_psum(x, axis, mesh) / n, grads), ef_state
