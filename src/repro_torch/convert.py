"""Carry parameters across from the JAX package, as numpy arrays.

The port never imports JAX; a caller that holds a reference parameter tree
turns its leaves into numpy arrays (``np.asarray``) and hands them over:

* :func:`cnn_params_from_numpy` takes ``{"convs": [{"w", "b"}], "fcs":
  [...]}`` float leaves — the reference's layouts, which the port keeps:
  (K, K, Cin, Cout) conv weights and (k, n) FC weights;
* :func:`qparams_from_numpy` takes the same tree with quantized leaves
  given as ``(raw, (int_bits, frac_bits, total_bits))``;
* :func:`transformer_params_from_numpy` takes a transformer tree of any
  family (nested dicts, the stacked ``blocks`` and ``tail`` tuples, the
  encoder subtree; leaves of any rank, the 0-d ``cross_gate`` and the
  (E, d, ff) expert stacks alike) whose leaves are float arrays or
  quantized ``(raw, (int_bits, frac_bits, total_bits))`` pairs;
* :func:`transformer_shard_from_numpy` carries such a tree into the calling
  rank's shard through the port's column-parallel plan
  (``parallel.sharding.column_parallel_shardings``);
* :func:`opt_state_from_numpy` takes an AdamW state ``(step, m, v)`` (the
  reference's ``OptState`` with numpy leaves, or any such triple) and
  returns the port's :class:`~repro_torch.optim.OptState`;
  :func:`opt_state_to_numpy` is its inverse, a ``(step, m, v)`` triple of
  numpy trees.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import QFormat, QTensor

__all__ = ["cnn_params_from_numpy", "qparams_from_numpy", "transformer_params_from_numpy",
           "transformer_shard_from_numpy", "opt_state_from_numpy", "opt_state_to_numpy"]


def _tree(tree, leaf):
    return {group: [{name: leaf(v) for name, v in layer.items()}
                    for layer in tree[group]]
            for group in ("convs", "fcs")}


def cnn_params_from_numpy(tree, device="cpu"):
    """Float CNN parameters -> the port's tree of tensors on ``device``."""
    return _tree(tree, lambda a: torch.from_numpy(np.array(a)).to(device))


def _qleaf(v, device) -> QTensor:
    raw, (int_bits, frac_bits, total_bits) = v
    fmt = QFormat(int(int_bits), int(frac_bits), int(total_bits))
    t = torch.from_numpy(np.array(raw)).to(device)
    if t.dtype != fmt.storage_dtype:
        raise TypeError(f"raw dtype {t.dtype} does not match {fmt.name} "
                        f"storage {fmt.storage_dtype}")
    return QTensor(t, fmt)


def qparams_from_numpy(tree, device="cpu"):
    """Quantized CNN parameters, leaves ``(raw, (int_bits, frac_bits,
    total_bits))`` -> the port's tree of :class:`QTensor` on ``device``."""
    return _tree(tree, lambda v: _qleaf(v, device))


def _is_qleaf(v) -> bool:
    return (isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], np.ndarray)
            and isinstance(v[1], tuple) and len(v[1]) == 3)


def transformer_params_from_numpy(tree, device="cpu"):
    """A transformer parameter tree (float or quantized leaves, see above)
    -> the port's tree on ``device``, structure kept: dicts stay dicts, the
    ``blocks`` / ``tail`` tuples stay tuples, quantized leaves become
    :class:`QTensor`."""
    if isinstance(tree, dict):
        return {k: transformer_params_from_numpy(v, device) for k, v in tree.items()}
    if _is_qleaf(tree):
        return _qleaf(tree, device)
    if isinstance(tree, tuple):
        return tuple(transformer_params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def transformer_shard_from_numpy(tree, mesh, axes, rules=None, device="cpu"):
    """The calling rank's column-parallel shard of a transformer tree (as
    :func:`transformer_params_from_numpy` takes it): ``axes`` is the tree's
    logical axes (``models.transformer.param_axes``, with an untied
    ``lm_head`` entry for a quantized tree's head), ``rules`` default
    ``DECODE_RULES``; ``mesh`` must have ranks."""
    from repro_torch.parallel.sharding import (DECODE_RULES, column_parallel_shardings,
                                               shard_tree)

    params = transformer_params_from_numpy(tree, device)
    return shard_tree(params, column_parallel_shardings(mesh, rules or DECODE_RULES,
                                                        params, axes))


def opt_state_from_numpy(state, device="cpu"):
    """An AdamW state ``(step, m, v)`` with numpy leaves -> the port's
    ``OptState`` on ``device``: step a 0-d int32 tensor, m and v f32 trees
    of the parameters' structure (dicts, the stacked tuples)."""
    from repro_torch.optim import OptState

    step, m, v = state
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                      device=device),
                    m=transformer_params_from_numpy(m, device),
                    v=transformer_params_from_numpy(v, device))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_state_to_numpy(state):
    """The port's ``OptState`` -> a ``(step, m, v)`` triple of numpy trees
    (the inverse of :func:`opt_state_from_numpy`)."""
    return (np.asarray(int(state.step), dtype=np.int32), _to_numpy(state.m),
            _to_numpy(state.v))
