"""Carry parameters across from the JAX package, as numpy arrays.

The port never imports JAX; a caller that holds a reference parameter tree
turns its leaves into numpy arrays (``np.asarray``) and hands them over:

* :func:`cnn_params_from_numpy` takes ``{"convs": [{"w", "b"}], "fcs":
  [...]}`` float leaves — the reference's layouts, which the port keeps:
  (K, K, Cin, Cout) conv weights and (k, n) FC weights;
* :func:`qparams_from_numpy` takes the same tree with quantized leaves
  given as ``(raw, (int_bits, frac_bits, total_bits))``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import QFormat, QTensor

__all__ = ["cnn_params_from_numpy", "qparams_from_numpy"]


def _tree(tree, leaf):
    return {group: [{name: leaf(v) for name, v in layer.items()}
                    for layer in tree[group]]
            for group in ("convs", "fcs")}


def cnn_params_from_numpy(tree, device="cpu"):
    """Float CNN parameters -> the port's tree of tensors on ``device``."""
    return _tree(tree, lambda a: torch.from_numpy(np.array(a)).to(device))


def qparams_from_numpy(tree, device="cpu"):
    """Quantized CNN parameters, leaves ``(raw, (int_bits, frac_bits,
    total_bits))`` -> the port's tree of :class:`QTensor` on ``device``."""

    def leaf(v):
        raw, (int_bits, frac_bits, total_bits) = v
        fmt = QFormat(int(int_bits), int(frac_bits), int(total_bits))
        t = torch.from_numpy(np.array(raw)).to(device)
        if t.dtype != fmt.storage_dtype:
            raise TypeError(f"raw dtype {t.dtype} does not match {fmt.name} "
                            f"storage {fmt.storage_dtype}")
        return QTensor(t, fmt)

    return _tree(tree, leaf)
