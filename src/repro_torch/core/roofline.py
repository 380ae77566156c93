"""Roofline analysis of one rank's step from its counted ops (no card needed).

The port's copy of ``repro.core.roofline``.  Three terms per (architecture
x shape x mesh), in seconds:

    compute    = op_flops_per_rank / peak bf16 FLOPs of the card
    memory     = op_bytes_per_rank / HBM bandwidth of the card
    collective = wire_bytes_per_rank / link bandwidth

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
parses its collectives out of the compiled HLO text.  The port has no HLO:
``core/op_analysis.py`` counts the aten ops of the step on fake tensors and
takes the collectives a recording rank would have issued
(``parallel/sharding.py``), each already parsed into (kind, result bytes,
group size).  Per-rank wire traffic per collective follows the reference's
ring model (g = group size, S = result bytes):

    all-reduce          2 * S * (g-1)/g
    all-gather          S * (g-1)/g
    reduce-scatter      S * (g-1)        (operand = g * result)
    all-to-all          S * (g-1)/g
    collective-permute  S

plus the port's one collective the reference's programs never issue, a
gather onto one rank (a checkpoint's writer), at what the root receives,
S * (g-1)/g.  The rates are ``core/tiling.py:H100``'s: its bf16 peak, its
HBM bandwidth and one NVLink rate for every axis (optimistic across nodes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .tiling import H100, GpuSpec

__all__ = [
    "CollectiveStats",
    "RooflineReport",
    "wire_bytes",
    "collective_stats",
    "roofline_from_counts",
    "model_flops",
]

#: the collective kinds, by the reference's HLO names, and the port's gather
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute", "gather")


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Per-rank interconnect bytes of one collective of ``kind`` whose
    result holds ``size`` bytes, over a group of ``group`` ranks (the
    reference's ring factors, in its arithmetic order)."""
    g = group
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "gather"):
        return size * (g - 1) / g
    if kind == "reduce-scatter":
        return float(size) * (g - 1)
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0  # per-rank bytes on the interconnect (ring model)
    operand_bytes: float = 0.0  # naive sum of result sizes (for reference)
    counts: dict = dataclasses.field(default_factory=dict)
    by_op_bytes: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, wire: float, operand: float) -> None:
        self.wire_bytes += wire
        self.operand_bytes += operand
        self.counts[op] = self.counts.get(op, 0) + 1
        self.by_op_bytes[op] = self.by_op_bytes.get(op, 0.0) + wire


def collective_stats(collectives) -> CollectiveStats:
    """The ring model summed over recorded collectives (each with ``kind``,
    ``bytes`` and ``group``), in their order."""
    stats = CollectiveStats()
    for c in collectives:
        stats.add(c.kind, wire_bytes(c.kind, c.bytes, c.group), float(c.bytes))
    return stats


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw counts (per rank)
    op_flops: float
    op_bytes: float
    wire_bytes: float
    collective_counts: dict
    collective_by_op: dict
    # derived terms, seconds
    compute_s: float
    memory_s: float
    collective_s: float
    # usefulness
    model_flops_total: float
    useful_ratio: float  # MODEL_FLOPS / (op FLOPs * chips)
    # memory fit
    per_device_mem_bytes: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent in the best-case (compute) bound.

        1.0 means perfectly compute-bound at peak; lower means memory or
        collectives dominate or compute is wasted vs model FLOPs.
        """
        if self.bound_s <= 0:
            return 0.0
        return (self.compute_s / self.bound_s) * self.useful_ratio

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "op_flops_per_dev": self.op_flops,
            "op_bytes_per_dev": self.op_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "per_device_mem_bytes": self.per_device_mem_bytes,
            "collective_counts": self.collective_counts,
            "collective_by_op": self.collective_by_op,
        }


def model_flops(n_params_active: float, tokens: float, training: bool) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    return (6.0 if training else 2.0) * n_params_active * tokens


def roofline_from_counts(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    flops: float,
    bytes_accessed: float,
    collectives,
    n_params_active: float,
    tokens: float,
    training: bool,
    spec: GpuSpec = H100,
    per_device_mem_bytes: Optional[float] = None,
) -> RooflineReport:
    """The report of one rank's counts: ``flops`` and ``bytes_accessed``
    (``OpStats.flops`` / ``.bytes``, in place of the reference's
    ``cost_analysis``) and its recorded ``collectives`` (in place of its
    HLO text)."""
    flops = float(flops)
    byts = float(bytes_accessed)
    colls = collective_stats(collectives)
    mflops = model_flops(n_params_active, tokens, training)
    total_op_flops = flops * chips
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        op_flops=flops,
        op_bytes=byts,
        wire_bytes=colls.wire_bytes,
        collective_counts=colls.counts,
        collective_by_op={k: round(v) for k, v in colls.by_op_bytes.items()},
        compute_s=flops / spec.peak_bf16_flops,
        memory_s=byts / spec.hbm_bw,
        collective_s=colls.wire_bytes / spec.link_bw,
        model_flops_total=mflops,
        useful_ratio=(mflops / total_op_flops) if total_op_flops else 0.0,
        per_device_mem_bytes=per_device_mem_bytes,
    )
