"""Analytic FPGA resource / latency model: the paper-faithful evaluation plane.

The port's copy of ``repro.core.fpga_model``, expression for expression, so
that every report equals the reference's with ``==``
(``tests/test_torch_fpga.py``).  It is pure Python: no tensor, no device.

The paper's results (Tables 1 and 2) are throughput (GOP/s) and resource
utilization of the template on three ZYNQ boards.  Without the boards the
model reproduces the *methodology*: a cycle-level model of the tiled,
ping-pong-buffered schedule plus a resource model of the compute unit and
its buffers, driven by the same (μ, τ, 𝒯, ℭ, λ, Ω) template parameters.
``repro_torch.benchmarks.table1`` and ``table2`` evaluate it at the paper's
compute-unit configurations beside the paper's numbers.

Model assumptions (calibrated to the paper where stated):
  * one DSP slice per 16-bit MAC  => DSP = μ·τ
  * BRAM18 = 1024 x 18 bit; 16-bit data => 1024 entries per BRAM18
  * buffers ping-pong (x2) and are partitioned for parallel access:
    input by μ, weight by τ (paper §III.C), output by τ
  * two 128-bit M-AXI ports (16 B/cycle each): one shared by IFM/OFM,
    one dedicated to weights (paper §III.C)
  * per-tile latency = max(compute cycles, transfer cycles)  (ping-pong,
    paper §III.C "simultaneous data transfer")
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .tiling import ConvTiling, FCTiling, ceil_div

__all__ = [
    "Board",
    "ULTRA96",
    "ZCU104",
    "ZCU102",
    "BOARDS",
    "LayerSpec",
    "conv_layer",
    "fc_layer",
    "TemplateInstance",
    "LayerReport",
    "NetworkReport",
    "evaluate_network",
    "alexnet_layers",
    "vgg16_layers",
    "lenet_layers",
    "NETWORKS",
]

BYTES_PER_ELEM = 2  # 16-bit fixed point (Q2.14)
AXI_BYTES_PER_CYCLE = 16  # 128-bit M-AXI burst
AXI_EFFICIENCY = 0.75  # achieved burst efficiency (arbitration + realign)
PIPELINE_FILL = 64  # systolic fill + FSM handshake cycles per invocation
MAX_K = 5  # largest kernel the synthesized buffers support directly;
# K > MAX_K (AlexNet conv1) or p < mu layers use input-feature unrolling
# ("im2col mode"): the K*K taps are folded into the input-channel dimension,
# which is the paper's own conv->vector unification applied one level deeper.


@dataclasses.dataclass(frozen=True)
class Board:
    """ZYNQ SoC-FPGA resource envelope (PL side)."""

    name: str
    dsp: int
    bram18: int
    lut: int
    ff: int
    freq_mhz: float  # achieved template frequency from the paper

    @property
    def freq_hz(self) -> float:
        return self.freq_mhz * 1e6


# Resource counts from the Zynq UltraScale+ datasheets (ZU3EG / ZU7EV / ZU9EG);
# frequencies are the paper's achieved values (Table 1).
ULTRA96 = Board("Ultra96", dsp=360, bram18=432, lut=70560, ff=141120, freq_mhz=169.0)
ZCU104 = Board("ZCU104", dsp=1728, bram18=624, lut=230400, ff=460800, freq_mhz=198.0)
ZCU102 = Board("ZCU102", dsp=2520, bram18=1824, lut=274080, ff=548160, freq_mhz=167.0)
BOARDS = {b.name: b for b in (ULTRA96, ZCU104, ZCU102)}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One GEMM-bearing layer, as the template sees it (paper eq. 1/3)."""

    name: str
    kind: str  # "conv" | "fc"
    r: int = 1  # output rows R
    c: int = 1  # output cols C
    p: int = 1  # input channels / neurons
    q: int = 1  # output channels / neurons
    k: int = 1  # kernel size K
    stride: int = 1

    @property
    def macs(self) -> int:
        if self.kind == "conv":
            return self.r * self.c * self.p * self.q * self.k * self.k
        return self.p * self.q

    @property
    def ops(self) -> int:
        """Paper eq. (2)/(4): 2·MACs."""
        return 2 * self.macs


def conv_layer(name, r, c, p, q, k, stride=1) -> LayerSpec:
    return LayerSpec(name, "conv", r=r, c=c, p=p, q=q, k=k, stride=stride)


def fc_layer(name, p, q) -> LayerSpec:
    return LayerSpec(name, "fc", p=p, q=q)


@dataclasses.dataclass(frozen=True)
class TemplateInstance:
    """A fully-instantiated template: compute unit + tile factors."""

    board: Board
    conv: ConvTiling
    fc: FCTiling

    # -- resource model ----------------------------------------------------

    @property
    def dsp(self) -> int:
        return self.conv.mu * self.conv.tau

    def _brams_for(self, elems_per_bank: int, banks: int) -> int:
        depth = 1024  # 18-bit wide BRAM18, 16-bit data
        return banks * ceil_div(max(elems_per_bank, 1), depth) * 2  # x2 ping-pong

    @property
    def bram18(self) -> int:
        cv, fc = self.conv, self.fc
        k = MAX_K  # buffers synthesized for the largest directly-supported K
        total = 0
        # conv input buffer: partitioned by μ
        total += self._brams_for(cv.input_tile_elems(k) // cv.mu, cv.mu)
        # conv weight buffer: partitioned by τ (paper §III.C)
        total += self._brams_for(cv.weight_tile_elems(k) // cv.tau, cv.tau)
        # conv output buffer: partitioned by τ
        total += self._brams_for(cv.output_tile_elems() // cv.tau, cv.tau)
        # dedicated FC buffers (paper: "dedicated buffers for both types")
        total += self._brams_for(fc.input_tile_elems() // cv.mu, cv.mu)
        total += self._brams_for(fc.weight_tile_elems() // cv.tau, cv.tau)
        total += self._brams_for(fc.output_tile_elems() // cv.tau, cv.tau)
        return total

    @property
    def lut(self) -> int:
        # control FSM + AXI + per-MAC glue; linear fit vs Table 1.
        return int(9000 + 11.5 * self.dsp)

    @property
    def ff(self) -> int:
        return int(12000 + 40 * self.dsp)

    def fits(self) -> bool:
        b = self.board
        return (
            self.dsp <= b.dsp
            and self.bram18 <= b.bram18
            and self.lut <= b.lut
            and self.ff <= b.ff
        )

    # -- latency model (ping-pong: max(compute, transfer) per tile) --------

    def layer_cycles(self, layer: LayerSpec, batch: int = 1) -> tuple[int, int, int]:
        """Returns (total_cycles, compute_cycles, transfer_cycles) for ``batch``
        images through one layer.

        Ping-pong model (paper §III.C): per-invocation latency =
        max(compute, transfer) + pipeline fill.  Output partial sums
        accumulate in BRAM across input-channel tiles, so OFM traffic is
        charged once per full p-accumulation, not per μ-tile.  Weights stay
        resident across the batch (the batch loop is innermost of the weight
        loop), so weight traffic amortizes by 1/batch per image.
        """
        bw = AXI_BYTES_PER_CYCLE * AXI_EFFICIENCY
        if layer.kind == "conv":
            t = self.conv
            p, q, k = layer.p, layer.q, layer.k
            raw_k, raw_p = k, p
            if k > MAX_K or p < t.mu:
                # input-feature unrolling: fold the K*K taps into channels.
                # The raw input tile is read once and windowed on-chip, so
                # IFM traffic is charged from the *raw* tile, not the
                # im2col-expanded patches.
                p, k = p * k * k, 1
            inv = t.num_invocations(layer.r, layer.c, p, q)
            comp = t.compute_cycles_per_invocation(k, layer.r, layer.c)
            p_tiles = ceil_div(p, t.mu)
            tr, tc = t.eff_spatial(layer.r, layer.c)
            raw_cin = min(raw_p, t.mu) if raw_k == k else raw_p
            in_elems = (layer.stride * tr + raw_k - layer.stride) * (
                layer.stride * tc + raw_k - layer.stride
            ) * raw_cin
            in_bytes = in_elems * BYTES_PER_ELEM / p_tiles
            w_bytes = t.mu * t.tau * k * k * BYTES_PER_ELEM / batch
            out_bytes = tr * tc * t.tau * BYTES_PER_ELEM / p_tiles
        else:
            t = self.fc
            inv = t.num_invocations(layer.p, layer.q)
            comp = t.compute_cycles_per_invocation() * batch
            p_tiles = ceil_div(layer.p, t.lam)
            in_bytes = t.input_tile_elems() * BYTES_PER_ELEM * batch
            w_bytes = t.weight_tile_elems() * BYTES_PER_ELEM
            out_bytes = t.output_tile_elems() * BYTES_PER_ELEM * batch / p_tiles
        # port 0: IFM read + OFM write; port 1: weights (paper §III.C)
        xfer = max(
            ceil_div(int(in_bytes + out_bytes), int(bw)),
            ceil_div(int(w_bytes), int(bw)),
        )
        per_tile = max(comp, xfer) + PIPELINE_FILL
        scale = batch if layer.kind == "conv" else 1
        return scale * inv * per_tile, scale * inv * comp, scale * inv * xfer

    def network_latency_s(self, layers: Sequence[LayerSpec], batch: int = 1) -> float:
        cycles = sum(self.layer_cycles(l, batch)[0] for l in layers)
        return cycles / self.board.freq_hz

    @property
    def peak_gops(self) -> float:
        return 2 * self.dsp * self.board.freq_hz / 1e9


@dataclasses.dataclass
class LayerReport:
    layer: LayerSpec
    cycles: int
    compute_cycles: int
    transfer_cycles: int
    latency_ms: float
    gops: float
    bound: str


@dataclasses.dataclass
class NetworkReport:
    name: str
    instance: TemplateInstance
    layers: list[LayerReport]
    total_ops: int
    conv_ops: int
    latency_ms: float
    conv_latency_ms: float
    gops: float
    conv_gops: float

    def summary(self) -> str:
        t = self.instance
        return (
            f"{self.name} on {t.board.name} (CU {t.conv.mu}x{t.conv.tau} @ "
            f"{t.board.freq_mhz:.0f} MHz): {self.gops:.1f} GOP/s all-layers, "
            f"{self.conv_gops:.1f} GOP/s conv-only, latency {self.latency_ms:.3f} ms, "
            f"DSP {t.dsp}/{t.board.dsp}, BRAM {t.bram18}/{t.board.bram18}"
        )


def evaluate_network(
    name: str,
    layers: Sequence[LayerSpec],
    instance: TemplateInstance,
    batch: int = 1,
) -> NetworkReport:
    reports = []
    freq = instance.board.freq_hz
    for layer in layers:
        cyc, comp, xfer = instance.layer_cycles(layer, batch)
        lat = cyc / freq
        reports.append(
            LayerReport(
                layer=layer,
                cycles=cyc,
                compute_cycles=comp,
                transfer_cycles=xfer,
                latency_ms=lat * 1e3,
                gops=batch * layer.ops / lat / 1e9,
                bound="compute" if comp >= xfer else "memory",
            )
        )
    total_ops = sum(l.layer.ops for l in reports) * batch
    conv = [l for l in reports if l.layer.kind == "conv"]
    conv_ops = sum(l.layer.ops for l in conv) * batch
    lat_s = sum(l.cycles for l in reports) / freq
    conv_lat_s = sum(l.cycles for l in conv) / freq if conv else 0.0
    return NetworkReport(
        name=name,
        instance=instance,
        layers=reports,
        total_ops=total_ops,
        conv_ops=conv_ops,
        latency_ms=lat_s * 1e3,
        conv_latency_ms=conv_lat_s * 1e3,
        gops=total_ops / lat_s / 1e9,
        conv_gops=(conv_ops / conv_lat_s / 1e9) if conv else 0.0,
    )


# ---------------------------------------------------------------------------
# Reference network layer tables (paper §III.A case studies)
# ---------------------------------------------------------------------------


def alexnet_layers() -> list[LayerSpec]:
    """AlexNet (single-tower, as deployed from the PyTorch model zoo)."""
    return [
        conv_layer("conv1", 55, 55, 3, 64, 11, stride=4),
        conv_layer("conv2", 27, 27, 64, 192, 5),
        conv_layer("conv3", 13, 13, 192, 384, 3),
        conv_layer("conv4", 13, 13, 384, 256, 3),
        conv_layer("conv5", 13, 13, 256, 256, 3),
        fc_layer("fc6", 9216, 4096),
        fc_layer("fc7", 4096, 4096),
        fc_layer("fc8", 4096, 1000),
    ]


def vgg16_layers() -> list[LayerSpec]:
    cfg = [
        (224, 3, 64), (224, 64, 64),
        (112, 64, 128), (112, 128, 128),
        (56, 128, 256), (56, 256, 256), (56, 256, 256),
        (28, 256, 512), (28, 512, 512), (28, 512, 512),
        (14, 512, 512), (14, 512, 512), (14, 512, 512),
    ]
    layers = [
        conv_layer(f"conv{i+1}", r, r, p, q, 3) for i, (r, p, q) in enumerate(cfg)
    ]
    layers += [
        fc_layer("fc14", 25088, 4096),
        fc_layer("fc15", 4096, 4096),
        fc_layer("fc16", 4096, 1000),
    ]
    return layers


def lenet_layers() -> list[LayerSpec]:
    return [
        conv_layer("conv1", 28, 28, 1, 6, 5),
        conv_layer("conv2", 10, 10, 6, 16, 5),
        fc_layer("fc3", 400, 120),
        fc_layer("fc4", 120, 84),
        fc_layer("fc5", 84, 10),
    ]


NETWORKS = {
    "alexnet": alexnet_layers,
    "vgg16": vgg16_layers,
    "lenet": lenet_layers,
}
