"""Loop tiling (paper §III.B): the FPGA tiles, and the port planner's specs.

* :class:`ConvTiling` / :class:`FCTiling` — the paper's conv tiles (𝒯, ℭ,
  μ, τ) and FC tiles (λ, Ω) on the μ×τ compute unit, a copy of the
  reference's FPGA plane: they size the BRAM buffers and the per-invocation
  computation that ``fpga_model`` and ``dse.explore_board`` evaluate.

Two device specs live here:

* :class:`TpuSpec` / ``TPU_V5E`` — a copy of the reference's TPU description,
  kept as *data*: fed to the port's search it must return exactly the
  reference's plans (``tests/test_torch_dse.py``).  No kernel of the port
  runs under it.
* :class:`GpuSpec` / ``H100`` — what the port plans against.  Its limits are
  the CUDA kernels' own: the GEMM tiles they are compiled for, the routes
  of the float and the fixed-point GEMM, the threads of a block, and the
  shared memory a block may take.

:class:`MatmulBlock` is one GEMM tile (bm, bn, bk) under either spec; under
a GpuSpec it also names the GEMM's route (``FP_ROUTES``, ``Q16_ROUTES``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

__all__ = [
    "CONV_ROUTES",
    "ConvTiling",
    "FCTiling",
    "FP_ROUTES",
    "Q16_ROUTES",
    "GpuSpec",
    "H100",
    "MatmulBlock",
    "TPU_V5E",
    "TpuSpec",
    "Spec",
    "ceil_div",
    "clamp_block",
]


#: the float GEMM's routes (``csrc/matmul_fp.cu``): "tile" is the block-tiled
#: CUDA-core GEMM of ``csrc/gemm.cuh`` (route L), "splitk" the split-k weight
#: stream of ``csrc/gemm_splitk.cuh`` (route S, m <= 16), "wgmma" the
#: tensor-core pipeline of ``csrc/gemm_wgmma.cuh`` (route W, bf16 with large m)
FP_ROUTES = ("tile", "splitk", "wgmma")

#: the fixed-point GEMM's routes (``csrc/matmul_q16.cu``): "tile" is the same
#: block-tiled CUDA-core GEMM (taken only when a plan names it), "splitk" the
#: integer instantiation of ``csrc/gemm_splitk.cuh`` (m <= 16), "wgmma" the
#: s8 / u8 limb products on the tensor cores of ``csrc/gemm_q16_wgmma.cuh``
#: (every larger m)
Q16_ROUTES = ("tile", "splitk", "wgmma")

#: the direct conv's routes (``csrc/conv2d.cu``), float and fixed point:
#: "cudacore" is its CUDA-core ``conv_kernel`` (the convs the other route
#: does not take), "tc" the tensor-core implicit GEMM: 3xTF32 for float
#: (``csrc/conv2d_tc.cuh``, Cin and Cout multiples of 8), s8 / u8 limb
#: products for int16 / int8 raws (``csrc/conv2d_q16_tc.cuh``, Cin·bytes a
#: multiple of 16, Cout a multiple of 8)
CONV_ROUTES = ("cudacore", "tc")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# FPGA plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvTiling:
    """Conv loop-tiling factors (paper notation: 𝒯, ℭ, μ, τ)."""

    t_r: int  # output-row tile 𝒯
    t_c: int  # output-col tile ℭ
    mu: int  # input-channel tile μ  (compute-unit input width)
    tau: int  # output-channel tile τ (compute-unit output width)

    def eff_spatial(self, r: int, c: int) -> tuple[int, int]:
        """HLS templates bound the tile loop by min(tile, layer dim)."""
        return min(self.t_r, r), min(self.t_c, c)

    def num_invocations(self, r: int, c: int, p: int, q: int) -> int:
        """Tile invocations to cover an output of r x c x q from p channels."""
        tr, tc = self.eff_spatial(r, c)
        return (
            ceil_div(r, tr)
            * ceil_div(c, tc)
            * ceil_div(p, self.mu)
            * ceil_div(q, self.tau)
        )

    def compute_cycles_per_invocation(self, k: int, r: int = None, c: int = None) -> int:
        """Fig. 4 dataflow: one μ×τ MAC wave per (spatial, tap) position, an
        II=1 pipeline over 𝒯'·ℭ'·K² positions (the effective tile)."""
        tr, tc = self.eff_spatial(r or self.t_r, c or self.t_c)
        return tr * tc * k * k

    def input_tile_elems(self, k: int, stride: int = 1) -> int:
        h = stride * self.t_r + k - stride
        w = stride * self.t_c + k - stride
        return h * w * self.mu

    def weight_tile_elems(self, k: int) -> int:
        return self.mu * self.tau * k * k

    def output_tile_elems(self) -> int:
        return self.t_r * self.t_c * self.tau


@dataclasses.dataclass(frozen=True)
class FCTiling:
    """FC loop-tiling factors (paper notation: λ, Ω) over the same μ×τ unit:
    λ / Ω are the BRAM-resident vector tiles, consumed by the compute unit in
    (μ, τ) sub-blocks (paper Fig. 5)."""

    lam: int  # input-neuron tile λ
    omega: int  # output-neuron tile Ω
    mu: int
    tau: int

    def num_invocations(self, p: int, q: int) -> int:
        return ceil_div(p, self.lam) * ceil_div(q, self.omega)

    def compute_cycles_per_invocation(self) -> int:
        # (λ/μ)·(Ω/τ) sub-blocks, each one MAC wave per μ-element column
        return ceil_div(self.lam, self.mu) * ceil_div(self.omega, self.tau)

    def input_tile_elems(self) -> int:
        return self.lam

    def weight_tile_elems(self) -> int:
        return self.lam * self.omega

    def output_tile_elems(self) -> int:
        return self.omega


# ---------------------------------------------------------------------------
# device plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuSpec:
    """Per-chip TPU description (data only: the parity target of the DSE)."""

    name: str = "tpu_v5e"
    peak_bf16_flops: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9
    vmem_bytes: int = 64 * 1024 * 1024
    mxu_dim: int = 128
    lane: int = 128
    sublane: int = 8


TPU_V5E = TpuSpec()


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One NVIDIA Hopper card as the port's kernels see it.

    ``gemm_tiles`` are the (bm, bn, bk) tiles of the block-tiled GEMM in
    ``csrc/gemm.cuh`` (both GEMM kernels' route "tile"), each run by
    ``gemm_threads`` threads; ``conv_taus`` the output-channel slices
    ``csrc/conv2d.cu``'s CUDA-core route takes, ``conv_tc_taus`` those of
    its float tensor-core route (``csrc/conv2d_tc.cuh``; the fixed-point one,
    ``csrc/conv2d_q16_tc.cuh``, takes ``dse.TC_Q16_TAU`` only).  The float GEMM's other routes, each field the
    list its header compiles:

    * "splitk" (``csrc/gemm_splitk.cuh``) takes m up to
      :attr:`splitk_max_m`, padded to one of ``splitk_rows`` (the header's
      ``switch (bm)``); a block streams ``splitk_cols`` columns of w (its
      ``COLS``) over one k slice;
    * "wgmma" (``csrc/gemm_wgmma.cuh``) takes bf16 with every larger m, and
      k, n multiples of 8 (TMA's 16-byte row strides), on the
      ``wgmma_tiles`` (its ``BM`` x ``BN`` x ``BK``, ``BN`` 128 or 256).

    The fixed-point GEMM's routes (``Q16_ROUTES``): "splitk" is the integer
    instantiation of the same header, with the same rows, columns and
    bound; "wgmma"
    (``csrc/gemm_q16_wgmma.cuh``) every larger m, on the ``q16_wgmma_tiles``
    (its ``BM`` x ``BN`` x ``BK``, ``BK`` in bytes of k): ``BN`` 64 takes
    every width mix, ``BN`` 128 only those with at most two limb products
    (an int8 operand), whose accumulators fit the registers at that width.

    Flash attention's routes: "simt" (``csrc/flash_attention.cu``) is
    compiled for the ``flash_head_dims``, "wgmma" (``csrc/flash_wgmma.cuh``)
    for the ``flash_wgmma_head_dims``.

    Rates are NVIDIA's dense published peaks for the SXM part at its 700 W
    limit.  ``peak_bf16_flops`` (dense bf16 on the tensor cores) is the
    roofline's compute rate, as the reference divides by its TPU's bf16
    peak; ``link_bw`` (NVLink 4: 18 links x 25 GB/s, one direction) its
    collective rate.  A production mesh's axis of 16 spans two 8-card
    nodes, whose links between nodes are slower, so that term is an
    optimistic bound (``core/roofline.py``).
    """

    name: str = "h100_sxm"
    sms: int = 132
    smem_per_block: int = 232_448
    threads_per_block: int = 1024
    hbm_bw: float = 3.35e12
    peak_f32_flops: float = 67e12
    peak_int8_ops: float = 1979e12
    peak_bf16_flops: float = 989e12
    link_bw: float = 450e9
    gemm_tiles: tuple = ((16, 64, 16), (64, 64, 16), (128, 128, 16))
    gemm_threads: int = 256
    wgmma_tiles: tuple = ((128, 128, 64), (128, 256, 64))
    splitk_rows: tuple = (1, 2, 4, 8, 16)
    splitk_cols: int = 256
    q16_wgmma_tiles: tuple = ((128, 64, 128), (128, 128, 128))
    conv_taus: tuple = (8, 16, 32, 64, 128, 256)
    conv_threads: int = 256
    #: conv2d_tc.cuh: the τ that launch_conv_tc instantiates (launch_tau<64 / 128>)
    conv_tc_taus: tuple = (64, 128)
    #: flash_attention.cu: launch_flash_d's head dims; flash_wgmma.cuh: launch_flash_wgmma's
    flash_head_dims: tuple = (16, 32)
    flash_wgmma_head_dims: tuple = (64, 128)

    @property
    def splitk_max_m(self) -> int:
        """The largest m route "splitk" takes: its largest compiled row count."""
        return max(self.splitk_rows)


H100 = GpuSpec()

Spec = Union[TpuSpec, GpuSpec]


@dataclasses.dataclass(frozen=True)
class MatmulBlock:
    """One GEMM tile: ``bm`` rows x ``bn`` columns of output, ``bk`` deep per
    step of the reduction loop.

    ``route`` is the GEMM's route (one of ``FP_ROUTES`` or ``Q16_ROUTES``;
    every TPU plan takes "tile").  On route "splitk" ``bm`` is the compiled
    row count m is padded to, ``bn`` the columns of one block, ``bk`` the k
    slice of one block and ``splits`` the number of slices.
    """

    bm: int = 512
    bn: int = 512
    bk: int = 512
    route: str = "tile"
    splits: int = 1

    def vmem_bytes(self, in_dtype_bytes: int = 2, acc_bytes: int = 4) -> int:
        # TPU model: double-buffered x/w/out tiles + the f32 accumulator
        x = self.bm * self.bk * in_dtype_bytes * 2
        w = self.bk * self.bn * in_dtype_bytes * 2
        acc = self.bm * self.bn * acc_bytes
        out = self.bm * self.bn * in_dtype_bytes * 2
        return x + w + acc + out

    def smem_bytes(self) -> int:
        """Shared memory of ``csrc/gemm.cuh`` (route "tile") at this tile:
        the x and w tiles of one k-step, widened to 4 bytes each."""
        return (self.bm * self.bk + self.bk * self.bn) * 4

    def aligned(self, spec: TpuSpec = TPU_V5E) -> bool:
        return (
            self.bm % spec.sublane == 0
            and self.bn % spec.lane == 0
            and self.bk % spec.lane == 0
        )

    def mxu_efficiency(self, spec: TpuSpec = TPU_V5E) -> float:
        def frac(dim: int) -> float:
            return dim / (ceil_div(dim, spec.mxu_dim) * spec.mxu_dim)

        return frac(self.bm) * frac(self.bn) * frac(self.bk)

    def arithmetic_intensity(self, in_dtype_bytes: int = 2) -> float:
        flops = 2 * self.bm * self.bn * self.bk
        bytes_moved = (self.bm * self.bk + self.bk * self.bn) * in_dtype_bytes
        return flops / bytes_moved

    def legal(self, m: int, n: int, k: int, spec: Spec = TPU_V5E) -> bool:
        if isinstance(spec, GpuSpec):
            return (
                (self.bm, self.bn, self.bk) in spec.gemm_tiles
                and self.smem_bytes() <= spec.smem_per_block
                and spec.gemm_threads <= spec.threads_per_block
            )
        return (
            self.aligned(spec)
            and self.vmem_bytes() <= spec.vmem_bytes
            and self.bm <= max(m, spec.sublane)
            and self.bn <= max(n, spec.lane)
            and self.bk <= max(k, spec.lane)
        )


def clamp_block(m: int, n: int, k: int, block: MatmulBlock,
                spec: TpuSpec = TPU_V5E) -> MatmulBlock:
    """Shrink a block to fit a (possibly small) problem, keeping TPU
    alignment.  GPU tiles are fixed at compile time and are not clamped."""
    if isinstance(spec, GpuSpec):
        return block

    def shrink(dim: int, b: int, gran: int) -> int:
        b = min(b, max(gran, math.ceil(dim / gran) * gran))
        return max(gran, b - b % gran)

    return MatmulBlock(
        bm=shrink(m, block.bm, spec.sublane),
        bn=shrink(n, block.bn, spec.lane),
        bk=shrink(k, block.bk, spec.lane),
    )
