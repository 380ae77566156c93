"""Kernel-plane benchmark: the compute unit across workload GEMMs.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_table --device cpu

The port's copy of the reference's ``benchmarks/kernel_table.py``.  It
reports, for each workload GEMM of :data:`CASES`, the plan the DSE picks and
the structural metrics it optimizes:

  * under ``TPU_V5E``, the reference's rows (BlockSpec, VMEM, MXU
    efficiency, modeled MXU / HBM time): the planner returns the reference's
    plans there, so these are kept as data;
  * under ``H100`` (the port's kernels), both main-path GEMMs of each case,
    the float GEMM in bf16 and the q16 GEMM at int16 x int16: the planned
    route, tile and k slices, the shared memory a block of that route takes,
    the arithmetic intensity against the bf16 ridge, and the bound (the
    larger of the bytes at the HBM rate and the operations at the peak of
    their type; the q16 peak is the int8 rate over 4 limb products).  On a
    card each row is also timed: the planned route launched through the
    engine (``ms``) and ``torch.matmul`` in bf16 (``library_ms``; no
    library call multiplies int16).

Then: each kernel against its oracle at a small shape (``kernels/ref.py``;
the kernels on a card, their plain versions on the CPU; integers exact),
the conv routes' bytes and times, the spatially tiled conv, spatial
sharding's halo bytes, the plan store's warm start, fixed-point residency,
the precision DSE, the scheduler's mixed trace and the router's failover,
each gated as the reference gates it.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.engine import plan_cache_for
from repro_torch.core.tiling import H100, TPU_V5E, TpuSpec

CASES = {
    # label: (m, n, k) — per-device GEMMs from the assigned workloads
    "qwen2.5-32b train mlp-up": (65536 // 16, 27648 // 16, 5120),
    "qwen2.5-32b train qkv": (65536 // 16, 5120 // 16 + 1280, 5120),
    "llama-90b train mlp-up": (65536 // 16, 28672 // 16, 8192),
    "qwen2-0.5b decode lm-head": (128 // 16, 151936 // 16, 896),
    "granite expert ffn": (512, 512, 1536),
    "alexnet conv2 im2col": (27 * 27 * 4, 192, 64 * 25),
}

#: the GPU rows' numerics: (label, GEMM kernel, operand bytes)
GPU_NUMERICS = (("bf16", "matmul_fp", 2), ("int16", "matmul_q16", 2))


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def gemm_smem_bytes(block, kernel: str, xbits: int = 16, wbits: int = 16) -> int:
    """Shared memory one block of a planned GEMM route takes, as its header
    sizes it: route "tile" ``csrc/gemm.cuh``; "splitk"
    ``csrc/gemm_splitk.cuh`` (x's slice staged in 4-byte values, at least
    the reduction's ``RED_BYTES``); the float "wgmma" ``csrc/gemm_wgmma.cuh``
    (``smem_bytes<BN>``: the bf16 ring, four output boxes, slack, barriers);
    the q16 "wgmma" ``csrc/gemm_q16_wgmma.cuh`` (``Cfg::SMEM``: a ring of
    byte planes, one plane an 8-bit operand and two a 16-bit one)."""
    if block.route == "splitk":
        return max(block.bm * block.bk * 4, 8 * 4 * 256 * 4)
    if block.route == "wgmma" and kernel == "matmul_fp":
        stages = 4 if block.bn == 256 else 6
        return stages * (block.bm + block.bn) * block.bk * 2 + 4 * 64 * 64 * 2 + 1024 \
            + stages * 16
    if block.route == "wgmma":
        stage = (xbits // 8) * block.bm * block.bk + (wbits // 8) * block.bn * block.bk
        stages = min(196608 // stage, 8)
        return stages * stage + 1024 + 2 * stages * 8
    return block.smem_bytes()


def _tpu_rows(spec) -> list[dict]:
    """The reference's rows under a TPU spec."""
    rows = []
    ridge = spec.peak_bf16_flops / spec.hbm_bw
    registry = plan_cache_for(spec)
    for label, (m, n, k) in CASES.items():
        blk = registry.block_for(m, n, k, spec)
        flops = 2.0 * m * n * k
        mxu_s = flops / (spec.peak_bf16_flops * blk.mxu_efficiency())
        hbm_s = (m * k + k * n + m * n) * 2 / spec.hbm_bw
        rows.append({
            "gemm": label,
            "mnk": (m, n, k),
            "block": (blk.bm, blk.bn, blk.bk),
            "vmem_MiB": round(blk.vmem_bytes() / 2**20, 1),
            "mxu_eff": round(blk.mxu_efficiency(), 3),
            "ai": round(blk.arithmetic_intensity(), 1),
            "ridge": round(ridge, 1),
            "bound": "compute" if blk.arithmetic_intensity() >= ridge else "memory",
            "mxu_us": round(mxu_s * 1e6, 1),
            "hbm_us": round(hbm_s * 1e6, 1),
        })
    return rows


def _time_gemm(row: dict, blk, kernel: str, device) -> None:
    """Launch the planned route once through the engine (its launches
    counted in ``_build.launches``), then time it and the library call."""
    from repro_torch.benchmarks._timing import time_ms
    from repro_torch.core.engine import GemmPlan
    from repro_torch.core.quantization import Q2_14, QTensor
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build

    m, n, k = row["mnk"]
    gen = torch.Generator(device=device).manual_seed(m + n + k)
    plan = GemmPlan(m, n, k, blk)
    if kernel == "matmul_fp":
        eng = default_template("cuda", device=device).engine
        x = torch.randn((m, k), device=device, generator=gen).to(torch.bfloat16)
        w = (torch.randn((k, n), device=device, generator=gen) * k ** -0.5).to(torch.bfloat16)

        def call():
            return eng.matmul(x, w, plan=plan)

        def library():
            return torch.matmul(x, w)
    else:
        eng = default_template("q16", device=device).engine
        x = QTensor(torch.randint(-2**15, 2**15, (m, k), device=device, generator=gen,
                                  dtype=torch.int32).to(torch.int16), Q2_14)
        w = QTensor(torch.randint(-2**15, 2**15, (k, n), device=device, generator=gen,
                                  dtype=torch.int32).to(torch.int16), Q2_14)

        def call():
            return eng.matmul(x, w, plan=plan)

        library = None
    before = dict(_build.launches)
    call()
    torch.cuda.synchronize()
    row["launches"] = {key: c - before.get(key, 0) for key, c in _build.launches.items()
                       if c != before.get(key, 0)}
    if row["launches"].get(f"{kernel}.{blk.route}", 0) != 1:
        raise AssertionError(f"{row['gemm']} {row['numerics']}: launched {row['launches']}, "
                             f"the plan names route {blk.route}")
    row["ms"] = time_ms(call)
    row["library_ms"] = None if library is None else time_ms(library)
    row["library"] = "torch.matmul bf16" if library is not None else None


def _gpu_rows(spec, device) -> list[dict]:
    from repro_torch.benchmarks._timing import bound

    rows = []
    ridge = spec.peak_bf16_flops / spec.hbm_bw
    registry = plan_cache_for(spec)
    for label, (m, n, k) in CASES.items():
        for numerics, kernel, nb in GPU_NUMERICS:
            if kernel == "matmul_fp":
                blk = registry.block_for(m, n, k, spec, kernel=kernel, dtype_bytes=nb)
                peak = spec.peak_bf16_flops
            else:
                blk = registry.block_for(m, n, k, spec, xbits=8 * nb, wbits=8 * nb)
                peak = spec.peak_int8_ops / 4  # int16 x int16: 4 limb products
            nbytes = (m * k + k * n + m * n) * nb
            ops = 2 * m * n * k
            b_ms, b_by = bound(nbytes, ops, peak, spec.hbm_bw)
            row = {
                "gemm": label,
                "numerics": numerics,
                "mnk": (m, n, k),
                "route": blk.route,
                "block": (blk.bm, blk.bn, blk.bk),
                "splits": blk.splits,
                "smem_KiB": round(gemm_smem_bytes(blk, kernel) / 2**10, 1),
                "ai": round(ops / nbytes, 1),
                "ridge": round(ridge, 1),
                "bound_ms": b_ms,
                "bound_by": b_by,
            }
            if _is_cuda(device):
                _time_gemm(row, blk, kernel, device)
            rows.append(row)
    return rows


def structural_rows(spec=H100, device=None) -> list[dict]:
    """The plan and its structural metrics for every case under ``spec``:
    the reference's rows under a TPU spec; under a GPU spec (``H100``) a row
    per (case, numerics), timed when ``device`` is a CUDA device."""
    if isinstance(spec, TpuSpec):
        return _tpu_rows(spec)
    return _gpu_rows(spec, device)


def correctness_pass(device="cuda") -> dict:
    """Max |error| of each kernel against its oracle at the reference's small
    shapes, through the planned routes (the kernels on a card, their plain
    versions on the CPU); the fixed-point kernels are exact."""
    from repro_torch.core.quantization import Q2_14, QTensor, quantize
    from repro_torch.core.template import default_template
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    tf = default_template("cuda", device=device)
    tq = default_template("q16", device=device)
    x, w = randn((96, 160), 0.3), randn((160, 64), 0.3)
    mm = float((tf.matmul(x, w) - ref.matmul_ref(x, w)).abs().max())
    xq, wq = quantize(x, Q2_14), quantize(w, Q2_14)
    got = tq.matmul(QTensor(xq, Q2_14), QTensor(wq, Q2_14)).raw
    q = int((got.long() - ref.matmul_q16_ref(xq, wq).long()).abs().max())
    xi, wi = randn((1, 10, 10, 4)), randn((3, 3, 4, 8), 0.3)
    cv = float((tf.conv2d(xi, wi) - ref.conv2d_ref(xi, wi)).abs().max())
    xiq, wiq = quantize(xi * 0.5, Q2_14), quantize(wi, Q2_14)
    got = tq.conv2d(QTensor(xiq, Q2_14), QTensor(wiq, Q2_14)).raw
    qc = int((got.long() - ref.conv2d_q16_ref(xiq, wiq).long()).abs().max())
    qq, kk = randn((1, 4, 64, 32), 0.3), randn((1, 2, 64, 32), 0.3)
    fa_out = ops.flash_attention(qq, kk, kk, causal=True, bq=32, bk=32)
    qf = qq.reshape(4, 64, 32)
    kf = kk[:, :, None].expand(1, 2, 2, 64, 32).reshape(4, 64, 32)
    fa = float((fa_out.reshape(4, 64, 32) - ref.attention_ref(qf, kf, kf)).abs().max())
    return {"matmul_fp": mm, "matmul_q16_raw": q, "conv2d": cv, "conv2d_q16_raw": qc,
            "flash_attention": fa}


#: each float kernel's tolerance (the reference's ``tests/test_kernels.py``)
CORRECTNESS_TOL = {"matmul_fp": 1e-4, "conv2d": 2e-3, "flash_attention": 2e-3}


def _time_conv(tpl, x, w, plan) -> float:
    """ms of one conv on its plan: CUDA events on a card, the wall clock of
    the plain version on the CPU."""
    from repro_torch.benchmarks._timing import time_ms

    def fn():
        return tpl.conv2d(x, w, stride=1, padding=plan.pad, plan=plan)

    if _is_cuda(x.device):
        return time_ms(fn)
    fn()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    return (time.perf_counter() - t0) / 3 * 1e3


def im2col_vs_direct_row(n=1, hw=16, cin=16, cout=32, k=3, pad=1, device="cuda") -> dict:
    """Structural + measured comparison of the two conv routes, as JSON.

    Bytes are the HBM traffic of each route's GEMM stage (f32): im2col must
    materialize the (N·Ho·Wo, Cin·K²) column matrix, the direct kernel
    streams the image slab once.  Times are each route's on ``device``: the
    kernels by CUDA events on a card, the plain versions' wall clock on the
    CPU (a trajectory between commits only; the bytes are the hardware
    story).
    """
    from repro_torch.core.template import default_template

    ho = wo = hw + 2 * pad - k + 1
    m, nn, kk = n * ho * wo, cout, cin * k * k
    im2col_bytes = (m * kk + kk * nn + m * nn) * 4
    hp = hw + 2 * pad
    direct_bytes = (n * hp * hp * cin + k * k * cin * cout + n * ho * wo * cout) * 4
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((n, hw, hw, cin), generator=gen) * 0.3).to(device)
    w = (torch.randn((k, k, cin, cout), generator=gen) * 0.3).to(device)
    tpl = default_template("cuda", device=device)
    eng = tpl.engine
    p_dir = eng.plan_conv(x.shape, w.shape, stride=1, padding=pad)
    p_gem = eng.plan_conv(x.shape, w.shape, stride=1, padding=pad, route="im2col")
    return {
        "bench": "conv_route_comparison",
        "conv": {"n": n, "hw": hw, "cin": cin, "cout": cout, "k": k, "pad": pad},
        "gemm_mnk": [m, nn, kk],
        "im2col_gemm_bytes": im2col_bytes,
        "direct_gemm_bytes": direct_bytes,
        "bytes_ratio_im2col_over_direct": round(im2col_bytes / direct_bytes, 2),
        "direct_route": f"{p_dir.route}/{p_dir.conv_route}",
        "im2col_route": f"{p_gem.route}/{p_gem.block.route}",
        "timed_by": "cuda events" if _is_cuda(device) else "cpu wall clock, plain versions",
        "im2col_ms": _time_conv(tpl, x, w, p_gem),
        "direct_ms": _time_conv(tpl, x, w, p_dir),
    }


def spatial_tiling_row(device="cuda") -> dict:
    """Oracle row for the spatially-tiled direct conv route, as JSON.

    Structural, under ``TPU_V5E`` (the reference's plan): the 3x3, Cin = 64,
    512² layer whose untiled slab exceeds the v5e VMEM budget plans
    ``direct`` with >= 2 spatial tiles on a (𝒯, ℭ) DMA-halo tiling inside
    the budget, and against the best legal two-block configuration at that
    configuration's tile dims, its VMEM residency and input-stream traffic
    both come out <= 0.6x.  Numeric: on a shrunken TPU budget the planner's
    tiled (DMA-halo) plan of a small layer runs on the port's direct conv
    and is held to the im2col route as the H100 plans it (the port's GEMM
    kernels take no TPU tile).  On top, the route and tile the port plans
    for the 512² layer under ``H100``.
    """
    import dataclasses

    from repro_torch.core.dse import (direct_conv_input_traffic, direct_conv_vmem,
                                      explore_conv_spatial)
    from repro_torch.core.engine import Engine
    from repro_torch.core.template import Template, TemplateConfig

    eng = Engine(TemplateConfig(backend="cuda", hw=TPU_V5E, device=device))
    plan = eng.plan_conv((1, 512, 512, 64), (3, 3, 64, 64), stride=1, padding=1)
    untiled = direct_conv_vmem(514, 514, 64, 3, 3, 512, 512, plan.tau or 64, 4)
    # best legal two-block config on the same layer (large top: the DMA
    # configs dominate the ranking, the two-block baseline sits further down)
    two_blk = next(c for c in explore_conv_spatial(
        514, 514, 64, 3, 3, 512, 512, 64, 1, TPU_V5E, 4, top=4096)
        if c.halo_mode == "two_block")
    vm = {mode: direct_conv_vmem(
        514, 514, 64, 3, 3, 512, 512, two_blk.tau, 4,
        tile_rows=two_blk.tile_rows, halo_mode=mode)
        for mode in ("two_block", "dma")}
    tr = {mode: direct_conv_input_traffic(
        514, 514, 64, 3, 3, 512, 512, 64, 1, two_blk.tau, 4,
        tile_rows=two_blk.tile_rows, halo_mode=mode)
        for mode in ("two_block", "dma")}
    # numeric differential at a budget that forces tiling on a small layer
    hw = dataclasses.replace(TPU_V5E, vmem_bytes=256 * 1024)
    t_s = Template(TemplateConfig(backend="cuda", hw=hw, device=device))
    t_h = Template(TemplateConfig(backend="cuda", hw=H100, device=device))
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((1, 32, 32, 32), generator=gen) * 0.3).to(device)
    w = (torch.randn((3, 3, 32, 16), generator=gen) * 0.3).to(device)
    p_dir = t_s.engine.plan_conv(x.shape, w.shape, stride=1, padding=1)
    p_gem = t_h.engine.plan_conv(x.shape, w.shape, stride=1, padding=1, route="im2col")
    err = float((t_s.conv2d(x, w, stride=1, padding=1, plan=p_dir)
                 - t_h.conv2d(x, w, stride=1, padding=1, plan=p_gem)).abs().max())
    hp = t_h.engine.plan_conv((1, 512, 512, 64), (3, 3, 64, 64), stride=1, padding=1)
    return {
        "bench": "spatial_tiled_direct_conv",
        "layer": {"hw": 512, "cin": 64, "cout": 64, "k": 3, "pad": 1},
        "route": plan.route,
        "tau": plan.tau,
        "tile_rows": plan.tile_rows,
        "spatial_tiles": plan.spatial_tiles,
        "tile_cols": plan.tile_cols,
        "col_tiles": plan.col_tiles,
        "halo_mode": plan.halo_mode,
        "vmem_MiB": round(plan.vmem_bytes / 2**20, 1),
        "untiled_vmem_MiB": round(untiled / 2**20, 1),
        "budget_MiB": round(TPU_V5E.vmem_bytes / 2**20, 1),
        "two_block_tile_rows": two_blk.tile_rows,
        "vmem_MiB_two_block": round(vm["two_block"] / 2**20, 1),
        "vmem_MiB_dma_same_tile": round(vm["dma"] / 2**20, 1),
        "hbm_in_MiB_two_block": round(tr["two_block"] / 2**20, 1),
        "hbm_in_MiB_dma_same_tile": round(tr["dma"] / 2**20, 1),
        "vmem_ratio_dma_over_two_block": round(vm["dma"] / vm["two_block"], 3),
        "hbm_ratio_dma_over_two_block": round(tr["dma"] / tr["two_block"], 3),
        "small_layer_tiles": p_dir.spatial_tiles,
        "small_layer_halo": p_dir.halo_mode,
        "small_layer_direct": (f"TPU-planned tau={p_dir.tau} tile {p_dir.tile_rows}x"
                               f"{p_dir.tile_cols} on the direct conv's "
                               f"{p_dir.conv_route or 'cudacore'} route"),
        "small_layer_im2col": f"H100-planned GEMM route {p_gem.block.route}",
        "tiled_vs_im2col_max_err": err,
        "h100_route": f"{hp.route}/{hp.conv_route}",
        "h100_tau": hp.tau,
        "h100_sub_tile": (hp.sub_rows, hp.sub_cols),
        "h100_cin_chunk": hp.cin_chunk,
        "h100_splits": hp.splits,
        "h100_smem_KiB": round(hp.vmem_bytes / 2**10, 1),
    }


def spatial_shard_row(shards: int = 4, device="cuda") -> dict:
    """Spatial (H-slab) sharding row, as JSON.

    Structural: for every VGG16 @ 224² conv / pool seam under ``shards`` H
    slabs, the modeled bytes the halo exchange moves between neighbour
    shards, ``(S−1)·(up+dn)·N·W·C`` a seam, against the full-activation
    ring all-gather it replaces (``(S−1)·N·H·W·C`` a conv).  Every seam must
    exchange fewer bytes than the gather and the network total an order of
    magnitude fewer.  Numeric: the grid-resident q16 LeNet forward over 2
    slabs must equal the unsharded route bit for bit (no contraction
    crosses a slab).
    """
    from repro_torch.core.quantization import NumericsPolicy
    from repro_torch.core.template import default_template
    from repro_torch.models.cnn import (CNN_ZOO, LENET, cnn_forward, init_cnn,
                                        plan_cnn, quantize_cnn_params)
    from repro_torch.parallel.sharding import spatial_gather_bytes, spatial_halo_bytes

    spec = CNN_ZOO["vgg16"]
    n, itemsize = 1, 2  # q16 activation plane
    tpl = default_template("cuda", device=device)
    plan = plan_cnn(tpl, spec, (n, 224, 224, spec.input_ch), spatial=shards)
    hh, ww, ch = 224, 224, spec.input_ch
    layers = []
    halo_total = gather_total = 0
    for i, ((cout, k, stride, pad, pool), cp, ph) in enumerate(
            zip(spec.convs, plan.convs, plan.pool_halos)):
        halo = spatial_halo_bytes(cp.halo, n, ww, ch, itemsize)
        gather = spatial_gather_bytes(hh, n, ww, ch, shards, itemsize)
        hh = (hh + 2 * pad - k) // stride + 1
        ww = (ww + 2 * pad - k) // stride + 1
        ch = cout
        if pool:
            halo += spatial_halo_bytes(ph, n, ww, ch, itemsize)
            hh //= pool
            ww //= pool
        layers.append({"layer": f"conv{i}", "halo_bytes": halo, "gather_bytes": gather,
                       "ratio": round(halo / gather, 4)})
        halo_total += halo
        gather_total += gather
    # numeric differential: 2-slab grid-resident q16 LeNet, bitwise
    tq = default_template("q16", device=device)
    params = init_cnn(torch.Generator().manual_seed(0), LENET, device=device)
    policy = NumericsPolicy("q16")
    qp = quantize_cnn_params(tq, LENET, params, policy)
    x = (torch.randn((2, 32, 32, 1), generator=torch.Generator().manual_seed(1))
         * 0.5).to(device)
    want = cnn_forward(tq, LENET, qp, x, policy=policy)
    sp = plan_cnn(tq, LENET, x.shape, spatial=2)
    got = cnn_forward(tq, LENET, qp, x, policy=policy, plan=sp)
    return {
        "bench": "spatial_shard_halo_exchange",
        "net": "vgg16@224",
        "shards": shards,
        "halo_MiB_total": round(halo_total / 2**20, 2),
        "gather_MiB_total": round(gather_total / 2**20, 2),
        "bytes_ratio_halo_over_gather": round(halo_total / gather_total, 4),
        "per_layer_max_ratio": max(l["ratio"] for l in layers),
        "all_layers_halo_below_gather": all(
            l["halo_bytes"] < l["gather_bytes"] for l in layers),
        "layers": layers[:3] + layers[-1:],  # head + tail, keep the row short
        "lenet_q16_2shard_bitwise": bool(torch.equal(got, want)),
    }


def plan_store_warm_start_row(device="cuda") -> dict:
    """Cold-vs-warm plan time through a persisted store, as JSON.

    Plans a fixed shape set into an *isolated* registry (the process-global
    registries stay untouched), saves it, loads it into a fresh registry and
    plans again: the warm pass must run no DSE search.
    """
    import os
    import tempfile

    from repro_torch.core.engine import Engine, PlanRegistry
    from repro_torch.core.template import TemplateConfig

    gemms = [(256, 512, 256), (1024, 1024, 512), (4096, 1728, 5120)]
    convs = [((1, 32, 32, 16), (3, 3, 16, 32)), ((1, 224, 224, 3), (11, 11, 3, 64))]

    def plan_all(reg):
        eng = Engine(TemplateConfig(backend="cuda", device=device), plan_cache=reg)
        t0 = time.perf_counter()
        for m, n, k in gemms:
            eng.plan_gemm(m, n, k)
        for x_shape, w_shape in convs:
            eng.plan_conv(x_shape, w_shape, stride=1, padding=1)
        return time.perf_counter() - t0

    cold = PlanRegistry()
    cold_s = plan_all(cold)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        cold.save(path)
        warm = PlanRegistry()
        warm.load(path)
        warm_s = plan_all(warm)
    finally:
        os.unlink(path)
    return {
        "bench": "plan_store_warm_start",
        "entries": len(cold),
        "cold_plan_s": round(cold_s, 4),
        "warm_plan_s": round(warm_s, 4),
        "speedup": round(cold_s / max(warm_s, 1e-9), 1),
        "cold_misses": cold.misses,
        "warm_misses": warm.misses,
    }


def q16_residency_row(device="cuda") -> dict:
    """Fixed-point residency row, as JSON: the grid-resident LeNet forward
    (one quantize and one dequantize for the whole network, counted by the
    engine), its drift against float, and the structural per-token /
    per-sample activation bytes of the q16 and float paths (the q16 side
    must move at most half)."""
    from repro_torch.benchmarks.q16_drift import lenet_row, transformer_decode_bytes
    from repro_torch.configs import get_config, reduced

    lenet = lenet_row(batches=2, device=device)
    cfg = reduced(get_config("qwen2-0.5b"))
    row = {
        "bench": "q16_residency",
        "lenet_argmax_agreement": lenet["argmax_agreement"],
        "lenet_logit_mae": lenet["logit_mae"],
        "lenet_quantize_calls_per_fwd": lenet["quantize_calls"] // lenet["batches"],
        "lenet_dequantize_calls_per_fwd": lenet["dequantize_calls"] // lenet["batches"],
        "lenet_act_bytes": {"float": lenet["act_bytes_float"],
                            "q16": lenet["act_bytes_q16"]},
        "transformer_per_token_bytes": {
            "float": transformer_decode_bytes(cfg, 48, act_bytes=4, kv_bytes=4),
            "q16": transformer_decode_bytes(cfg, 48, act_bytes=2, kv_bytes=2),
        },
    }
    b = row["transformer_per_token_bytes"]
    row["bytes_ratio"] = round(b["q16"] / b["float"], 3)
    return row


def precision_dse_row(device="cuda") -> dict:
    """Mixed int8/int16 precision-DSE gate row, as JSON: the drift-aware
    per-layer DSE over the QAT-trained LeNet (memoized and shared with
    :mod:`repro_torch.benchmarks.precision_drift`, so one run pins one set of
    measured choices), gated on the two laws: an int8 layer moves exactly
    half the q16 activation bytes, and the composed mixed network keeps
    >= 99 % argmax agreement with its float reference."""
    from repro_torch.benchmarks.precision_drift import lenet_precision_sweep

    row = lenet_precision_sweep(device=device)
    return {
        "bench": "precision_dse",
        "net": row["net"],
        "budget": row["budget"],
        "base_fmt": row["base_fmt"],
        "plan": row["plan"],
        "int8_layers": row["int8_layers"],
        "argmax_agreement": row["argmax_agreement"],
        "act_bytes_q16": row["act_bytes_q16"],
        "act_bytes_mixed": row["act_bytes_mixed"],
        "int8_layer_bytes_q16": row["int8_layer_bytes_q16"],
        "int8_layer_bytes_mixed": row["int8_layer_bytes_mixed"],
        "int8_half_bytes_exact": all(
            row["int8_layer_bytes_mixed"][n] * 2 == row["int8_layer_bytes_q16"][n]
            for n in row["int8_layers"]),
    }


def scheduler_mixed_trace_row(device="cuda") -> dict:
    """Continuous-batching mixed-trace row, as JSON.

    A small mixed prompt-length trace through the serve scheduler on a
    virtual clock (``cuda`` backend: every GEMM consults the plan registry):
    decode coalescing (decode steps against the sequential equivalent),
    prefill coalescing (admitted rows per (B, L) launch, at most one launch
    an occupied bucket rung a tick), mean occupancy, the DSE searches after
    warm-up (must be 0: the bucket ladder is the point), and two requests'
    tokens against the unbatched ``generate()``.
    """
    from repro_torch.benchmarks.precision_drift import transformer_params
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.launch.scheduler import (
        SchedulerConfig, ServeScheduler, VirtualClock, replay_trace, synthetic_trace,
    )
    from repro_torch.launch.serve import generate

    cfg = reduced(get_config("qwen2-0.5b"))
    tpl = default_template("cuda", device=device)
    params = transformer_params(0, cfg, device)
    ladder = (8, 16)
    sched = ServeScheduler(cfg, params, tpl=tpl, clock=VirtualClock(),
                           sched=SchedulerConfig(ladder=ladder, slots=3, max_new_limit=3))
    sched.warmup()
    m0 = sched.registry.misses
    trace = synthetic_trace(6, seed=2, vocab=cfg.vocab, ladder=ladder, max_new=3)
    for r in trace:
        r.max_new = 3  # fixed budget: the coalescing ratio is then structural
    t0 = time.perf_counter()
    stats = replay_trace(sched, trace, tick=1.0)
    wall = time.perf_counter() - t0
    # the unbatched parity runs below plan their own exact-length shapes
    post_warmup_misses = sched.registry.misses - m0
    c = stats["counters"]
    sequential_steps = sum(r.max_new - 1 for r in trace)
    parity = all(
        [int(t) for t in sched.results[r.rid].generated]
        == generate(cfg, params, torch.tensor([r.prompt], device=device), gen=r.max_new,
                    tpl=tpl)[0].tolist()
        for r in trace[:2])
    # per tick, one coalesced launch per occupied rung, never one per row
    by_rid = {r.rid: r for r in trace}
    launches_bounded = all(
        ev["prefill_launches"] <= len({by_rid[rid].bucket for rid in ev["admitted"]})
        for ev in sched.history)
    sched.release()
    return {
        "bench": "scheduler_mixed_trace",
        "requests": len(trace),
        "ladder": list(ladder),
        "slots": 3,
        "completed": c["completed"],
        "decode_steps": c["decode_steps"],
        "sequential_decode_steps": sequential_steps,
        "prefill_launches": c["prefill_launches"],
        "prefill_rows": c["prefill_rows"],
        "prefill_coalescing": stats["prefill_coalescing"],
        "launches_bounded_by_rungs": launches_bounded,
        "ttft_p50": round(stats["ttft"].get("p50", 0.0), 3),
        "ttft_p99": round(stats["ttft"].get("p99", 0.0), 3),
        "mean_occupancy": stats["mean_occupancy"],
        "tokens": c["tokens"],
        "wall_s": round(wall, 3),
        "post_warmup_misses": post_warmup_misses,
        "byte_identical_vs_unbatched": parity,
    }


def router_failover_row(device="cuda") -> dict:
    """Replicated-serving failover row, as JSON (in-process, virtual clock).

    Two ``ServeScheduler`` replicas behind a ``ReplicaRouter``, one kill
    injected mid-stream by a ``FaultPlan``, sessions restored from the dead
    replica's checkpoint: the token ledger must equal an unkilled
    one-replica run's (no token lost or duplicated), every regenerated
    overlap token checked equal before it is suppressed as a duplicate.
    """
    import tempfile

    import numpy as np

    from repro_torch.benchmarks.precision_drift import transformer_params
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.launch.router import ReplicaRouter
    from repro_torch.launch.scheduler import (Request, SchedulerConfig, ServeScheduler,
                                              VirtualClock)
    from repro_torch.runtime.failover import FaultPlan

    cfg = reduced(get_config("qwen2-0.5b"))
    tpl = default_template("cuda", device=device)
    params = transformer_params(0, cfg, device)
    ladder = (8, 16, 24)  # top rung holds max prompt 16 + max_new 4 resume

    def make_sched(rid, clock):
        return ServeScheduler(cfg, params, tpl=tpl, clock=clock,
                              sched=SchedulerConfig(ladder=ladder, slots=3, max_new_limit=4))

    def trace(base_rid):
        rng = np.random.default_rng(3)
        return [Request(prompt=tuple(int(t) for t in rng.integers(0, 96, n)), max_new=4,
                        arrival=0.0, rid=base_rid + i)
                for i, n in enumerate([5, 9, 3, 15, 8, 16, 2, 11])]

    reference = ReplicaRouter(make_sched, 1, clock=VirtualClock())
    ref_trace = trace(50_000)
    reference.run(ref_trace)
    ref = {i: reference.ledger.tokens(r.rid) for i, r in enumerate(ref_trace)}

    with tempfile.TemporaryDirectory() as ckpt:
        router = ReplicaRouter(make_sched, 2, clock=VirtualClock(),
                               fault_plan=FaultPlan(kills=((2, 0),)),
                               checkpoint_dir=ckpt, checkpoint_every=1)
        kill_trace = trace(51_000)
        t0 = time.perf_counter()
        stats = router.run(kill_trace)
        wall = time.perf_counter() - t0
    got = {i: router.ledger.tokens(r.rid) for i, r in enumerate(kill_trace)}
    router.assert_exactly_once()
    c = stats["counters"]
    return {
        "bench": "router_failover",
        "replicas": 2,
        "requests": len(kill_trace),
        "kill_tick": 2,
        "ticks": stats["ticks"],
        "completed": stats["completed"],
        "killed": c.get("killed", 0),
        "restarted": c.get("restarted", 0),
        "requeued_sessions": c.get("requeued_sessions", 0),
        "restored_sessions": c.get("restored_sessions", 0),
        "restored_tokens": c.get("restored_tokens", 0),
        "duplicates_suppressed": stats["duplicates_suppressed"],
        "ledger_tokens": c.get("ledger_tokens", 0),
        "byte_identical_vs_unkilled": got == ref,
        "wall_s": round(wall, 3),
        "stats_line": router.stats_line(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where it runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = args.device
    out = {}

    print("== Kernel structural table (TPU v5e targets, the reference's plans) ==")
    print(f"{'gemm':28s} {'block':>16s} {'vmem':>6s} {'mxu':>5s} "
          f"{'AI':>6s} {'bound':>8s} {'mxu_us':>8s} {'hbm_us':>8s}")
    out["structural_tpu"] = structural_rows(TPU_V5E)
    for r in out["structural_tpu"]:
        print(f"{r['gemm']:28s} {str(r['block']):>16s} {r['vmem_MiB']:6.1f} "
              f"{r['mxu_eff']:5.2f} {r['ai']:6.1f} {r['bound']:>8s} "
              f"{r['mxu_us']:8.1f} {r['hbm_us']:8.1f}")
    print(f"\n== Kernel table (H100, the port's plans{', timed' if _is_cuda(dev) else ''}) ==")
    print(f"{'gemm':28s} {'num':5s} {'route':6s} {'block':>15s} {'splits':>6s} "
          f"{'smemKiB':>7s} {'AI':>7s} {'bound_ms':>9s} {'ms':>9s} {'library_ms':>10s}")
    out["structural_h100"] = structural_rows(H100, device=dev)
    for r in out["structural_h100"]:
        ms = f"{r['ms']:9.4f}" if "ms" in r else f"{'-':>9s}"
        lib = f"{r['library_ms']:10.4f}" if r.get("library_ms") is not None else f"{'-':>10s}"
        print(f"{r['gemm']:28s} {r['numerics']:5s} {r['route']:6s} {str(r['block']):>15s} "
              f"{r['splits']:6d} {r['smem_KiB']:7.1f} {r['ai']:7.1f} {r['bound_ms']:9.4f} "
              f"{ms} {lib}")
    for r in out["structural_h100"]:
        print(json.dumps(r))
    print(f"\n== Kernel correctness vs oracles ({'kernels' if _is_cuda(dev) else 'plain versions'}"
          f" on {dev}) ==")
    out["correctness"] = correctness_pass(dev)
    for k, v in out["correctness"].items():
        print(f"  {k:18s} max|err| = {v:.2e}")
    for k, v in out["correctness"].items():
        if k.endswith("_raw"):
            assert v == 0, f"{k}: the fixed-point kernel is not exact ({v})"
        else:
            assert v <= CORRECTNESS_TOL[k], f"{k}: {v} > {CORRECTNESS_TOL[k]}"
    print("\n== im2col vs direct conv route (JSON, append-able trajectory) ==")
    out["im2col_vs_direct"] = im2col_vs_direct_row(device=dev)
    print(json.dumps(out["im2col_vs_direct"]))
    print("\n== spatial-tiled direct conv (JSON, append-able trajectory) ==")
    tiled = out["spatial_tiling"] = spatial_tiling_row(device=dev)
    print(json.dumps(tiled))
    assert tiled["route"] == "direct" and tiled["spatial_tiles"] >= 2
    assert tiled["halo_mode"] == "dma" and tiled["col_tiles"] >= 2, \
        "the 512² layer must plan the (T, C) DMA-halo regime, not fall back"
    assert tiled["vmem_ratio_dma_over_two_block"] <= 0.6, \
        "DMA-halo VMEM residency must be at most 0.6x the two-block scheme"
    assert tiled["hbm_ratio_dma_over_two_block"] <= 0.6, \
        "DMA-halo input re-streaming must be at most 0.6x the two-block scheme"
    assert tiled["tiled_vs_im2col_max_err"] < 1e-4
    print("\n== plan store cold vs warm (JSON, append-able trajectory) ==")
    warm_row = out["plan_store_warm_start"] = plan_store_warm_start_row(device=dev)
    print(json.dumps(warm_row))
    assert warm_row["warm_misses"] == 0, "warm registry must not re-search"
    assert warm_row["cold_misses"] == warm_row["entries"]
    print("\n== q16 fixed-point residency (JSON, append-able trajectory) ==")
    qrow = out["q16_residency"] = q16_residency_row(device=dev)
    print(json.dumps(qrow))
    assert qrow["lenet_quantize_calls_per_fwd"] == 1, \
        "grid-resident LeNet must quantize only its input"
    assert qrow["lenet_dequantize_calls_per_fwd"] == 1, \
        "grid-resident LeNet must dequantize only its classifier read-out"
    assert qrow["bytes_ratio"] <= 0.5, \
        "q16 per-token activation bytes must be at most half the float path"
    assert qrow["lenet_argmax_agreement"] >= 0.99
    print("\n== precision DSE: mixed int8/int16 plan (JSON, append-able trajectory) ==")
    prow = out["precision_dse"] = precision_dse_row(device=dev)
    print(json.dumps(prow))
    assert prow["int8_layers"], \
        "the QAT-trained LeNet must drop at least one layer to the int8 rung"
    assert prow["int8_half_bytes_exact"], \
        "an int8-chosen layer must move exactly half the q16 activation bytes"
    assert prow["argmax_agreement"] >= 0.99, \
        "the composed mixed int8/int16 network fell below 99% argmax agreement"
    print("\n== continuous-batching mixed trace (JSON, append-able trajectory) ==")
    sched_row = out["scheduler_mixed_trace"] = scheduler_mixed_trace_row(device=dev)
    print(json.dumps(sched_row))
    assert sched_row["completed"] == sched_row["requests"]
    assert sched_row["post_warmup_misses"] == 0, \
        "bucketed traffic must not re-search after warmup"
    assert sched_row["byte_identical_vs_unbatched"], \
        "coalesced decode diverged from the unbatched path"
    assert sched_row["decode_steps"] < sched_row["sequential_decode_steps"]
    assert sched_row["prefill_launches"] < sched_row["requests"], \
        "bursty admissions must coalesce into fewer (B, L) prefill launches"
    assert sched_row["prefill_coalescing"] > 1.0
    assert sched_row["launches_bounded_by_rungs"], \
        "a tick issued more prefill launches than occupied bucket rungs"
    print("\n== replicated-serving failover (JSON, append-able trajectory) ==")
    frow = out["router_failover"] = router_failover_row(device=dev)
    print(json.dumps({k: v for k, v in frow.items() if k != "stats_line"}))
    print("  " + frow["stats_line"])
    assert frow["byte_identical_vs_unkilled"], \
        "failover changed the token ledger (lost or corrupted tokens)"
    assert frow["completed"] == frow["requests"]
    assert frow["killed"] == 1 and frow["restarted"] == 1
    assert frow["requeued_sessions"] > 0, \
        "the kill must catch in-flight sessions for the row to mean anything"
    print("\n== spatial H-slab sharding: halo vs gather bytes (JSON) ==")
    srow = out["spatial_shard"] = spatial_shard_row(device=dev)
    print(json.dumps(srow))
    assert srow["all_layers_halo_below_gather"], \
        "a layer's halo exchange moved >= the full-activation gather"
    assert srow["per_layer_max_ratio"] < 1.0
    assert srow["bytes_ratio_halo_over_gather"] < 0.1, \
        "network-total halo traffic should be an order below the gather"
    assert srow["lenet_q16_2shard_bitwise"], \
        "spatially-sharded q16 forward diverged bitwise from unsharded"
    print("\n== VGG16 @ 512x512 network plan on H100 (route/tile regressions diff here) ==")
    from repro_torch.core.template import default_template
    from repro_torch.models.cnn import CNN_ZOO, plan_cnn

    net = plan_cnn(default_template("cuda", device=dev), CNN_ZOO["vgg16"], (1, 512, 512, 3))
    out["vgg16_512_plan"] = net.describe()
    for line in out["vgg16_512_plan"]:
        print("  " + line)
    return out


if __name__ == "__main__":
    main()
