"""The port's benchmark scripts (``repro_torch/benchmarks/``) on the CPU,
held to the reference's scripts (``benchmarks/``) where those are exact.

* ``kernel_table``: the TPU_V5E structural rows equal the reference's with
  ``==`` (the planner returns the reference's plans there); the H100 rows'
  routes and tiles are ``Engine.block_for``'s on the ``cuda`` / ``q16``
  backends and their bounds the stated formula; the conv routes' bytes,
  the spatially tiled conv's structural fields (against the reference's
  ``Engine.plan_conv``, ``direct_conv_vmem``, ``direct_conv_input_traffic``
  and ``explore_conv_spatial`` under TPU_V5E) and the spatial sharding's
  halo and gather bytes equal the reference's; the kernels' plain versions
  meet their oracles (integers exact; floats within the reference's
  ``tests/test_kernels.py`` tolerances); every gate of ``main`` holds.
* ``precision_drift``'s structural bytes (LeNet, reduced and full
  transformer configs, uniform and mixed plans) equal the reference's.
* ``roofline_report`` over a real port record (``dryrun.run_cell``) and
  hand-made variants: the cells it picks and the numbers of its table equal
  the reference's report over the same numbers in the reference's record
  form; a refused record is listed apart and never picked.
* ``run.main`` with its modules stubbed: the consolidated JSON, an explicit
  argv to each module, exit 1 after a failed module, and the warm-store
  gate checked before the save.

The sweeps of ``precision_drift`` are held to the reference's in
``test_torch_bench_precision.py``; the H100 rows on the card in
``test_torch_kernel_table_gpu.py``.
"""
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmarks import kernel_table as jkt
from benchmarks import precision_drift as jpd
from benchmarks import roofline_report as jrr
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import dse as jdse
from repro.core import quantization as jq
from repro.core.engine import Engine as JEngine
from repro.core.engine import reset_plan_caches as j_reset
from repro.core.template import TemplateConfig as JTemplateConfig
from repro.core.template import default_template as j_template
from repro.core.tiling import TPU_V5E as J_TPU_V5E
from repro.models import cnn as jcnn
from repro.parallel import sharding as JS
from repro_torch.benchmarks import kernel_table, precision_drift, q16_drift, roofline_report, run
from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import (
    plan_cache_for,
    reset_plan_caches,
    save_plan_store,
)
from repro_torch.core.quantization import NumericsPolicy, Q2_6, Q2_14
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100, TPU_V5E
from repro_torch.launch import dryrun
from repro_torch.models import cnn as tcnn

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def kt_out():
    """``kernel_table.main`` on the CPU once for the file (every gate of the
    reference's ``main`` runs inside it)."""
    reset_plan_caches()
    out = kernel_table.main(["--device", "cpu"])
    yield out
    reset_plan_caches()


# ---------------------------------------------------------------------------
# kernel_table
# ---------------------------------------------------------------------------


def test_structural_rows_under_tpu_v5e_equal_the_reference():
    j_reset()
    assert kernel_table.structural_rows(TPU_V5E) == jkt.structural_rows()
    assert kernel_table.CASES == jkt.CASES


@pytest.mark.parametrize("label", list(kernel_table.CASES))
def test_h100_rows_plan_through_the_engine(kt_out, label):
    """Each case's bf16 and int16 rows carry ``Engine.block_for``'s plan on
    the ``cuda`` / ``q16`` backends, a shared memory the block can take,
    and max(bytes at the HBM rate, ops at the type's peak) as the bound."""
    m, n, k = kernel_table.CASES[label]
    rows = {r["numerics"]: r for r in kt_out["structural_h100"] if r["gemm"] == label}
    assert set(rows) == {"bf16", "int16"}
    planned = {
        "bf16": default_template("cuda", device="cpu").engine.block_for(
            m, n, k, dtype=torch.bfloat16),
        "int16": default_template("q16", device="cpu").engine.block_for(m, n, k),
    }
    peaks = {"bf16": H100.peak_bf16_flops, "int16": H100.peak_int8_ops / 4}
    for numerics, row in rows.items():
        blk = planned[numerics]
        assert (row["route"], row["block"], row["splits"]) == (
            blk.route, (blk.bm, blk.bn, blk.bk), blk.splits)
        assert row["smem_KiB"] * 2**10 <= H100.smem_per_block
        nbytes, ops = (m * k + k * n + m * n) * 2, 2 * m * n * k
        t_bytes, t_ops = nbytes / H100.hbm_bw * 1e3, ops / peaks[numerics] * 1e3
        assert row["bound_ms"] == max(t_bytes, t_ops)
        assert row["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
        assert row["ridge"] == round(H100.peak_bf16_flops / H100.hbm_bw, 1)
        assert "ms" not in row  # timed only on a card


def test_gemm_smem_bytes_follow_the_headers():
    """The shared memory of each route at its compiled tiles (the headers'
    sizes, written out)."""
    from repro_torch.core.tiling import MatmulBlock

    smem = kernel_table.gemm_smem_bytes
    # gemm_wgmma.cuh: 6 stages at BN 128, 4 at 256, 192 KB of ring either way
    assert smem(MatmulBlock(128, 128, 64, route="wgmma"), "matmul_fp") == 230496
    assert smem(MatmulBlock(128, 256, 64, route="wgmma"), "matmul_fp") == 230464
    # gemm_q16_wgmma.cuh: int16 x int16 at BN 64 (4 stages of 48 KB), int8 x int8 at
    # BN 128 (6 of 32 KB)
    assert smem(MatmulBlock(128, 64, 128, route="wgmma"), "matmul_q16") == 197696
    assert smem(MatmulBlock(128, 128, 128, route="wgmma"), "matmul_q16", 8, 8) == 197728
    # gemm_splitk.cuh: x's slice in 4-byte values, at least the reduction's 32 KB
    assert smem(MatmulBlock(8, 256, 128, route="splitk", splits=7), "matmul_fp") == 32768
    assert smem(MatmulBlock(16, 256, 1024, route="splitk"), "matmul_q16") == 65536
    tile = MatmulBlock(64, 64, 16)
    assert smem(tile, "matmul_fp") == tile.smem_bytes()
    assert all(smem(MatmulBlock(*t, route="wgmma"), "matmul_fp") <= H100.smem_per_block
               for t in H100.wgmma_tiles)


def test_correctness_pass_on_the_plain_versions(kt_out):
    corr = kt_out["correctness"]
    assert corr == kernel_table.correctness_pass("cpu")
    assert corr["matmul_q16_raw"] == corr["conv2d_q16_raw"] == 0
    for name, tol in kernel_table.CORRECTNESS_TOL.items():
        assert corr[name] <= tol, (name, corr[name])


def test_im2col_vs_direct_bytes_equal_the_reference(kt_out, monkeypatch):
    monkeypatch.setattr(jkt, "_time_conv", lambda *a, **kw: 0.0)  # its interpreter times
    want = jkt.im2col_vs_direct_row()
    got = kt_out["im2col_vs_direct"]
    for key in ("bench", "conv", "gemm_mnk", "im2col_gemm_bytes", "direct_gemm_bytes",
                "bytes_ratio_im2col_over_direct"):
        assert got[key] == want[key], key
    assert got["im2col_ms"] > 0 and got["direct_ms"] > 0
    assert got["direct_route"] == "direct/tc" and got["im2col_route"] == "im2col/tile"


def test_float_im2col_route_hands_the_gemm_dense_rows(monkeypatch):
    """One image's im2col columns are a transposed view of the unfold; the
    float GEMM kernel takes dense rows only, so the route makes them dense
    (the card raised on the view)."""
    from repro_torch.kernels import ops, ref

    seen = []
    real = ops.matmul_fp

    def spy(x, w, **kw):
        seen.append(x.is_contiguous())
        return real(x, w, **kw)

    monkeypatch.setattr(ops, "matmul_fp", spy)
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn((1, 9, 9, 4), generator=gen), torch.randn((3, 3, 4, 8), generator=gen)
    out = ops.conv2d(x, w, padding=1, route="im2col")
    assert seen == [True]
    torch.testing.assert_close(out, ref.conv2d_ref(x, w, padding=1), atol=1e-5, rtol=1e-5)


def test_spatial_tiling_structure_equals_the_reference_building_blocks(kt_out):
    row = kt_out["spatial_tiling"]
    eng = JEngine(JTemplateConfig(backend="pallas", interpret=True))
    plan = eng.plan_conv((1, 512, 512, 64), (3, 3, 64, 64), stride=1, padding=1)
    untiled = jdse.direct_conv_vmem(514, 514, 64, 3, 3, 512, 512, plan.tau or 64, 4)
    two = next(c for c in jdse.explore_conv_spatial(
        514, 514, 64, 3, 3, 512, 512, 64, 1, J_TPU_V5E, 4, top=4096)
        if c.halo_mode == "two_block")
    vm = {m: jdse.direct_conv_vmem(514, 514, 64, 3, 3, 512, 512, two.tau, 4,
                                   tile_rows=two.tile_rows, halo_mode=m)
          for m in ("two_block", "dma")}
    tr = {m: jdse.direct_conv_input_traffic(514, 514, 64, 3, 3, 512, 512, 64, 1, two.tau, 4,
                                            tile_rows=two.tile_rows, halo_mode=m)
          for m in ("two_block", "dma")}
    want = {
        "route": plan.route, "tau": plan.tau, "tile_rows": plan.tile_rows,
        "spatial_tiles": plan.spatial_tiles, "tile_cols": plan.tile_cols,
        "col_tiles": plan.col_tiles, "halo_mode": plan.halo_mode,
        "vmem_MiB": round(plan.vmem_bytes / 2**20, 1),
        "untiled_vmem_MiB": round(untiled / 2**20, 1),
        "budget_MiB": round(J_TPU_V5E.vmem_bytes / 2**20, 1),
        "two_block_tile_rows": two.tile_rows,
        "vmem_MiB_two_block": round(vm["two_block"] / 2**20, 1),
        "vmem_MiB_dma_same_tile": round(vm["dma"] / 2**20, 1),
        "hbm_in_MiB_two_block": round(tr["two_block"] / 2**20, 1),
        "hbm_in_MiB_dma_same_tile": round(tr["dma"] / 2**20, 1),
        "vmem_ratio_dma_over_two_block": round(vm["dma"] / vm["two_block"], 3),
        "hbm_ratio_dma_over_two_block": round(tr["dma"] / tr["two_block"], 3),
    }
    assert {k: row[k] for k in want} == want
    small = JEngine(JTemplateConfig(backend="pallas", interpret=True,
                                    hw=dataclasses.replace(J_TPU_V5E, vmem_bytes=256 * 1024))
                    ).plan_conv((1, 32, 32, 32), (3, 3, 32, 16), stride=1, padding=1)
    assert (row["small_layer_tiles"], row["small_layer_halo"]) == (small.spatial_tiles,
                                                                   small.halo_mode)
    assert row["small_layer_halo"] == "dma" and row["tiled_vs_im2col_max_err"] < 1e-4
    hp = default_template("cuda", device="cpu").engine.plan_conv(
        (1, 512, 512, 64), (3, 3, 64, 64), stride=1, padding=1)
    assert row["h100_route"] == f"direct/{hp.conv_route}" and row["h100_tau"] == hp.tau


def test_spatial_shard_bytes_equal_the_reference(kt_out):
    """Every VGG16@224 seam's halo and gather bytes under 4 slabs, from the
    reference's ``plan_cnn`` and byte models; the 2-slab q16 LeNet forward
    bit for bit its unsharded one."""
    row = kt_out["spatial_shard"]
    spec = jcnn.CNN_ZOO["vgg16"]
    plan = jcnn.plan_cnn(j_template("pallas"), spec, (1, 224, 224, spec.input_ch), spatial=4)
    hh = ww = 224
    ch = spec.input_ch
    layers, halo_total, gather_total = [], 0, 0
    for i, ((cout, k, stride, pad, pool), cp, ph) in enumerate(
            zip(spec.convs, plan.convs, plan.pool_halos)):
        halo = JS.spatial_halo_bytes(cp.halo, 1, ww, ch, 2)
        gather = JS.spatial_gather_bytes(hh, 1, ww, ch, 4, 2)
        hh, ww, ch = (hh + 2 * pad - k) // stride + 1, (ww + 2 * pad - k) // stride + 1, cout
        if pool:
            halo += JS.spatial_halo_bytes(ph, 1, ww, ch, 2)
            hh, ww = hh // pool, ww // pool
        layers.append({"layer": f"conv{i}", "halo_bytes": halo, "gather_bytes": gather,
                       "ratio": round(halo / gather, 4)})
        halo_total += halo
        gather_total += gather
    assert row["layers"] == layers[:3] + layers[-1:]
    assert row["halo_MiB_total"] == round(halo_total / 2**20, 2)
    assert row["gather_MiB_total"] == round(gather_total / 2**20, 2)
    assert row["bytes_ratio_halo_over_gather"] == round(halo_total / gather_total, 4)
    assert row["per_layer_max_ratio"] == max(x["ratio"] for x in layers)
    assert row["lenet_q16_2shard_bitwise"] is True


def test_residency_counts_and_rows_of_main(kt_out):
    q = kt_out["q16_residency"]
    assert q["lenet_quantize_calls_per_fwd"] == 1 and q["lenet_dequantize_calls_per_fwd"] == 1
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    assert q["transformer_per_token_bytes"] == {
        "float": jpd.transformer_decode_bytes(cfg_j, 48, act_bytes=4, kv_bytes=4),
        "q16": jpd.transformer_decode_bytes(cfg_j, 48, act_bytes=2, kv_bytes=2)}
    assert q["lenet_act_bytes"] == {
        "float": jpd.lenet_activation_bytes(jcnn.LENET, act_bytes=4),
        "q16": jpd.lenet_activation_bytes(jcnn.LENET, act_bytes=2)}
    w = kt_out["plan_store_warm_start"]
    assert w["warm_misses"] == 0 and w["cold_misses"] == w["entries"] == 5
    s = kt_out["scheduler_mixed_trace"]
    assert s["byte_identical_vs_unbatched"] and s["post_warmup_misses"] == 0
    assert s["completed"] == s["requests"] == 6 and s["prefill_launches"] < 6
    f = kt_out["router_failover"]
    assert f["byte_identical_vs_unkilled"] and f["killed"] == f["restarted"] == 1
    p = kt_out["precision_dse"]
    assert p["int8_half_bytes_exact"] and p["argmax_agreement"] >= 0.99
    assert kt_out["vgg16_512_plan"][0].startswith("conv0: route=direct")
    json.dumps(kt_out)  # run.py consolidates it


# ---------------------------------------------------------------------------
# precision_drift: the structural bytes
# ---------------------------------------------------------------------------


def _policies(names):
    """(port, reference) mixed policies: every subset of ``names`` on the
    int8 rung of Q2.14."""
    out = []
    for mask in range(1 << len(names)):
        low = [n for i, n in enumerate(names) if mask >> i & 1]
        out.append((
            NumericsPolicy("mixed", fmt=Q2_14,
                           layer_fmts=tuple((n, Q2_6 if n in low else Q2_14) for n in names)),
            jq.NumericsPolicy("mixed", fmt=jq.Q2_14,
                              layer_fmts=tuple((n, jq.Q2_6 if n in low else jq.Q2_14)
                                               for n in names))))
    return out


def test_lenet_structural_bytes_equal_the_reference():
    assert precision_drift.lenet_activation_elements(tcnn.LENET) == \
        jpd.lenet_activation_elements(jcnn.LENET)
    for b in (1, 2, 4):
        assert precision_drift.lenet_activation_bytes(tcnn.LENET, act_bytes=b) == \
            jpd.lenet_activation_bytes(jcnn.LENET, act_bytes=b)
    for net in ("alexnet", "vgg16"):
        assert precision_drift.lenet_activation_elements(tcnn.CNN_ZOO[net]) == \
            jpd.lenet_activation_elements(jcnn.CNN_ZOO[net])
    for pol, jpol in _policies(tcnn.cnn_layer_names(tcnn.LENET)):
        assert precision_drift.lenet_activation_bytes_mixed(tcnn.LENET, pol) == \
            jpd.lenet_activation_bytes_mixed(jcnn.LENET, jpol)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2.5-32b", "internlm2-1.8b",
                                  "mistral-nemo-12b"])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_transformer_structural_bytes_equal_the_reference(arch, size):
    from repro_torch.models import transformer as T

    cfg, cfg_j = get_config(arch), j_get_config(arch)
    if size == "reduced":
        cfg, cfg_j = reduced(cfg), j_reduced(cfg_j)
    for cache_len in (48, 4096):
        for ab, kb in ((4, 4), (2, 2), (1, 1), (2, 1)):
            assert precision_drift.transformer_decode_bytes(
                cfg, cache_len, act_bytes=ab, kv_bytes=kb) == jpd.transformer_decode_bytes(
                cfg_j, cache_len, act_bytes=ab, kv_bytes=kb)
        for pol, jpol in _policies(T.precision_group_names(cfg)[-3:]):
            assert precision_drift.transformer_decode_bytes_mixed(cfg, cache_len, pol) == \
                jpd.transformer_decode_bytes_mixed(cfg_j, cache_len, jpol)


def test_precision_drift_main_on_the_cpu(tmp_path):
    """The whole script with its gates on the port's own draws, writing its
    rows; ``q16_drift`` is its alias."""
    reset_plan_caches()
    out = tmp_path / "rows.json"
    rows = precision_drift.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    assert [r["bench"] for r in rows] == ["q16_drift_lenet", "q16_drift_transformer",
                                          "precision_dse_lenet", "precision_dse_transformer"]
    assert rows[0]["quantize_calls"] == rows[0]["dequantize_calls"] == rows[0]["batches"]
    assert rows[2]["act_bytes_q16"] - rows[2]["bytes_saved"] == rows[2]["act_bytes_mixed"]
    assert q16_drift.main is precision_drift.main
    assert q16_drift.train_lenet_qat is precision_drift.train_lenet_qat
    reset_plan_caches()


def test_train_lenet_qat_is_memoized_by_seed_steps_and_device():
    key = (5, 3, 2, "cpu")
    precision_drift._QAT_CACHE.pop(key, None)
    try:
        p = precision_drift.train_lenet_qat(5, 3, 2, device="cpu")
        assert precision_drift.train_lenet_qat(5, 3, 2, device="cpu") is p
        init = precision_drift.lenet_params(5, "cpu")
        for g in ("convs", "fcs"):
            for a, b in zip(p[g], init[g]):
                assert a["w"].shape == b["w"].shape and not a["w"].requires_grad
                assert torch.isfinite(a["w"]).all() and not torch.equal(a["w"], b["w"])
    finally:
        precision_drift._QAT_CACHE.pop(key, None)


# ---------------------------------------------------------------------------
# roofline_report
# ---------------------------------------------------------------------------


def _ref_form(rec: dict) -> dict:
    """A port record in the reference's form: ``hlo`` for ``ops``, the
    dominant term's key with ``_s``, the argument bytes as the device's
    total."""
    r = rec["roofline"]
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "kind", "chips", "tag",
                               "model_flops", "useful_ratio", "roofline_fraction")}
    out["roofline"] = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
    out["roofline"]["dominant"] = r["dominant"] + "_s"
    out["hlo"] = {"coll_bytes": rec["ops"]["coll_bytes"]}
    out["memory"] = {"per_device_total_bytes": rec["memory"]["argument_size_in_bytes"]}
    return out


@pytest.fixture(scope="module")
def roofline_dirs(tmp_path_factory):
    """A real record (qwen2-0.5b decode_32k on 16x16, ``dryrun.run_cell``)
    and hand-made variants of it (a train and a prefill cell, a
    collective-bound one, one over 80 GB, one refused, one on the other
    mesh), in the port's form and the reference's."""
    port_dir = tmp_path_factory.mktemp("dryrun_port")
    ref_dir = tmp_path_factory.mktemp("dryrun_ref")
    real = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, str(port_dir), device="cpu")
    variants = {"decode_32k": real}

    def variant(shape, kind, scale, **roof):
        rec = copy.deepcopy(real)
        rec.update(shape=shape, kind=kind, model_flops=real["model_flops"] * scale,
                   roofline_fraction=real["roofline_fraction"] * scale,
                   useful_ratio=min(1.0, real["useful_ratio"] * scale))
        rec["roofline"].update(roof)
        terms = {k: rec["roofline"][f"{k}_s"] for k in ("compute", "memory", "collective")}
        rec["roofline"]["dominant"] = max(terms, key=terms.get)
        return rec

    variants["train_4k"] = variant("train_4k", "train", 300.0, compute_s=2.5, memory_s=1.0,
                                   collective_s=0.5)
    variants["prefill_32k"] = variant("prefill_32k", "prefill", 40.0, compute_s=0.1,
                                      memory_s=0.3, collective_s=0.9)
    variants["train_big"] = variant("train_big", "train", 900.0, compute_s=4.0,
                                    memory_s=3.0, collective_s=0.1)
    variants["train_big"]["memory"]["argument_size_in_bytes"] = 90 * 10**9
    for name, rec in variants.items():
        if name != "decode_32k":
            (port_dir / f"qwen2-0.5b_{name}_16x16.json").write_text(json.dumps(rec))
        (ref_dir / f"qwen2-0.5b_{name}_16x16.json").write_text(json.dumps(_ref_form(rec)))
    refused = copy.deepcopy(real)
    refused["shape"] = "prefill_refused"
    for key in ("ops", "cost", "roofline", "model_flops", "useful_ratio", "roofline_fraction"):
        refused.pop(key)
    refused["analysis_refused"] = "row-parallel expert down"
    (port_dir / "qwen2-0.5b_prefill_refused_16x16.json").write_text(json.dumps(refused))
    other_mesh = dict(copy.deepcopy(real), mesh="2x16x16")
    (port_dir / "qwen2-0.5b_decode_32k_2x16x16.json").write_text(json.dumps(other_mesh))
    (port_dir / "skipped.json").write_text(json.dumps({"arch": "x", "shape": "y",
                                                       "skipped": "no"}))
    return port_dir, ref_dir


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _numbers(table: str) -> list:
    """The table's cells by row, the last column ("fits") left out."""
    rows = [line.split("|")[1:-1] for line in table.splitlines()
            if line.startswith("| ") and "compute_s" not in line]
    return [[c.strip() for c in r[:-1]] for r in rows]


def test_roofline_picks_and_numbers_equal_the_reference(roofline_dirs):
    port_dir, ref_dir = roofline_dirs
    rows = roofline_report.load(str(port_dir), "16x16")
    jrows = jrr.load(str(ref_dir), "16x16")
    assert len(rows) == 5 and len(jrows) == 4  # the refused record is read, then set apart
    assert roofline_report.pick_hillclimb_cells(rows) == jrr.pick_hillclimb_cells(jrows)
    got, want = _numbers(roofline_report.table(rows)), _numbers(jrr.table(jrows))
    assert got == want and len(got) == 4
    fits = {t["shape"]: t["fits"] for t in roofline_report.table_rows(rows)}
    assert fits == {"decode_32k": True, "prefill_32k": True, "train_4k": True,
                    "train_big": False}  # 90 GB: over an H100's 80, and over a v5e's 16
    for rec in roofline_report.analyzed(rows):
        want_advice = jrr._advice(_ref_form(rec)).replace("VMEM", "shared memory")
        assert roofline_report._advice(rec) == want_advice


def test_roofline_report_lists_refused_records_apart(roofline_dirs):
    port_dir, _ = roofline_dirs
    rows, text = _stdout(roofline_report.main, ["--dir", str(port_dir)])
    assert len(rows) == 5
    assert "refused (no terms): qwen2-0.5b prefill_refused 16x16: row-parallel" in text
    assert "prefill_refused" not in text.split("refused (no terms)")[0]
    picks = roofline_report.pick_hillclimb_cells(rows)
    assert "prefill_refused" not in json.dumps(picks)
    assert roofline_report.DEFAULT_DIR == dryrun.DEFAULT_OUT
    assert "lower bound" in text and "80 GB" in text
    other, _ = _stdout(roofline_report.main, ["--dir", str(port_dir), "--mesh", "2x16x16"])
    assert [r["mesh"] for r in other] == ["2x16x16"]


def test_roofline_report_runs_as_a_module_without_jax(roofline_dirs):
    """``python -m repro_torch.benchmarks.roofline_report`` with ``jax`` and
    ``repro`` blocked, its directory from ``$DRYRUN_OUT``."""
    port_dir, _ = roofline_dirs
    code = ("import runpy, sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "runpy.run_module('repro_torch.benchmarks.roofline_report', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  DRYRUN_OUT=str(port_dir)), cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    rows = roofline_report.load(str(port_dir), "16x16")
    assert res.stdout.startswith(roofline_report.table(rows))
    assert "hillclimb cell selection" in res.stdout


# ---------------------------------------------------------------------------
# run.py
# ---------------------------------------------------------------------------


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """``run.MODULES`` replaced by stub modules that record their argv; a stub
    may fail or run one DSE search.  Returns (calls, make)."""
    calls = {}
    reset_plan_caches()
    monkeypatch.delenv("REPRO_TORCH_PLAN_STORE", raising=False)
    monkeypatch.delenv("REPRO_PLAN_ASSERT_WARM", raising=False)
    monkeypatch.setenv("DRYRUN_OUT", str(tmp_path / "no_records"))

    def make(*specs):
        names = []
        for name, behaviour in specs:
            mod = types.ModuleType(f"repro_torch.benchmarks.{name}")

            def main(argv, name=name, behaviour=behaviour):
                calls[name] = argv
                if behaviour == "search":
                    plan_cache_for(H100).block_for(777, 333, 111, H100)
                if behaviour == "fail":
                    raise RuntimeError("a broken module")
                return [{"module": name}]

            mod.main = main
            monkeypatch.setitem(sys.modules, mod.__name__, mod)
            names.append(name)
        monkeypatch.setattr(run, "MODULES", tuple(names))

    yield calls, make
    reset_plan_caches()


def test_run_writes_one_json_and_passes_each_module_its_argv(stubbed, tmp_path, monkeypatch,
                                                             roofline_dirs):
    calls, make = stubbed
    make(("table1", "ok"), ("kernel_table", "ok"), ("router_soak", "ok"))
    monkeypatch.setenv("DRYRUN_OUT", str(roofline_dirs[0]))
    out = tmp_path / "bench.json"
    monkeypatch.setattr(sys, "argv", ["run.py", "--device", "cpu", "--unrelated"])
    results, text = _stdout(run.main, ["--device", "cpu", "--out", str(out)])
    assert calls == {"table1": [], "kernel_table": ["--device", "cpu"],
                     "router_soak": ["--device", "cpu"]}
    got = json.loads(out.read_text())
    assert got == json.loads(json.dumps(results))
    assert got["kernel_table"] == [{"module": "kernel_table"}]
    roof = got["roofline_report:baseline"]
    rows = roofline_report.load(str(roofline_dirs[0]), "16x16")
    assert roof["rows"] == json.loads(json.dumps(roofline_report.table_rows(rows)))
    assert roof["refused"] == [["qwen2-0.5b", "prefill_refused", "16x16"]]
    assert "roofline_report:optimized" not in got and "all benchmarks completed" in text
    assert run.module_argv("precision_drift", "cuda") == ["--device", "cuda"]
    assert run.module_argv("dse_sweep", "cuda") == []


def test_run_default_modules_are_the_reference_order():
    assert run.MODULES == ("table1", "table2", "dse_sweep", "kernel_table", "precision_drift",
                    "scheduler_soak", "router_soak")
    assert run.DEFAULT_OUT == ROOT / "build" / "bench_torch.json"


def test_run_exits_1_after_a_failed_module(stubbed, tmp_path):
    calls, make = stubbed
    make(("table1", "ok"), ("kernel_table", "fail"), ("precision_drift", "ok"))
    out = tmp_path / "bench.json"
    with pytest.raises(SystemExit) as e:
        _stdout(run.main, ["--device", "cpu", "--out", str(out)])
    assert e.value.code == 1
    assert set(calls) == {"table1", "kernel_table", "precision_drift"}  # the rest still ran
    assert set(json.loads(out.read_text())) == {"table1", "precision_drift"}


def test_run_warm_gate_is_checked_before_the_save(stubbed, tmp_path, monkeypatch):
    """Under ``REPRO_PLAN_ASSERT_WARM=1`` a run that searches fails and leaves
    the store as it was; a run that searches nothing passes and saves."""
    calls, make = stubbed
    store = tmp_path / "store.json"
    plan_cache_for(H100).block_for(64, 64, 64, H100)
    save_plan_store(str(store))
    before = store.read_bytes()
    reset_plan_caches()
    monkeypatch.setenv("REPRO_TORCH_PLAN_STORE", str(store))
    monkeypatch.setenv("REPRO_PLAN_ASSERT_WARM", "1")
    make(("table1", "search"))
    with pytest.raises(SystemExit) as e:
        _, text = _stdout(run.main, ["--device", "cpu", "--out", str(tmp_path / "a.json")])
    assert e.value.code == 1
    assert store.read_bytes() == before
    reset_plan_caches()
    make(("table1", "ok"))
    _, text = _stdout(run.main, ["--device", "cpu", "--out", str(tmp_path / "b.json")])
    assert "warm-start OK: zero DSE searches" in text and f"saved to {store}" in text


def test_run_warm_gate_needs_a_store(stubbed, tmp_path, monkeypatch):
    calls, make = stubbed
    monkeypatch.setenv("REPRO_TORCH_PLAN_STORE", str(tmp_path / "missing.json"))
    monkeypatch.setenv("REPRO_PLAN_ASSERT_WARM", "1")
    make(("table1", "ok"))
    with pytest.raises(SystemExit) as e:
        _stdout(run.main, ["--device", "cpu", "--out", str(tmp_path / "a.json")])
    assert e.value.code == 1 and not (tmp_path / "missing.json").exists()
