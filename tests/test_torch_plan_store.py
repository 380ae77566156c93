"""The port's plan store and measured-time pinning, on the CPU.

* The reference's ``tests/test_plan_registry.py`` single-device cases on the
  port: the save -> clear -> load round trip (GEMM plans of both kernels,
  direct-conv choices, no-fit sentinels, precision pins) with zero searches
  afterwards; rejection of corrupt, mismatched and half-valid stores; the
  measured pin's provenance, its survival of every merge; the global
  store's env round trip, merge on save and tolerant warm start; a warm
  ``serve`` run with zero searches.  Its store migrations (v1 / v2) have no
  counterpart: the port's store starts at version 1.
* ``tests/test_plan_store_crash.py`` with port-only subprocess scripts: a
  writer killed mid-stage or mid-commit leaves the store loadable, and the
  next save removes its litter.
* ``tests/test_scheduler.py``'s ladder round trip and
  ``tests/test_mixed_precision.py``'s q8 warm restart across processes.
* Against the reference: under ``TPU_V5E`` the port's document, cut to the
  reference's fields, equals the reference's ``to_doc()`` for the same
  plans and pins; a reference store is refused by ``load`` and ignored by
  ``warm_start_plan_store``; an H100 spec round-trips to ``== H100`` and a
  warm H100 registry plans nothing.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.core.engine import Engine as JEngine
from repro.core.engine import PlanRegistry as JPlanRegistry
from repro.core.quantization import Q2_6 as J_Q2_6
from repro.core.quantization import Q2_14 as J_Q2_14
from repro.core.template import TemplateConfig as JTemplateConfig
from repro.core.tiling import TPU_V5E as J_TPU_V5E
from repro_torch.core import dse
from repro_torch.core.engine import (
    PLAN_STORE_ENV,
    Engine,
    PlanRegistry,
    PlanStoreError,
    PrecisionChoice,
    load_plan_store,
    plan_cache_for,
    plan_store_stats,
    register_plan_store,
    reset_plan_caches,
    save_plan_store,
    warm_start_plan_store,
)
from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.template import TemplateConfig
from repro_torch.core.tiling import H100, TPU_V5E, GpuSpec, MatmulBlock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# so small that no direct configuration fits the (1, 64, 64, 32) x (3, 3,
# 32, 64) layer: a cached no-fit sentinel plus its im2col GEMM plan
TINY_HW = dataclasses.replace(TPU_V5E, vmem_bytes=16 * 1024)


def _cfg(backend="cuda", hw=H100):
    return TemplateConfig(backend=backend, hw=hw, device="cpu")


def _populated_registry():
    """A registry holding float and q16 GEMM plans and a direct conv under
    H100, and (a tiny-VMEM TPU spec) a no-fit sentinel with its im2col plan."""
    reg = PlanRegistry()
    eng = Engine(_cfg(), plan_cache=reg)
    g = eng.plan_gemm(256, 512, 256)
    c = eng.plan_conv((1, 32, 32, 8), (3, 3, 8, 16), stride=1, padding=1)
    gq = Engine(_cfg("q16"), plan_cache=reg).plan_gemm(4, 512, 256)
    tiny = Engine(_cfg(hw=TINY_HW), plan_cache=reg)
    c_nofit = tiny.plan_conv((1, 64, 64, 32), (3, 3, 32, 64))
    assert c.route == "direct" and c_nofit.route == "im2col"
    return reg, (g, c, gq, c_nofit)


def _forbid_searches(monkeypatch):
    def boom(*a, **kw):  # pragma: no cover - only fires on regression
        raise AssertionError("a DSE search ran against a warm registry")

    for name in ("default_block_for", "default_fp_block_for", "default_q16_block_for",
                 "default_conv_tile_for"):
        monkeypatch.setattr(dse, name, boom)


# ---------------------------------------------------------------------------
# serialization round trip
# ---------------------------------------------------------------------------


def test_round_trip_bit_identical(tmp_path, monkeypatch):
    reg, (g, c, gq, c_nofit) = _populated_registry()
    path = str(tmp_path / "store.json")
    reg.save(path)
    doc = reg.to_doc()
    loaded = PlanRegistry()
    assert loaded.load(path) == len(reg) > 0
    assert loaded.to_doc() == doc, "the round trip must be bit-identical"
    assert loaded.misses == 0 and loaded.hits == 0, "loads are not lookups"
    _forbid_searches(monkeypatch)
    assert Engine(_cfg(), plan_cache=loaded).plan_gemm(256, 512, 256) == g
    assert Engine(_cfg(), plan_cache=loaded).plan_conv(
        (1, 32, 32, 8), (3, 3, 8, 16), stride=1, padding=1) == c
    assert Engine(_cfg("q16"), plan_cache=loaded).plan_gemm(4, 512, 256) == gq
    assert Engine(_cfg(hw=TINY_HW), plan_cache=loaded).plan_conv(
        (1, 64, 64, 32), (3, 3, 32, 64)) == c_nofit
    assert loaded.misses == 0


def test_no_fit_sentinel_round_trips(tmp_path):
    reg, _ = _populated_registry()
    assert None in reg._conv_tiles.values(), "premise: a no-fit entry exists"
    path = str(tmp_path / "store.json")
    reg.save(path)
    loaded = PlanRegistry()
    loaded.load(path)
    assert None in loaded._conv_tiles.values()
    assert set(loaded._conv_tiles) == set(reg._conv_tiles)


def test_store_is_versioned_json_of_its_own_format(tmp_path):
    reg, _ = _populated_registry()
    path = str(tmp_path / "store.json")
    reg.save(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["format"] == "repro-torch-plan-store" and doc["version"] == 1
    assert doc["specs"] and doc["gemm"] and doc["conv"] and "precision" in doc
    assert {s["kind"] for s in doc["specs"]} == {"gpu", "tpu"}
    assert {e["kernel"] for e in doc["gemm"]} == {"matmul_fp", "matmul_q16"}
    for e in doc["gemm"]:
        assert e["route"] in ("tile", "splitk", "wgmma") and e["splits"] >= 1
        assert ("dtype_bytes" in e) == (e["kernel"] == "matmul_fp")
        assert ("xbits" in e and "wbits" in e) == (e["kernel"] == "matmul_q16")
    assert all(e["source"] in ("analytic", "measured") for e in doc["gemm"] + doc["conv"])
    assert any(e["choice"] and e["choice"]["route"] for e in doc["conv"])


def test_gpu_spec_round_trips_to_h100_and_a_warm_registry_plans_nothing(tmp_path,
                                                                        monkeypatch):
    """JSON turns GpuSpec's nested tuples into lists: the loaded spec must be
    H100 again (hashable, equal), or a warm start would plan everything."""
    reg = PlanRegistry()
    eng, eq = Engine(_cfg(), plan_cache=reg), Engine(_cfg("q16"), plan_cache=reg)
    shapes = [(4, 4864, 896), (64, 896, 896), (4, 151936, 896)]
    plans = [eng.plan_gemm(*s) for s in shapes] + [eq.plan_gemm(*s) for s in shapes]
    path = str(tmp_path / "h100.json")
    reg.save(path)
    loaded = PlanRegistry()
    loaded.load(path)
    (spec,) = loaded.specs()
    assert spec == H100 and hash(spec) == hash(H100)
    assert isinstance(spec.wgmma_tiles[0], tuple)
    _forbid_searches(monkeypatch)
    eng, eq = Engine(_cfg(), plan_cache=loaded), Engine(_cfg("q16"), plan_cache=loaded)
    assert [eng.plan_gemm(*s) for s in shapes] + [eq.plan_gemm(*s) for s in shapes] == plans
    assert loaded.misses == 0 and loaded.hits == 2 * len(shapes)


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d["specs"][0].update(warp_size=32), "fields"),
    (lambda d: d["specs"][0].update(kind="fpga"), "kind"),
    (lambda d: d["specs"][0].pop("kind"), "kind"),
])
def test_spec_document_is_strict(tmp_path, mutate, match):
    reg, _ = _populated_registry()
    doc = reg.to_doc()
    mutate(doc)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(doc))
    fresh = PlanRegistry()
    with pytest.raises(PlanStoreError, match=match):
        fresh.load(str(path))
    assert len(fresh) == 0


# ---------------------------------------------------------------------------
# precision pins
# ---------------------------------------------------------------------------


def test_precision_pin_round_trip(tmp_path):
    reg, _ = _populated_registry()
    reg.pin_precision("lenet", "conv0", Q2_6, drift=1.0)
    reg.pin_precision("lenet", "fc2", Q2_14, drift=0.97)
    path = str(tmp_path / "store.json")
    reg.save(path)
    loaded = PlanRegistry()
    assert loaded.load(path) == len(reg) > 0
    assert loaded.misses == 0 and loaded.hits == 0
    assert loaded.to_doc() == reg.to_doc()
    assert loaded.precision_plan("lenet") == {"conv0": Q2_6, "fc2": Q2_14}
    assert loaded.precision_for("lenet", "conv0") == PrecisionChoice(Q2_6, 1.0)
    assert loaded.hits == 1 and loaded.misses == 0


def test_precision_miss_charged_by_pin_not_lookup():
    reg = PlanRegistry()
    assert reg.precision_for("net", "l0") is None
    assert reg.misses == 0 and reg.hits == 0
    reg.pin_precision("net", "l0", Q2_6, drift=0.995)
    assert reg.misses == 1
    reg.pin_precision("net", "l1", Q2_14, searched=False)
    assert reg.misses == 1


def test_bad_precision_entry_rejected(tmp_path):
    reg, _ = _populated_registry()
    reg.pin_precision("lenet", "conv0", Q2_6, drift=1.0)
    doc = reg.to_doc()
    doc["precision"][0]["fmt"] = [2, 6]
    path = tmp_path / "badprec.json"
    path.write_text(json.dumps(doc))
    fresh = PlanRegistry()
    with pytest.raises(PlanStoreError, match="precision"):
        fresh.load(str(path))
    assert len(fresh) == 0


# ---------------------------------------------------------------------------
# rejection of bad stores
# ---------------------------------------------------------------------------


def test_corrupted_store_rejected(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{this is not json")
    with pytest.raises(PlanStoreError):
        PlanRegistry().load(str(path))


@pytest.mark.parametrize("version", [0, 2, 3, 999])
def test_version_mismatch_rejected(tmp_path, version):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"format": "repro-torch-plan-store", "version": version,
                                "specs": [], "gemm": [], "conv": [], "precision": []}))
    with pytest.raises(PlanStoreError, match="version"):
        PlanRegistry().load(str(path))


def test_wrong_format_rejected(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"format": "something-else", "version": 1}))
    with pytest.raises(PlanStoreError, match="format"):
        PlanRegistry().load(str(path))


def test_rejected_store_leaves_registry_untouched(tmp_path):
    reg, _ = _populated_registry()
    doc = reg.to_doc()
    doc["conv"].append({"spec": 99, "key": [1] * 10, "choice": None})  # bad spec
    path = tmp_path / "half.json"
    path.write_text(json.dumps(doc))
    fresh = PlanRegistry()
    with pytest.raises(PlanStoreError):
        fresh.load(str(path))
    assert len(fresh) == 0, "valid entries must not leak from a rejected store"


_GEMM = {"kernel": "matmul_fp", "dtype_bytes": 4, "route": "tile", "splits": 1}


@pytest.mark.parametrize("entry,n_specs", [
    ({"spec": 0, "key": [1, 2, 3], "block": [16, 64, 16], **_GEMM}, 0),  # spec missing
    ({"spec": -1, "key": [1, 2, 3], "block": [16, 64, 16], **_GEMM}, 1),  # negative
    ({"spec": 0, "key": [1, 2], "block": [16, 64, 16], **_GEMM}, 1),  # short key
    ({"spec": 0, "key": [1, 2, 3], "block": [512], **_GEMM}, 1),  # short block
    ({"spec": 0, "key": [1, 2, 3], "block": [16, 64, 16], **_GEMM, "kernel": "mm"}, 1),
    ({"spec": 0, "key": [1, 2, 3], "block": [16, 64, 16], "kernel": "matmul_q16",
      "xbits": 12, "wbits": 16, "route": "tile", "splits": 1}, 1),  # bad widths
    ({"spec": 0, "key": [1, 2, 3], "block": [16, 64, 16], "kernel": "matmul_fp",
      "route": "tile", "splits": 1}, 1),  # no dtype
])
def test_structurally_broken_store_rejected(tmp_path, entry, n_specs):
    from repro_torch.core.engine import _spec_to_doc

    path = tmp_path / "broken.json"
    path.write_text(json.dumps({
        "format": "repro-torch-plan-store", "version": 1,
        "specs": [_spec_to_doc(H100)] * n_specs, "gemm": [entry], "conv": [],
        "precision": [],
    }))
    with pytest.raises(PlanStoreError):
        PlanRegistry().load(str(path))


def test_missing_file_rejected_unless_missing_ok(tmp_path):
    with pytest.raises(PlanStoreError):
        PlanRegistry().load(str(tmp_path / "nope.json"))
    assert load_plan_store(str(tmp_path / "nope.json"), missing_ok=True) == 0


# ---------------------------------------------------------------------------
# the reference's store: never read by accident
# ---------------------------------------------------------------------------


def _reference_registry():
    reg = JPlanRegistry()
    eng = JEngine(JTemplateConfig(backend="pallas", interpret=True), plan_cache=reg)
    eng.plan_gemm(256, 512, 256)
    eng.plan_gemm(8, 128, 64)
    eng.plan_conv((1, 32, 32, 8), (3, 3, 8, 16), stride=1, padding=1)
    tiny = JEngine(JTemplateConfig(backend="pallas", interpret=True,
                                   hw=dataclasses.replace(J_TPU_V5E, vmem_bytes=16 * 1024)),
                   plan_cache=reg)
    tiny.plan_conv((1, 64, 64, 32), (3, 3, 32, 64))
    reg.pin_precision("lenet", "conv0", J_Q2_6, drift=1.0)
    reg.pin_precision("lenet", "fc2", J_Q2_14, drift=0.97)
    return reg


def test_tpu_document_equals_the_reference_field_for_field():
    """Under TPU_V5E the port plans the reference's blocks and conv choices;
    its document, cut to the reference's fields, is the reference's."""
    want = _reference_registry().to_doc()
    reg = PlanRegistry()
    eng = Engine(_cfg(hw=TPU_V5E), plan_cache=reg)
    eng.plan_gemm(256, 512, 256)
    eng.plan_gemm(8, 128, 64)
    eng.plan_conv((1, 32, 32, 8), (3, 3, 8, 16), stride=1, padding=1)
    Engine(_cfg(hw=TINY_HW), plan_cache=reg).plan_conv((1, 64, 64, 32), (3, 3, 32, 64))
    reg.pin_precision("lenet", "conv0", Q2_6, drift=1.0, spec=TPU_V5E)
    reg.pin_precision("lenet", "fc2", Q2_14, drift=0.97, spec=TPU_V5E)
    got = reg.to_doc()

    def cut(doc, section):
        fields = set(want[section][0]) if section != "conv" else {"spec", "key", "choice",
                                                                   "source"}
        out = []
        for e in doc[section]:
            e = {k: v for k, v in e.items() if k in fields}
            if section == "conv" and e["choice"] is not None:
                e["choice"] = {k: v for k, v in e["choice"].items()
                               if k in {"tau", "tile_rows", "spatial_tiles", "vmem_bytes",
                                        "score", "tile_cols", "col_tiles", "halo_mode"}}
            out.append(e)
        return out

    assert [{k: v for k, v in s.items() if k != "kind"} for s in got["specs"]] == \
        want["specs"]
    assert {s["kind"] for s in got["specs"]} == {"tpu"}
    for section in ("gemm", "conv", "precision"):
        assert cut(got, section) == want[section], section
    assert all(e["route"] == "tile" and e["splits"] == 1 for e in got["gemm"])


def test_reference_store_is_refused(tmp_path):
    path = str(tmp_path / "reference.json")
    _reference_registry().save(path)
    fresh = PlanRegistry()
    with pytest.raises(PlanStoreError, match="format"):
        fresh.load(path)
    assert len(fresh) == 0
    reset_plan_caches()
    with pytest.warns(UserWarning, match="unusable plan store"):
        assert warm_start_plan_store(path) == (path, 0)
    assert plan_store_stats()["gemm_blocks"] == 0
    # and the reference refuses the port's store
    port = str(tmp_path / "port.json")
    _populated_registry()[0].save(port)
    from repro.core.engine import PlanStoreError as JPlanStoreError

    with pytest.raises(JPlanStoreError, match="format"):
        JPlanRegistry().load(port)


# ---------------------------------------------------------------------------
# measured-time pinning
# ---------------------------------------------------------------------------


def test_measure_and_pin_overwrites_with_provenance(tmp_path):
    reg = PlanRegistry()
    kw = dict(kernel="matmul_fp", dtype_bytes=4)
    analytic = reg.block_for(128, 256, 128, **kw)
    assert reg.source_for(128, 256, 128, **kw) == "analytic"
    pinned = reg.measure_and_pin(128, 256, 128, reps=1, device="cpu")
    assert reg.source_for(128, 256, 128, **kw) == "measured"
    assert reg.stats()["measured"] == 1
    assert {blk for blk, _ in reg.last_measurement} >= {pinned, analytic}
    misses = reg.misses
    assert reg.block_for(128, 256, 128, **kw) == pinned
    assert reg.misses == misses
    path = str(tmp_path / "store.json")
    reg.save(path)
    loaded = PlanRegistry()
    loaded.load(path)
    assert loaded.source_for(128, 256, 128, **kw) == "measured"
    assert loaded.block_for(128, 256, 128, **kw) == pinned


@pytest.mark.parametrize("kernel,m,dtype_bytes", [("matmul_fp", 4, 2), ("matmul_fp", 64, 2),
                                                  ("matmul_fp", 64, 4), ("matmul_q16", 4, 4),
                                                  ("matmul_q16", 64, 4)])
def test_measure_and_pin_candidates_are_legal_plans_across_routes(kernel, m, dtype_bytes):
    n, k = 512, 256
    fp = kernel == "matmul_fp"
    cands = dse.explore_gemm_plans(m, n, k, H100, kernel=kernel, dtype_bytes=dtype_bytes,
                                   top=8)
    legal = [dse.fp_block_legal(b, m, n, k, dtype_bytes=dtype_bytes, spec=H100) if fp
             else dse.q16_block_legal(b, m, n, k, xbits=16, wbits=16, spec=H100)
             for b in cands]
    assert all(legal) and len(set(cands)) == len(cands) >= 3
    analytic = (dse.default_fp_block_for(m, n, k, H100, dtype_bytes=dtype_bytes) if fp
                else dse.default_q16_block_for(m, n, k, H100))
    assert cands[0] == analytic
    routes = [b.route for b in cands]
    if m <= H100.splitk_max_m:
        assert routes[:3] == ["splitk"] * 3 and len({b.splits for b in cands[:3]}) == 3
    elif fp and dtype_bytes == 4:
        assert set(routes) == {"tile"}
    else:  # int16 x int16 takes only the BN 64 tensor-core tile
        n_wgmma = 2 if fp else 1
        assert routes[:n_wgmma + 1] == ["wgmma"] * n_wgmma + ["tile"]


def test_measure_and_pin_picks_from_candidates():
    reg = PlanRegistry()
    cands = [MatmulBlock(16, 64, 16), MatmulBlock(64, 64, 16)]
    best = reg.measure_and_pin(256, 128, 128, candidates=cands, reps=1, device="cpu")
    assert best in cands


def test_merge_never_downgrades_measured_pins(tmp_path, monkeypatch):
    reset_plan_caches()
    kw = dict(kernel="matmul_fp", dtype_bytes=4)
    path = str(tmp_path / "shared.json")
    a = PlanRegistry()
    pinned = a.measure_and_pin(128, 256, 128, reps=1, device="cpu")
    a.save(path)
    monkeypatch.setenv(PLAN_STORE_ENV, path)
    plan_cache_for(H100).block_for(128, 256, 128, H100, **kw)
    save_plan_store()
    check = PlanRegistry()
    check.load(path)
    assert check.source_for(128, 256, 128, **kw) == "measured"
    assert check.block_for(128, 256, 128, **kw) == pinned
    b = PlanRegistry()
    b.block_for(128, 256, 128, **kw)
    a.merge_doc(b.to_doc())
    assert a.source_for(128, 256, 128, **kw) == "measured"
    reset_plan_caches()


@pytest.mark.parametrize("backend,kernel", [("cuda", "matmul_fp"), ("q16", "matmul_q16")])
def test_engine_measure_and_pin_uses_engine_spec(backend, kernel):
    reg = PlanRegistry()
    eng = Engine(_cfg(backend), plan_cache=reg)
    blk = eng.measure_and_pin(128, 128, 128, reps=1)
    assert reg.source_for(128, 128, 128, H100, kernel=kernel) == "measured"
    assert eng.plan_gemm(128, 128, 128).block == blk


def test_engine_measure_and_pin_under_tpu_spec_ranks_the_reference_blocks():
    reg = PlanRegistry()
    eng = Engine(_cfg(hw=TPU_V5E), plan_cache=reg)
    blk = eng.measure_and_pin(128, 128, 128, reps=1)
    assert [b for b, _ in reg.last_measurement] == dse.explore_gemm_plans(
        128, 128, 128, TPU_V5E, top=3)
    assert reg.source_for(128, 128, 128, TPU_V5E, kernel="matmul_fp") == "measured"
    assert eng.plan_gemm(128, 128, 128).block == blk


# ---------------------------------------------------------------------------
# the global store
# ---------------------------------------------------------------------------


def test_global_store_env_round_trip(tmp_path, monkeypatch):
    reset_plan_caches()
    path = str(tmp_path / "global.json")
    monkeypatch.setenv(PLAN_STORE_ENV, path)
    plan_cache_for(H100).block_for(64, 128, 64, H100)
    plan_cache_for(TINY_HW).block_for(32, 128, 32, TINY_HW)
    save_plan_store()
    reset_plan_caches()
    assert plan_store_stats()["gemm_blocks"] == 0
    assert warm_start_plan_store() == (path, 2)
    st = plan_store_stats()
    assert st["gemm_blocks"] == 2 and st["misses"] == 0
    assert len(plan_cache_for(H100)) == 1 and len(plan_cache_for(TINY_HW)) == 1
    reset_plan_caches()


def test_warm_start_no_env_is_noop(monkeypatch):
    monkeypatch.delenv(PLAN_STORE_ENV, raising=False)
    assert warm_start_plan_store() == (None, 0)
    with pytest.raises(ValueError):
        save_plan_store()


def test_warm_start_tolerates_unusable_store(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{definitely not json")
    with pytest.warns(UserWarning, match="unusable plan store"):
        assert warm_start_plan_store(str(path)) == (str(path), 0)
    with pytest.raises(PlanStoreError):
        load_plan_store(str(path))


def test_save_plan_store_merges_existing_file(tmp_path):
    reset_plan_caches()
    path = str(tmp_path / "shared.json")
    other = PlanRegistry()
    other.block_for(512, 512, 512, H100)
    other.save(path)
    plan_cache_for(H100).block_for(64, 128, 64, H100)
    save_plan_store(path)
    reset_plan_caches()
    assert load_plan_store(path) == 2, "both writers' entries must survive"
    assert plan_cache_for(H100).gemm_shapes(H100) == [(64, 128, 64), (512, 512, 512)]
    reset_plan_caches()


def test_stats_reports_gemm_and_conv_separately():
    reg, _ = _populated_registry()
    st = reg.stats()
    assert st["gemm_blocks"] == 3  # float, q16, and the no-fit layer's im2col plan
    assert st["conv_tiles"] == 2  # direct choice + no-fit sentinel
    assert len(reg) == st["gemm_blocks"] + st["conv_tiles"]
    assert st["misses"] == 5 and st["hits"] == 0


def test_register_plan_store_dedupes_by_identity():
    from repro_torch.core import engine as E

    store: dict = {}
    before = len(E._EXTRA_PLAN_STORES)
    for _ in range(3):
        register_plan_store(store)
    assert len(E._EXTRA_PLAN_STORES) == before + 1
    E._EXTRA_PLAN_STORES[:] = [s for s in E._EXTRA_PLAN_STORES if s is not store]


def test_bucket_ladder_round_trips_plan_registry(tmp_path):
    """Every rung's plan persists through the store and replans with 0 misses."""
    reg = PlanRegistry()
    eng = Engine(_cfg(), plan_cache=reg)
    ladder = (8, 32, 128)
    plans = eng.plan_gemm_ladder(ladder, 96, 64)
    assert sorted(plans) == sorted(ladder) and reg.misses == len(ladder)
    assert {p.block.route for p in plans.values()} == {"splitk", "tile"}
    path = str(tmp_path / "ladder_store.json")
    reg.save(path)
    warm = PlanRegistry()
    warm.load(path)
    plans2 = Engine(_cfg(), plan_cache=warm).plan_gemm_ladder(ladder, 96, 64)
    assert warm.misses == 0 and warm.hits == len(ladder)
    assert plans2 == plans


# ---------------------------------------------------------------------------
# serve: warm restarts make no search
# ---------------------------------------------------------------------------


def test_serve_warm_start_zero_searches(tmp_path, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.delenv(PLAN_STORE_ENV, raising=False)
    reset_plan_caches()
    store = str(tmp_path / "serve_store.json")
    args = ["--device", "cpu", "--prompts", "1", "--prompt-len", "8", "--gen", "2",
            "--plan-store", store]
    serve.main(args)
    assert os.path.exists(store)
    assert plan_cache_for(H100).misses > 0, "a cold serve plans something"
    reset_plan_caches()
    serve.main(args)
    pc = plan_cache_for(H100)
    assert pc.misses == 0 and pc.hits > 0
    reset_plan_caches()


_Q8_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.core.engine import plan_cache_for
    from repro_torch.core.tiling import H100
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--backend", "q8", "--prompts", "1", "--prompt-len", "8",
                "--gen", "2", "--precision-budget", "0.5", "--plan-store", sys.argv[1]])
    st = plan_cache_for(H100).stats()
    print(json.dumps({"misses": st["misses"], "hits": st["hits"],
                      "precision": st["precision"]}))
""")


def _run(script, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop(PLAN_STORE_ENV, None)
    return subprocess.run([sys.executable, "-c", script, *argv], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)


def test_serve_q8_warm_restart_zero_searches(tmp_path):
    """Two processes: the first calibrates, sweeps and pins; the second
    replays the pins from the store with no search at all."""
    store = str(tmp_path / "q8_store.json")
    cold = _run(_Q8_SCRIPT, store)
    assert cold.returncode == 0, cold.stderr[-3000:]
    with open(store) as f:
        doc = json.load(f)
    assert doc["precision"] and all(e["source"] == "measured" for e in doc["precision"])
    assert json.loads(cold.stdout.strip().splitlines()[-1])["misses"] > 0
    warm = _run(_Q8_SCRIPT, store)
    assert warm.returncode == 0, warm.stderr[-3000:]
    st = json.loads(warm.stdout.strip().splitlines()[-1])
    assert st["misses"] == 0 and st["hits"] > 0 and st["precision"] == len(doc["precision"])


# ---------------------------------------------------------------------------
# crash consistency: a writer killed mid-save never corrupts the store
# ---------------------------------------------------------------------------

_CRASH_SCRIPT = textwrap.dedent("""
    import os, sys
    store, point = sys.argv[1], sys.argv[2]
    from repro_torch.core import engine
    from repro_torch.core.engine import Engine, plan_cache_for, save_plan_store
    from repro_torch.core.template import TemplateConfig

    eng = Engine(TemplateConfig(backend="cuda", device="cpu"), plan_cache=plan_cache_for())
    eng.plan_gemm(64, 64, 64)
    save_plan_store(store)          # a complete store: 1 entry
    eng.plan_gemm(128, 64, 64)      # a second entry, never committed
    if point == "commit":
        real = os.replace
        def boom(src, dst, *a, **kw):
            if dst == store:
                os._exit(7)         # die after the fsync, before the rename
            return real(src, dst, *a, **kw)
        os.replace = boom
    elif point == "stage":
        def boom(doc, f, **kw):
            f.write('{"version": 99, "torn')
            f.flush()
            os._exit(7)             # die mid-write: a torn temp file
        engine.json.dump = boom
    else:
        raise SystemExit(f"bad crash point {point!r}")
    save_plan_store(store)
    os._exit(1)                     # the crash above must have fired
""")

_RECOVER_SCRIPT = textwrap.dedent("""
    import glob, json, sys
    store = sys.argv[1]
    from repro_torch.core.engine import Engine, PlanRegistry, plan_cache_for, save_plan_store
    from repro_torch.core.template import TemplateConfig

    eng = Engine(TemplateConfig(backend="cuda", device="cpu"), plan_cache=plan_cache_for())
    eng.plan_gemm(128, 64, 64)
    save_plan_store(store)
    print(json.dumps({"entries": PlanRegistry().load(store),
                      "litter": glob.glob(store + ".tmp.*")}))
""")


@pytest.mark.parametrize("point", ["stage", "commit"])
def test_writer_killed_mid_save_leaves_loadable_store(tmp_path, point):
    store = str(tmp_path / "plans.json")
    out = _run(_CRASH_SCRIPT, store, point)
    assert out.returncode == 7, f"wanted the simulated kill:\n{out.stderr[-3000:]}"
    reg = PlanRegistry()
    assert reg.load(store) == 1 and len(reg) == 1
    litter = glob.glob(store + ".tmp.*")
    assert litter, "the crashed writer leaves a .tmp sibling"
    if point == "stage":
        with pytest.raises(json.JSONDecodeError):
            with open(litter[0]) as f:
                json.load(f)
    out2 = _run(_RECOVER_SCRIPT, store)
    assert out2.returncode == 0, out2.stderr[-3000:]
    rec = json.loads(out2.stdout.strip().splitlines()[-1])
    assert rec == {"entries": 2, "litter": []}
    assert glob.glob(store + ".tmp.*") == []


def test_gpu_spec_tuple_fields_survive_as_tuples():
    from repro_torch.core.engine import _spec_from_doc, _spec_to_doc

    doc = json.loads(json.dumps(_spec_to_doc(H100)))
    assert doc["kind"] == "gpu" and isinstance(doc["gemm_tiles"][0], list)
    spec = _spec_from_doc(doc)
    assert isinstance(spec, GpuSpec) and spec == H100
    assert {spec: 1}[H100] == 1
