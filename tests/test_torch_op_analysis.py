"""The op analyzer's recording rank held against gloo ranks, and the
dry-run records it fills (``launch/dryrun.py``), on the CPU.

* A recording rank (``Mesh.recording``, no process group) running reduced
  qwen2-0.5b's train step on (2, 2) under ``TRAIN_RULES``, and one meshed
  decode step on (1, 2) through ``compiled_steps(mesh=)`` under
  ``DECODE_RULES`` and under ``SERVE_RULES`` (the sequence-sharded ring's
  combine, the row-parallel projections' partial sums), records the seam
  counts and the ordered list
  of (collective, axis, group size, result bytes) that gloo rank 0 counts
  and hands to ``torch.distributed`` for the same step
  (``tests/torch_analysis_cases.py``).
* The dry-run's records of reduced cells on ``make_test_mesh`` (prefill,
  decode, train) carry the reference's analysis fields, with the
  reference's arithmetic between them; the analysis leaves
  ``SEAM_COUNTS`` and the kernels' launch counts as it found them.
* Replaying repeated calls (a long prefill's chunked attention, a train
  step's microbatches) gives the counts of running them.
* A recording rank refuses real tensors; ``analyze_step`` refuses a kernel
  template; a plan-store document written before ``GpuSpec`` had its
  roofline rates still loads.
"""
import concurrent.futures
import contextlib
import functools
import json

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.engine import Engine, PlanRegistry
from repro_torch.core import op_analysis
from repro_torch.core.op_analysis import analyze_step
from repro_torch.core.template import TemplateConfig, default_template
from repro_torch.core.tiling import H100
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import Mesh, make_test_mesh, spawn_ranks
from repro_torch.models import attention
from repro_torch.parallel import sharding as sh

import torch_analysis_cases as C

#: the reduced cells of the dry-run records: (name, kind, seq, batch)
CELLS = (("train_4k", "train", 32, 8), ("prefill_32k", "prefill", 32, 4),
         ("decode_32k", "decode", 32, 4))


def _world(spec) -> int:
    sizes = spec[0][0]
    return sizes[0] * sizes[1]


@pytest.fixture(scope="module")
def gloo():
    """Rank 0's seam counts and logged collectives of both cases, from two
    ``spawn_ranks`` calls run at once."""
    cases = {"train": (C.train_case, C.TRAIN), "decode": (C.decode_case, C.DECODE),
             "serve_decode": (C.serve_decode_case, C.DECODE)}
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = {name: pool.submit(spawn_ranks, functools.partial(fn, {}), _world(spec),
                                     device="cpu", timeout=240)
                   for name, (fn, spec) in cases.items()}
        return {name: f.result()[0] for name, f in futures.items()}


def _recorded(setup, spec):
    rec = Mesh(*spec[0]).recording(0)
    fn, args, tpl, rules = setup(rec, real=False)
    return analyze_step(fn, *args, tpl=tpl, mesh=rec, rules=rules)


@pytest.mark.parametrize("case", ["train", "decode", "serve_decode"])
def test_recording_rank_issues_what_gloo_rank_0_issues(gloo, case):
    setup, spec = {"train": (C.train_setup, C.TRAIN), "decode": (C.decode_setup, C.DECODE),
                   "serve_decode": (C.serve_decode_setup, C.DECODE)}[case]
    st = _recorded(setup, spec)
    want = gloo[case]
    assert st.seam_counts == want["counts"]
    got = [(c.kind, c.axis, c.group, c.bytes) for c in st.collectives]
    assert got == [tuple(x) for x in want["log"]]
    assert got  # the step crosses the ranks
    if case == "train":
        assert {c.kind for c in st.collectives} == {"all-gather", "reduce-scatter",
                                                    "all-reduce"}
        assert {c.axis for c in st.collectives} == {"data", "model"}
    elif case == "serve_decode":
        # q / k / v and the logits gathered; the combine's max and sum and the
        # row-parallel partial sums all-reduced, all over "model"
        assert {(c.kind, c.axis) for c in st.collectives} == {("all-gather", "model"),
                                                             ("all-reduce", "model")}
        cfg = C.cfg()
        assert st.seam_counts[("kv_max", "fwd", "model")] == cfg.n_layers
        assert st.seam_counts[("kv_sum", "fwd", "model")] == cfg.n_layers
    else:
        assert {(c.kind, c.axis, c.group) for c in st.collectives} == {("all-gather", "model",
                                                                        2)}


@pytest.fixture
def reduced_cells(monkeypatch):
    """The dry-run on reduced configs and small shapes on the reference's
    (2, 2) / (2, 2, 2) test meshes."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: reduced(get_config(arch)))
    monkeypatch.setattr(dryrun, "SHAPES", {n: ShapeSpec(n, s, b, k) for n, k, s, b in CELLS})
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_test_mesh(multi_pod=multi_pod))


def test_dryrun_records_carry_the_roofline(tmp_path, reduced_cells):
    sh.SEAM_COUNTS.clear()
    sh.SEAM_COUNTS[("act_gather", "fwd", "model")] = 7  # a caller's counts
    seams, launches = dict(sh.SEAM_COUNTS), dict(_build.launches)
    dryrun.main(["--arch", "qwen2-0.5b", "--mesh", "both", "--device", "cpu",
                 "--out", str(tmp_path)])
    assert dict(sh.SEAM_COUNTS) == seams and dict(_build.launches) == launches
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert len(recs) == 6 and {r["mesh"] for r in recs} == {"2x2", "2x2x2"}
    for r in recs:
        assert {"ops", "cost", "roofline", "model_flops", "useful_ratio",
                "roofline_fraction"} <= set(r) and "hlo" not in r
        ops, roof = r["ops"], r["roofline"]
        assert {"flops", "bytes", "wire_bytes", "coll_counts", "coll_bytes", "bytes_by_kind",
                "top_dots", "top_colls"} <= set(ops)
        assert r["cost"] == {"flops": ops["flops"], "bytes_accessed": ops["bytes"]}
        terms = {k: roof[f"{k}_s"] for k in ("compute", "memory", "collective")}
        assert roof["dominant"] == max(terms, key=terms.get)
        assert roof["compute_s"] == ops["flops"] / H100.peak_bf16_flops
        assert roof["memory_s"] == ops["bytes"] / H100.hbm_bw
        assert roof["collective_s"] == ops["wire_bytes"] / H100.link_bw
        assert r["useful_ratio"] == r["model_flops"] / (ops["flops"] * r["chips"])
        bound = max(terms.values())
        assert r["roofline_fraction"] == roof["compute_s"] / bound * r["useful_ratio"]
        assert ops["flops"] > 0 and ops["bytes"] > 0 and ops["wire_bytes"] > 0
        assert sum(ops["bytes_by_group"].values()) == ops["bytes"]
        if r["kind"] == "decode":
            # a decode step reads every weight shard and cache entry once
            by_arg = r["memory"]["argument_bytes_by_argument"]
            assert ops["bytes"] >= by_arg["params"] + by_arg["cache"]
            assert ops["bytes"] >= ops["argument_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_replayed_counts_equal_the_full_count(kind, monkeypatch):
    """A train step of two microbatches and a prefill on the chunked route
    (its attention one (q chunk, kv chunk) loop a layer): counting each
    repeated call once and replaying it gives every field of the full
    count."""
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(attention, "_BQ", 16)
    monkeypatch.setattr(attention, "_BK", 16)
    cfg = reduced(get_config("qwen2-0.5b"))
    shape = ShapeSpec(kind, 64, 8 if kind == "train" else 4, kind)
    rules = dryrun.rules_for(kind, cfg)
    tpl = default_template("torch", device="cpu")
    got = []
    for replay in (True, False):
        if not replay:  # every call dispatched
            monkeypatch.setattr(op_analysis, "_replaying",
                                lambda counter: contextlib.nullcontext())
        rec = make_test_mesh().recording(0)
        cell = steps.step_and_specs(cfg, shape, rec, rules, accum=2 if kind == "train" else 1,
                                    tpl=tpl)
        args = [sh.shard_tree(a, s) for a, s in zip(cell.args, cell.in_shardings)]
        got.append(op_analysis.analyze_step(cell.step_fn, *args, tpl=tpl, mesh=rec,
                                            rules=rules, top=10 ** 9))
    a, b = got
    for field in ("flops", "bytes", "ops", "wire_bytes", "coll_counts", "coll_bytes",
                  "bytes_by_kind", "bytes_by_group", "seam_counts", "collectives", "top_dots"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.bytes_by_group["attention"] > 0


def test_recording_rank_refuses_real_tensors():
    rec = make_test_mesh().recording(0)
    assert rec.has_groups and rec.is_recording and rec.coords == {"data": 0, "model": 0}
    with sh.use_mesh(rec, sh.TRAIN_RULES), sh.record_collectives():
        with pytest.raises(ValueError, match="fake tensors only"):
            sh.gather(torch.ones(4, 4), 0, "model")
        with pytest.raises(ValueError, match="fake tensors only"):
            sh.psum(torch.ones(3), ("data",))


@pytest.mark.parametrize("backend", ["cuda", "q16"])
def test_analyze_step_refuses_kernel_templates(backend):
    with pytest.raises(ValueError, match="torch"):
        analyze_step(torch.matmul, torch.ones(2, 2), torch.ones(2, 2),
                     tpl=default_template(backend, device="cpu"))


def test_plan_store_without_roofline_rates_loads(tmp_path):
    reg = PlanRegistry()
    Engine(TemplateConfig(backend="cuda", hw=H100, device="cpu"),
           plan_cache=reg).plan_gemm(4, 896, 896)
    doc = reg.to_doc()
    for spec in doc["specs"]:
        if spec["kind"] == "gpu":
            del spec["peak_bf16_flops"], spec["link_bw"]
    path = tmp_path / "old.json"
    path.write_text(json.dumps(doc))
    loaded = PlanRegistry()
    loaded.load(str(path))
    assert loaded.specs() == {H100} and len(loaded) == len(reg)


def test_granite_prefill_cells_record_their_refusal(tmp_path, reduced_cells):
    """granite-moe's serving cells under the reference's own rules
    (``SERVE_RULES`` with its serve overrides: ``expert_mlp`` over "model",
    so the expert down projection is row-parallel) run and carry their
    terms: no cell records a refusal, and each record's ``ops.rules`` is
    ``rules_for(kind, cfg)``, the decode cell's too (its ring's sequence
    over "model", no substitute rules)."""
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("granite-moe-3b-a800m", shape, False, str(tmp_path),
                              device="cpu")
        assert "analysis_refused" not in rec and rec["roofline"]["dominant"]
        assert rec["ops"]["flops"] > 0 and rec["ops"]["wire_bytes"] > 0
        want = dryrun.rules_for(rec["kind"], cfg)
        assert rec["ops"]["rules"] == [list(r) for r in want.rules]
        if rec["kind"] == "decode":
            assert rec["ops"]["seam_counts"]["kv_max.fwd.model"] == cfg.n_layers
