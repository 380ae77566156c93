"""Benchmark harness entry point: one module per paper table / finding.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu] [--out PATH]

The port's copy of the reference's ``benchmarks/run.py``, the same modules
in the same order, each called with an explicit argv (a module never reads
this script's own flags):

  table1          paper Table 1 (resources + GOP/s, 3 ZYNQ boards)
  table2          paper Table 2 (against Bjerge et al. on Ultra96)
  dse_sweep       paper §III.E tau ~ 2 mu finding + the TPU block DSE
  kernel_table    the GEMM plans and bounds (H100 rows timed on a card),
                  each kernel against its oracle, the conv / sharding /
                  plan-store / residency / precision / scheduler / router rows
  precision_drift fixed-point drift + the per-layer precision DSE sweep
  scheduler_soak  continuous-batching mixed-trace soak (virtual clock)
  router_soak     multi-process replica fleet + an injected kill

then the roofline report of the dry-run records (``$DRYRUN_OUT``, else
``experiments/dryrun_torch``, and the same directory with ``_opt``) when
there are any.  The modules' rows, and each roofline table's numbers, are
written into one JSON object (default ``build/bench_torch.json``).  A
module that fails is reported and the run exits 1 once the others ran.

The plan store at ``$REPRO_TORCH_PLAN_STORE`` warm-starts the run and is
saved after it; with ``REPRO_PLAN_ASSERT_WARM=1`` the run fails if no store
was loaded or any DSE search ran, checked before the save (a failing gate
that saved would heal itself on a retry).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import traceback
from pathlib import Path

#: the modules in the reference's order; those that run on a device take it
MODULES = ("table1", "table2", "dse_sweep", "kernel_table", "precision_drift",
           "scheduler_soak", "router_soak")
ON_DEVICE = ("kernel_table", "precision_drift", "scheduler_soak", "router_soak")

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "bench_torch.json"


def module_argv(name: str, device: str) -> list:
    """The explicit argv a module is called with."""
    return ["--device", device] if name in ON_DEVICE else []


def roofline_dirs() -> tuple:
    """(label, directory) of the dry-run records the report reads."""
    from repro_torch.benchmarks.roofline_report import DEFAULT_DIR

    base = os.environ.get("DRYRUN_OUT", DEFAULT_DIR)
    return (("baseline", base), ("optimized", f"{base.rstrip(os.sep)}_opt"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the modules run: 'cuda' (the card) or 'cpu'")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="the consolidated JSON of every module's rows")
    args = ap.parse_args(argv)

    from repro_torch.core.engine import (
        plan_store_stats,
        save_plan_store,
        warm_start_plan_store,
    )

    store_path, n = warm_start_plan_store()
    warm = n > 0
    if warm:
        print(f"[plan-store] warm-started {n} entries from {store_path}")

    failures = []
    results = {}
    for name in MODULES:
        print("\n" + "=" * 72, flush=True)
        try:
            mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
            out = mod.main(module_argv(name, args.device))
        except (Exception, SystemExit):
            traceback.print_exc()
            failures.append(name)
        else:
            try:
                json.dumps(out)
            except (TypeError, ValueError):
                continue
            if out is not None:
                results[name] = out

    from repro_torch.benchmarks import roofline_report

    for label, d in roofline_dirs():
        print("\n" + "=" * 72)
        print(f"== Roofline ({label}) ==")
        try:
            if not os.path.isdir(d):
                print(f"(no {d} - run repro_torch.launch.dryrun first)")
                continue
            rows = roofline_report.main(["--mesh", "16x16", "--dir", d])
            if rows:
                results[f"roofline_report:{label}"] = {
                    "dir": d, "rows": roofline_report.table_rows(rows),
                    "refused": [[r["arch"], r["shape"], r["mesh"]]
                                for r in roofline_report.refused(rows)]}
                print(f"\n({label} roofline rows: {len(rows)} single-pod cells)")
        except Exception:
            traceback.print_exc()
            failures.append(f"roofline_report:{label}")
    st = plan_store_stats()
    print(f"\n[plan-store] this run: {st['gemm_blocks']} GEMM blocks + "
          f"{st['conv_tiles']} conv tiles in registry, "
          f"{st['misses']} new DSE searches, {st['hits']} cache hits")
    if os.environ.get("REPRO_PLAN_ASSERT_WARM") == "1":
        # the warm-start gate: a run against a populated store must not
        # search, checked *before* saving (saving the new entries on a
        # failing gate would make a retry pass and hide the regression)
        if not warm:
            print("[plan-store] ASSERT_WARM set but no store was loaded")
            sys.exit(1)
        if st["misses"] > 0:
            print(f"[plan-store] warm-start FAILED: {st['misses']} DSE searches "
                  "ran against a populated store")
            sys.exit(1)
        print("[plan-store] warm-start OK: zero DSE searches")
    if store_path:
        save_plan_store(store_path)
        print(f"[plan-store] saved to {store_path}")
    try:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"[bench] consolidated results for {sorted(results)} -> {args.out}")
    except Exception:
        traceback.print_exc()
        failures.append(args.out)
    if failures:
        print(f"\nbenchmark FAILURES: {failures}")
        sys.exit(1)
    print("\nall benchmarks completed")
    return results


if __name__ == "__main__":
    main()
