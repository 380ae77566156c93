"""Roofline report: the dry-run records as one table.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report
        [--dir experiments/dryrun_torch] [--mesh 16x16] [--tag TAG]

The port's copy of the reference's ``benchmarks/roofline_report.py``, over
the records ``python -m repro_torch.launch.dryrun`` writes.  Per (arch x
shape x mesh): the three roofline terms in seconds at the H100's rates, the
dominant one, MODEL_FLOPS over the counted flops, the roofline fraction, a
device's argument bytes, and a one-line note of what would move the
dominant term down, from the record's collective and op profile.

The port's records count ops where the reference's compile HLO (``ops``
in place of ``hlo``), and the port compiles nothing, so a record has no
temporary memory: the memory column is ``memory.argument_size_in_bytes``,
a lower bound on what a device holds, and "fits" compares it with one
H100's memory.  A record with ``analysis_refused`` has no terms: it is
listed apart and never picked.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.core.tiling import H100

#: ``launch/dryrun.py``'s default output directory (``DEFAULT_OUT``)
DEFAULT_DIR = os.path.join("experiments", "dryrun_torch")


def _advice(rec: dict) -> str:
    """What would move the dominant term down (``dominant`` names the term
    without the reference's ``_s``)."""
    r = rec["roofline"]
    dom = r["dominant"]
    h = rec.get("ops", {})
    if dom == "collective":
        coll = h.get("coll_bytes") or {"": 0}
        big = max(coll, key=lambda k: coll.get(k, 0))
        return (f"cut {big} bytes (bf16 wire / SP instead of TP all-reduce / "
                f"overlap with compute)")
    if dom == "memory":
        if rec["kind"] == "decode":
            return "KV-cache reads dominate: quantize cache / wider batch per chip"
        return ("attention p-matrix + remat traffic: flash kernel keeps p in "
                "shared memory; bf16 intermediates; fewer recomputes")
    if rec.get("useful_ratio", 1) < 0.5:
        return "compute-bound but wasteful: causal-chunk skip + remat policy"
    return "compute-bound: increase per-chip batch or shrink TP degree"


def load(dir_: str, mesh: str | None = None, tag: str = "") -> list[dict]:
    """Every record of ``dir_`` on ``mesh`` with ``tag``, refused ones too."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "skipped" in rec:
            continue
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec.get("tag", "") != tag:
            continue
        rows.append(rec)
    return rows


def refused(rows: list[dict]) -> list[dict]:
    """The records whose analysis was refused (no roofline terms)."""
    return [r for r in rows if "analysis_refused" in r]


def analyzed(rows: list[dict]) -> list[dict]:
    """The records that carry roofline terms."""
    return [r for r in rows if "analysis_refused" not in r]


def table_rows(rows: list[dict]) -> list[dict]:
    """The table's numbers, a dict per analyzed record."""
    out = []
    for rec in analyzed(rows):
        r = rec["roofline"]
        arg = rec["memory"]["argument_size_in_bytes"]
        out.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "useful_ratio": rec["useful_ratio"], "roofline_fraction": rec["roofline_fraction"],
            "argument_bytes": arg, "fits": arg <= H100.hbm_bytes,
        })
    return out


def table(rows: list[dict]) -> str:
    out = []
    hdr = (f"| {'arch':24s} | {'shape':11s} | {'mesh':7s} | {'compute_s':>9s} | "
           f"{'memory_s':>9s} | {'collect_s':>9s} | {'dominant':10s} | "
           f"{'useful':>6s} | {'frac':>6s} | {'arg GiB/dev >=':>14s} | fits |")
    out.append(hdr)
    out.append("|" + "-" * (len(hdr) - 2) + "|")
    for t in table_rows(rows):
        out.append(
            f"| {t['arch']:24s} | {t['shape']:11s} | {t['mesh']:7s} | "
            f"{t['compute_s']:9.3e} | {t['memory_s']:9.3e} | "
            f"{t['collective_s']:9.3e} | {t['dominant']:10s} | "
            f"{t['useful_ratio']:6.3f} | {t['roofline_fraction']:6.3f} | "
            f"{t['argument_bytes'] / 2**30:14.2f} | {'Y' if t['fits'] else 'N':4s} |")
    out.append(f"(arg GiB/dev: memory.argument_size_in_bytes, the arguments alone, a lower "
               f"bound on a device's memory; fits: against {H100.name}'s "
               f"{H100.hbm_bytes / 1e9:.0f} GB)")
    return "\n".join(out)


def pick_hillclimb_cells(rows: list[dict]) -> dict:
    """worst roofline fraction / most collective-bound / most representative,
    among the records with terms."""
    rows = analyzed(rows)
    runnable = [r for r in rows if r["kind"] == "train" or r["kind"] == "prefill"]
    if not runnable:
        runnable = rows
    worst = min(runnable, key=lambda r: r["roofline_fraction"])

    def coll_share(r):
        t = r["roofline"]
        total = t["compute_s"] + t["memory_s"] + t["collective_s"]
        return t["collective_s"] / max(total, 1e-30)

    coll = max(rows, key=coll_share)
    # most representative of the paper's technique: the biggest dense-GEMM
    # training cell (the compute unit doing what the template was built for)
    dense_train = [r for r in rows if r["kind"] == "train"]
    rep = max(dense_train, key=lambda r: r["model_flops"]) if dense_train else worst
    return {
        "worst_fraction": (worst["arch"], worst["shape"], worst["mesh"]),
        "most_collective_bound": (coll["arch"], coll["shape"], coll["mesh"]),
        "most_representative": (rep["arch"], rep["shape"], rep["mesh"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.environ.get("DRYRUN_OUT", DEFAULT_DIR))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rows = load(args.dir, args.mesh, args.tag)
    if not rows:
        print(f"(no dry-run records in {args.dir} for mesh {args.mesh})")
        return []
    print(table(rows))
    for rec in refused(rows):
        print(f"  refused (no terms): {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec['analysis_refused']}")
    if not analyzed(rows):
        return rows
    print("\nadvice per dominant term:")
    for rec in analyzed(rows):
        print(f"  {rec['arch']:24s} {rec['shape']:11s}: {_advice(rec)}")
    picks = pick_hillclimb_cells(rows)
    print("\nhillclimb cell selection:", json.dumps(picks, indent=1))
    return rows


if __name__ == "__main__":
    main()
