"""Multi-pod dry-run, in the port: plan every (architecture x input shape x
mesh) cell and record what each device holds and which GEMM plans each rank
runs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --mesh both

The port's copy of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell under its production mesh and reads XLA's memory and
cost analyses.  The port's ranks are processes (``launch/mesh.py``), so its
production meshes are layouts, and a cell is built on fake tensors
(``steps.step_and_specs``): nothing is allocated, compiled or run, no rank
is started and no collective is issued.  One JSON record a cell, under
``--out`` (default ``$DRYRUN_OUT`` or ``experiments/dryrun_torch``), named
as the reference names its records:

* ``arch``, ``shape``, ``mesh``, ``chips``, ``kind``, ``accum``, ``tag``;
* ``plan_s``: the seconds taken to build the cell;
* ``memory.argument_size_in_bytes``: the bytes of one device's shards of
  the step's arguments (params, optimizer state, cache and batch as the
  step takes them), beside each argument's part; ``arguments``: each
  argument leaf's logical and local shape and dtype;
* ``gemm_plans``: each dominant projection's local (m, n, k), its logical
  shape, route and tile (``steps.cell_gemm_plans``), planned on the
  template the card runs: the ``cuda`` backend under ``H100`` for serving
  cells, the ``torch`` backend (plain matmuls, no tile) for training;
* ``ops``, the counterpart of the reference's ``hlo``: rank 0's step
  counted op by op (``core/op_analysis.analyze_step``) on its shards of
  the arguments, as a recording rank of the production mesh
  (``Mesh.recording``) on the ``torch`` template, under the cell's rules
  (``use_mesh``, ``batch_split``): ``flops``, ``bytes``, ``wire_bytes``,
  ``coll_counts``, ``coll_bytes``, ``bytes_by_kind``, ``bytes_by_group``,
  ``seam_counts``, ``top_dots``, ``top_colls``; ``cost``: its ``flops``
  and ``bytes_accessed``;
* ``roofline``: ``compute_s``, ``memory_s``, ``collective_s`` and
  ``dominant`` at ``H100``'s rates (named under ``rates``), then
  ``model_flops``, ``useful_ratio`` and ``roofline_fraction`` as the
  reference computes them (``core/roofline.py``).

What needs a compiled program (the reference's temporary memory and its
``per_device_total_bytes``, static collective counts) is left out of the
record, not zeroed.  A cell that does not apply
(``configs.shape_applicable``) writes nothing and returns ``{"skipped":
why}``; a cell that fails to build or to run on the recording rank is a
bug: :func:`main` exits 1 with the list of failures.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, all_configs, get_config, shape_applicable
from repro_torch.core.op_analysis import analyze_step
from repro_torch.core.roofline import roofline_from_counts
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100
from repro_torch.launch.mesh import make_production_mesh, mesh_chips, mesh_name
from repro_torch.launch.scheduler import compiled_steps, serve_shardings, shard_cache
from repro_torch.launch.steps import (abstract_cache, abstract_params, input_specs,
                                     step_and_specs)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import DECODE_RULES, SERVE_RULES, TRAIN_RULES

__all__ = ["rules_for", "run_cell", "iter_cells", "argument_shards", "analyze_cell", "main"]

DEFAULT_OUT = os.path.join("experiments", "dryrun_torch")

#: each kind's step arguments, in order (``CellSpec.args``)
_ARGUMENTS = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
              "decode": ("params", "cache", "batch")}


def rules_for(kind: str, cfg=None, overrides: dict | None = None):
    """The rule table of a cell: ``TRAIN_RULES`` or ``SERVE_RULES``, then the
    config's ``rule_overrides``, its ``serve_rule_overrides`` (kinds other
    than train), then ``overrides``."""
    rules = TRAIN_RULES if kind == "train" else SERVE_RULES
    if cfg is not None and cfg.rule_overrides:
        rules = rules.with_overrides(**dict(cfg.rule_overrides))
    if cfg is not None and kind != "train" and cfg.serve_rule_overrides:
        rules = rules.with_overrides(**dict(cfg.serve_rule_overrides))
    if overrides:
        rules = rules.with_overrides(**overrides)
    return rules


def _argument_leaves(tree, shardings, path: str = ""):
    """(path, leaf, sharding) of every tensor of ``tree`` beside its
    NamedSharding tree (a sharding over a whole subtree covers each of its
    leaves)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _argument_leaves(v, sh.subtree(shardings, k), f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        for i, (k, v) in enumerate(zip(names, tree)):
            yield from _argument_leaves(v, sh.subtree(shardings, i), f"{path}/{k}")
    else:
        yield path, tree, shardings


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def argument_shards(cell) -> list:
    """One record a tensor of the cell's step arguments: its argument, path,
    logical and local (one device's shard) shape, dtype and local bytes."""
    out = []
    for name, tree, shardings in zip(_ARGUMENTS[cell.kind], cell.args, cell.in_shardings):
        for path, leaf, sharding in _argument_leaves(tree, shardings):
            local = sharding.shard_shape(tuple(leaf.shape))
            out.append({"argument": name, "path": path, "shape": list(leaf.shape),
                        "local_shape": list(local), "dtype": _dtype_name(leaf),
                        "local_bytes": math.prod(local) * leaf.element_size()})
    return out


def _plan_record(plan, backend: str) -> dict:
    """A GemmPlan as JSON: route "torch" on the torch backend, None for an
    empty GEMM (no launch) or a refused one (its reason under "refused")."""
    if isinstance(plan, str):
        return {"route": None, "refused": plan}
    blk = plan.block
    route = blk.route if blk is not None else "torch" if backend == "torch" else None
    return {"m": plan.m, "n": plan.n, "k": plan.k, "logical": list(plan.logical),
            "route": route, "tile": None if blk is None else [blk.bm, blk.bn, blk.bk],
            "splits": None if blk is None else blk.splits}


def _decode_rules(cfg):
    """The rules the port's meshed decode runs a decode cell of a family
    that serves column-parallel rules only (SSM, RG-LRU, enc-dec, VLM:
    ``scheduler.SERVE_RULES_FAMILIES`` excludes them) under:
    ``DECODE_RULES`` (column-parallel weights, whole heads and whole cache
    rows on every "model" rank, the batch over the data axes) with the
    config's ``serve_rule_overrides``."""
    rules = DECODE_RULES
    if cfg.serve_rule_overrides:
        rules = rules.with_overrides(**dict(cfg.serve_rule_overrides))
    return rules


def analyze_cell(cfg, shape, mesh, rules, accum: int = 1):
    """Rank 0's step of a cell counted op by op on the recording rank of
    ``mesh`` (``Mesh.recording``), on the ``torch`` template, on that rank's
    shards of the step's arguments; returns (the ``OpStats``, the rules it
    ran under, the rank's argument bytes).

    A train or prefill cell runs its ``step_and_specs`` step under the
    cell's ``rules``.  A decode cell runs the port's meshed decode
    (``launch/scheduler.py:compiled_steps(mesh=)``).  For the dense and MoE
    families that is the reference's program: the cell's own rules
    (``SERVE_RULES`` with the config's overrides), the weights in their
    whole layout (``serve_shardings(full=True)``: wo and the down
    projections row-parallel), the KV ring's sequence over "model"
    (``seq_kv``) with the ranks' partial softmaxes combined.  The other
    families serve column-parallel rules only, so their decode cells run
    :func:`_decode_rules`, and ``ops.rules`` says which."""
    from repro_torch.launch.scheduler import SERVE_RULES_FAMILIES

    rec = mesh.recording()
    tpl = default_template("torch", hw=H100, device="cpu")
    if shape.kind != "decode":
        cell = step_and_specs(cfg, shape, rec, rules, accum=accum, tpl=tpl)
        args = [sh.shard_tree(a, s) for a, s in zip(cell.args, cell.in_shardings)]
        st = analyze_step(cell.step_fn, *args, tpl=tpl, mesh=rec, rules=rules)
        return st, rules, _tree_bytes(args)
    full = cfg.family in SERVE_RULES_FAMILIES
    if not full:
        rules = _decode_rules(cfg)
    params = sh.shard_tree(abstract_params(cfg), serve_shardings(cfg, rec, rules, full=full))
    cache = shard_cache(cfg, abstract_cache(cfg, shape.global_batch, shape.seq_len), rec, rules)
    batch = input_specs(cfg, shape)
    steps = compiled_steps(tpl, cfg, shape.seq_len, mesh=rec, rules=rules)
    st = analyze_step(steps.decode, params, batch["token"], batch["t"], cache, tpl=tpl,
                      mesh=rec, rules=rules)
    return st, rules, _tree_bytes((params, cache))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def _analysis_fields(cfg, shape, record: dict, st) -> dict:
    """The reference's cost, hlo (here ``ops``) and roofline fields of one
    counted cell."""
    rep = roofline_from_counts(arch=record["arch"], shape=record["shape"],
                               mesh_name=record["mesh"], chips=record["chips"],
                               flops=st.flops, bytes_accessed=st.bytes,
                               collectives=st.collectives,
                               n_params_active=cfg.n_params_active(), tokens=shape.tokens,
                               training=shape.kind == "train", spec=H100)
    return {
        "cost": {"flops": st.flops, "bytes_accessed": st.bytes},
        "ops": {"flops": st.flops, "bytes": st.bytes, "wire_bytes": st.wire_bytes,
                "coll_counts": st.coll_counts,
                "coll_bytes": {k: round(v) for k, v in st.coll_bytes.items()},
                "bytes_by_kind": st.bytes_by_kind, "bytes_by_group": st.bytes_by_group,
                "seam_counts": {".".join(k): n for k, n in st.seam_counts.items()},
                "op_count": st.ops, "top_dots": st.top_dots, "top_colls": st.top_colls},
        "roofline": {"compute_s": rep.compute_s, "memory_s": rep.memory_s,
                     "collective_s": rep.collective_s, "dominant": rep.dominant,
                     "rates": {"hw": H100.name, "peak_bf16_flops": H100.peak_bf16_flops,
                               "hbm_bw": H100.hbm_bw, "link_bw": H100.link_bw}},
        "model_flops": rep.model_flops_total,
        "useful_ratio": rep.useful_ratio,
        "roofline_fraction": rep.roofline_fraction,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, accum: int = 1,
             rule_overrides: dict | None = None, tag: str = "", pad_heads: int = 0,
             remat_policy: str | None = None, device: str = "cuda") -> dict:
    """Build one cell on the production mesh and write its record; returns
    the record (``{"arch", "shape", "skipped": why}`` for a cell that does
    not apply).  ``accum`` 0 takes the config's ``train_accum`` for a train
    cell (1 otherwise).  ``device``: where the template would run (the
    planner reads no card)."""
    cfg = get_config(arch)
    if pad_heads:
        cfg = dataclasses.replace(cfg, n_heads_padded=pad_heads)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_for(shape.kind, cfg, rule_overrides)
    if accum == 0:
        accum = cfg.train_accum if shape.kind == "train" else 1
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
              "chips": mesh_chips(mesh), "kind": shape.kind, "accum": accum, "tag": tag}
    backend = "torch" if shape.kind == "train" else "cuda"
    tpl = default_template(backend, hw=H100, device=device)
    t0 = time.perf_counter()
    cell = step_and_specs(cfg, shape, mesh, rules, accum=accum, tpl=tpl)
    args = argument_shards(cell)
    record["plan_s"] = time.perf_counter() - t0
    by_arg = {name: sum(a["local_bytes"] for a in args if a["argument"] == name)
              for name in _ARGUMENTS[cell.kind]}
    record["memory"] = {"argument_size_in_bytes": sum(by_arg.values()),
                        "argument_bytes_by_argument": by_arg}
    record["template"] = {"backend": backend, "hw": tpl.config.hw.name}
    record["gemm_plans"] = {k: _plan_record(p, backend) for k, p in cell.gemm_plans.items()}
    t0 = time.perf_counter()
    try:
        st, ran_rules, arg_bytes = analyze_cell(cfg, shape, mesh, rules, accum=accum)
    except sh.LayoutRefused as e:
        record["analysis_refused"] = str(e)
    else:
        record.update(_analysis_fields(cfg, shape, record, st))
        record["ops"]["rules"] = [list(r) for r in ran_rules.rules]
        record["ops"]["argument_bytes"] = arg_bytes
    record["analyze_s"] = time.perf_counter() - t0
    record["arguments"] = args

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    fname = f"{arch.replace('/', '_')}_{shape_name}_{record['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    return record


def iter_cells(archs, shapes):
    """(arch, shape name, (applies, why)) for every pair."""
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            yield arch, shape_name, shape_applicable(cfg, SHAPES[shape_name])


def _parse_overrides(items) -> dict:
    overrides = {}
    for ov in items:
        k, _, v = ov.partition("=")
        if v.lower() in ("none", ""):
            overrides[k] = None
        elif "," in v:
            overrides[k] = tuple(v.split(","))
        else:
            overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=os.environ.get("DRYRUN_OUT", DEFAULT_OUT))
    ap.add_argument("--accum", type=int, default=0,
                    help="gradient accumulation (0 = per-arch default)")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad q-heads to this count for TP alignment")
    ap.add_argument("--remat-policy", default=None,
                    help="override cfg.remat_policy (e.g. attn_out)")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument("--override", action="append", default=[],
                    help="sharding rule override logical=axis (axis may be "
                         "'none' or comma-joined mesh axes)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the cells' templates would run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(all_configs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = _parse_overrides(args.override)

    failures = []
    ran = skipped = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                mesh_label = "2x16x16" if multi else "16x16"
                head = f"[{arch} x {shape_name} x {mesh_label}]"
                try:
                    rec = run_cell(arch, shape_name, multi, args.out, accum=args.accum,
                                   rule_overrides=overrides or None, tag=args.tag,
                                   pad_heads=args.pad_heads, remat_policy=args.remat_policy,
                                   device=args.device)
                except Exception as e:  # noqa: BLE001  (every cell is tried; the run fails)
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_label, repr(e)))
                    print(f"{head} FAILED: {e}", flush=True)
                    continue
                if "skipped" in rec:
                    skipped += 1
                    print(f"{head} SKIP: {rec['skipped']}", flush=True)
                    continue
                ran += 1
                routes = sorted({str(p["route"]) for p in rec["gemm_plans"].values()})
                line = (f"{head} ok kind={rec['kind']} plan={rec['plan_s']:.3f}s "
                        f"analyze={rec['analyze_s']:.1f}s "
                        f"args/dev={rec['memory']['argument_size_in_bytes'] / 2**30:.3f}GiB "
                        f"routes={','.join(routes)} ")
                if "analysis_refused" in rec:
                    line += f"analysis_refused: {rec['analysis_refused']}"
                else:
                    r = rec["roofline"]
                    line += (f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                             f"collective={r['collective_s']:.3e}s dominant={r['dominant']} "
                             f"useful={rec['useful_ratio']:.2f} "
                             f"roofline_frac={rec['roofline_fraction']:.3f}")
                print(line, flush=True)
    seconds = time.perf_counter() - t0
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        sys.exit(1)
    print(f"\nall requested dry-run cells planned OK: {ran} ran, {skipped} skipped, "
          f"{seconds:.1f}s")


if __name__ == "__main__":
    main()
