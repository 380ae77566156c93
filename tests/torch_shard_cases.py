"""Rank bodies of the port's sharding tests, run by ``spawn_ranks``.

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port, and
returns numpy results for the test process to hold against the JAX
package.  The test files build the payloads (reference weights as numpy
arrays, inputs from numpy seeds) and spawn the ranks once per module.
"""
from __future__ import annotations

import os

import torch

from repro_torch.checkpoint import manager as M
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (cnn_params_from_numpy, transformer_params_from_numpy,
                                 transformer_shard_from_numpy)
from repro_torch.core.engine import load_plan_store, reset_plan_caches, save_plan_store
from repro_torch.core.quantization import NumericsPolicy
from repro_torch.core.template import default_template
from repro_torch.launch import scheduler as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cnn as C
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh


def spatial_case(payload, rank, world, device):
    """The H-slab halo exchange and the spatial CNN forwards on a (2, 2)
    ("data", "model") mesh, slabs over "data"."""
    mesh = Mesh((2, 2), ("data", "model")).init_groups()
    out = {"coords": dict(mesh.coords), "exchange": [], "forward": {}}
    with sh.use_mesh(mesh, sh.SERVE_RULES):
        s = mesh.coords["data"]
        for geom, x in payload["exchange"]:
            hs = sh.plan_spatial_halo(*geom, axis="data")
            slabs = C._to_slabs(torch.from_numpy(x), hs.shards, "data")
            win = sh.halo_exchange(slabs, hs)
            out["exchange"].append((win[0].numpy(), sh.mask_slab_rows(
                torch.ones((1, 1, hs.lo, 2, 1)), hs)[0].numpy(), s))
        for name, (fields, params, x) in payload["nets"].items():
            spec = C.CNNSpec(*fields)
            tp = cnn_params_from_numpy(params)
            xt = torch.from_numpy(x)
            ftpl = default_template("cuda", device="cpu")
            plan = C.plan_cnn(ftpl, spec, x.shape, mesh=mesh, spatial="data")
            assert plan.spatial == 2 and plan.spatial_axis == "data"
            assert all(cp.halo is not None and cp.halo.axis == "data" for cp in plan.convs)
            ftpl.engine.counters.clear()
            y = C.cnn_forward(ftpl, spec, tp, xt, plan=plan)
            spatial_convs = ftpl.engine.counters["conv_spatial"]
            qtpl = default_template("q16", device="cpu")
            pol = NumericsPolicy("q16")
            qp = C.quantize_cnn_params(qtpl, spec, tp, pol)
            qplan = C.plan_cnn(qtpl, spec, x.shape, mesh=mesh, spatial="data")
            yq = C.cnn_forward(qtpl, spec, qp, xt, policy=pol, plan=qplan)
            with qtpl.engine.plan_cache.scope() as warm:
                C.cnn_forward(qtpl, spec, qp, xt, policy=pol, plan=qplan)
            out["forward"][name] = {"float": y.numpy(), "q16": yq.numpy(),
                                    "conv_spatial": spatial_convs,
                                    "warm_misses": warm["misses"],
                                    "describe": plan.describe()}
    return out


def _trace(prompts):
    return [S.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                      rid=3000 + i) for i, p in enumerate(prompts)]


def _run(cfg, params, tpl, policy, ladder, prompts, mesh):
    s = S.ServeScheduler(cfg, params, tpl=tpl, clock=S.VirtualClock(), policy=policy,
                         sched=S.SchedulerConfig(ladder=ladder, slots=4, max_new_limit=8),
                         mesh=mesh)
    warm_start = s.registry.misses
    s.warmup()
    warmup_misses = s.registry.misses - warm_start
    replay_start = s.registry.misses
    S.replay_trace(s, _trace(prompts))
    toks = {r.rid: list(r.generated) for r in s.results.values()}
    return toks, s.registry.misses - replay_start, warmup_misses, s


def decode_case(payload, rank, world, device):
    """The reduced-qwen2 scheduler on a (2, 2) mesh, float and q16: the
    port's single-device run, the meshed run cold, then a plan-store round
    trip and the meshed run warm (the reference's
    ``tests/test_sharded_decode.py``)."""
    mesh = Mesh((2, 2), ("data", "model")).init_groups()
    cfg = reduced(get_config("qwen2-0.5b"))
    params = transformer_params_from_numpy(payload["params"])
    out = {}
    for mode in ("float", "q16"):
        reset_plan_caches()
        tpl = default_template("cuda" if mode == "float" else "q16", device="cpu")
        policy = None
        if mode == "q16":
            policy = T.calibrate_policy(tpl, cfg, params, torch.from_numpy(payload["cal"]))
        single, single_replay, _, _ = _run(cfg, params, tpl, policy, payload["ladder"],
                                           payload["prompts"], None)
        captures = sum(S.CAPTURE_COUNTS.values())
        sharded, shard_replay, cold_warmup, s2 = _run(cfg, params, tpl, policy,
                                                      payload["ladder"],
                                                      payload["prompts"], mesh)
        captures = sum(S.CAPTURE_COUNTS.values()) - captures
        store = os.path.join(payload["store_dir"], f"{mode}-rank{rank}.json")
        save_plan_store(store)
        reset_plan_caches()
        n_loaded = load_plan_store(store)
        warm, warm_replay, warm_warmup, s3 = _run(cfg, params, tpl, policy,
                                                  payload["ladder"], payload["prompts"],
                                                  mesh)
        local = sum(1 for leaf in S._leaves(s2.exec_params) if sh.shard_marks(leaf))
        out[mode] = {
            "policy": None if policy is None else policy.fmt.name,
            "single": single, "sharded": sharded, "warm": warm,
            "single_replay_misses": single_replay, "shard_replay_misses": shard_replay,
            "cold_mesh_warmup_misses": cold_warmup,
            "warm_mesh_warmup_misses": warm_warmup,
            "warm_warmup_shard_misses": int(s3.counters["warmup_shard_misses"]),
            "warm_replay_misses": warm_replay, "store_entries": n_loaded,
            "sharded_leaves": local,
            "meshed_eager_steps": int(s2.counters["meshed_eager_decode_steps"]),
            "meshed_captures": captures,
            "decode_steps": int(s2.counters["decode_steps"]),
            "cache_rows": int(s2.cache["blocks"][0]["attn"]["k"].shape[1]),
        }
    return out


def checkpoint_case(payload, rank, world, device):
    """A reduced-qwen2 checkpoint restored onto this rank's column-parallel
    shardings, and the reference's numpy tree converted into the same
    shards, on a (2, 2) ("data", "model") mesh."""
    mesh = Mesh((2, 2), ("data", "model")).init_groups()
    cfg = reduced(get_config("qwen2-0.5b"))
    target = transformer_params_from_numpy(payload["params"])
    axes = T.param_axes(cfg)
    shardings = sh.column_parallel_shardings(mesh, sh.DECODE_RULES, target, axes)
    restored = M.restore(payload["directory"], payload["step"], target, shardings)
    converted = transformer_shard_from_numpy(payload["params"], mesh, axes)
    flat = {which: {M._name(key): leaf.numpy() for key, leaf in M._walk(tree)}
            for which, tree in (("restored", restored), ("converted", converted))}
    return {"coords": dict(mesh.coords), **flat}


def _gpu_qwen(device):
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    tq = default_template("q16")
    cal = torch.randint(0, cfg.vocab, (2, 16), device=device,
                        generator=torch.Generator(device=device).manual_seed(9))
    return cfg, params, {"float": (default_template("cuda"), None),
                         "q16": (tq, T.calibrate_policy(tq, cfg, params, cal))}


def gpu_streams(device, mesh, prompts):
    """The reduced-qwen2 scheduler's token streams, float and q16, on the
    card (``mesh``: this rank's tensor-parallel share)."""
    cfg, params, tpls = _gpu_qwen(device)
    out = {}
    for mode, (tpl, pol) in tpls.items():
        toks, _, _, s = _run(cfg, params, tpl, pol, (8, 16), prompts, mesh)
        out[mode] = toks
        out[mode + "_eager_steps"] = int(s.counters["meshed_eager_decode_steps"])
    return out


def gpu_vgg_grid(device, mesh, batch):
    """VGG16's grid-resident logits on the card at 224², batch ``batch``:
    unsharded, or (``mesh``) with H slabs over its "data" axis."""
    spec = C.VGG16
    params = C.init_cnn(torch.Generator().manual_seed(0), spec, device=device)
    x = torch.rand((batch, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(device)
    tq, pol = default_template("q16"), NumericsPolicy("q16")
    qp = C.quantize_cnn_params(tq, spec, params, pol)
    if mesh is None:
        return C.cnn_forward(tq, spec, qp, x, policy=pol)
    with sh.use_mesh(mesh, sh.SERVE_RULES):
        plan = C.plan_cnn(tq, spec, tuple(x.shape), mesh=mesh, spatial="data")
        return C.cnn_forward(tq, spec, qp, x, policy=pol, plan=plan)


def gpu_case(payload, rank, world, device):
    """Two ranks on one card: VGG16's grid forward with H slabs over "data",
    then tensor-parallel decode over "model"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"vgg": gpu_vgg_grid(device, Mesh((2,), ("data",)).init_groups(),
                               payload["batch"])}
    out.update(gpu_streams(device, Mesh((1, 2), ("data", "model")).init_groups(),
                           payload["prompts"]))
    return out


def failing_case(payload, rank, world, device):
    """Rank ``payload["rank"]`` raises, or (``payload["exit"]``) dies without
    a report; the others wait in a collective it never joins."""
    if rank == payload["rank"]:
        if payload.get("exit"):
            os._exit(3)
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return rank
