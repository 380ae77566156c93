"""Rank bodies of the port's meshed family-serving tests
(``tests/test_torch_sharded_decode_families.py``), run by ``spawn_ranks``.

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port, and
returns numpy results: the port's single-device run and its meshed run
on a (2, 2) ("data", "model") mesh, side by side, for the test process to
hold against each other and against the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import all_configs, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.engine import reset_plan_caches
from repro_torch.core.template import default_template
from repro_torch.launch import scheduler as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh

#: the scheduler runs' shape: 4 slots (2 a rank over "data"), ladder (8, 16)
SLOTS = 4
LADDER = (8, 16)


def rules_of(overrides: tuple):
    """``DECODE_RULES`` with ``overrides`` ((name, mesh axes) pairs)."""
    return sh.DECODE_RULES.with_overrides(**dict(overrides))


def cfg_of(name: str, cfg_kw: tuple):
    """The reduced config of ``name`` with ``cfg_kw`` ((field, value) pairs)."""
    return dataclasses.replace(reduced(all_configs()[name]), **dict(cfg_kw))


def _scheduled(cfg, params, tpl, prompts, mesh=None, rules=None):
    """The scheduler's token streams and each picked token's logits row
    (on the host)."""
    s = S.ServeScheduler(cfg, params, tpl=tpl, clock=S.VirtualClock(), mesh=mesh,
                         rules=rules,
                         sched=S.SchedulerConfig(ladder=LADDER, slots=SLOTS,
                                                 max_new_limit=8))
    rows: dict = {}
    s.logit_sink = lambda r, row: rows.setdefault(r.rid, []).append(
        row.detach().float().cpu().numpy())
    s.warmup()
    trace = [S.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                       rid=3000 + i) for i, p in enumerate(prompts)]
    S.replay_trace(s, trace)
    out = {"tokens": {r.rid: list(r.generated) for r in s.results.values()},
           "logits": {rid: np.stack(v) for rid, v in rows.items()},
           "decode_steps": int(s.counters["decode_steps"]),
           "meshed_eager_steps": int(s.counters["meshed_eager_decode_steps"])}
    if mesh is not None:
        out["sharded_leaves"] = sum(1 for x in S._leaves(s.exec_params)
                                    if sh.shard_marks(x))
    s.release()
    return out


def _stepped(cfg, params, tpl, tokens, ctx, gen, mesh=None, rules=None):
    """``compiled_steps``: the prefill, then ``gen`` greedy decode steps;
    the logits of each, the tokens, and (meshed) this rank's cache rows."""
    b, s = tokens.shape
    fns = S.compiled_steps(tpl, cfg, s + gen, mesh=mesh, rules=rules)
    if mesh is not None:
        params = sh.shard_tree(params, sh.column_parallel_shardings(
            mesh, rules, params, T.param_axes(cfg)))
    logits, cache = fns.prefill(params, tokens, ctx, None)
    if mesh is not None:
        cache = S.shard_cache(cfg, cache, mesh, rules)
    steps, toks = [logits.float().cpu().numpy()], [torch.argmax(logits, -1)]
    for i in range(gen):
        nxt, logits, cache = fns.decode_next(params, toks[-1][:, None], s + i, cache)
        steps.append(logits.float().cpu().numpy())
        toks.append(nxt.clone())
    return {"logits": np.stack(steps), "tokens": torch.stack(toks, 1).cpu().numpy(),
            "cache_rows": _batch_rows(cfg, cache)}


def _batch_rows(cfg, cache) -> dict:
    """{cache leaf name: its batch rows} over the leaves ``cache_axes``
    gives a batch dim (k / v rings, recurrent states, conv histories, cross
    k / v)."""
    rows: dict = {}

    def walk(c, a, name):
        if isinstance(c, dict):
            for k in c:
                walk(c[k], a[k] if isinstance(a, dict) else None, k)
        elif isinstance(c, tuple):
            for x, y in zip(c, a):
                walk(x, y, name)
        elif a is not None and "batch" in a:
            rows.setdefault(name, set()).add(int(c.shape[a.index("batch")]))

    walk(cache, T.cache_axes(cfg, cache), "")
    return {k: sorted(v) for k, v in rows.items()}


def _sharded_draws(mesh) -> dict:
    """For each (config, rule overrides) of :data:`DRAWS`: whether
    ``init_params(shardings=serve_shardings(...))`` equals the unsharded
    draw cut by the same shardings, leaf for leaf, bit for bit, and how
    many leaves it cut."""
    out = {}
    for name, overrides in DRAWS:
        cfg = cfg_of(name, ())
        shardings = S.serve_shardings(cfg, mesh, rules_of(overrides))
        got = T.init_params(torch.Generator().manual_seed(5), cfg, shardings=shardings)
        want = sh.shard_tree(T.init_params(torch.Generator().manual_seed(5), cfg), shardings)
        pairs = list(zip(S._leaves(got), S._leaves(want)))
        out[(name, overrides)] = {
            "equal": all(a.shape == b.shape and torch.equal(a, b)
                         and sh.shard_marks(a) == sh.shard_marks(b) for a, b in pairs),
            "cut": sum(1 for a, _ in pairs if sh.shard_marks(a))}
    return out


#: the sharded draws held against the unsharded draw cut
DRAWS = (("granite-moe-3b-a800m", (("expert_mlp", "model"),)),
         ("llama-3.2-vision-90b", (("embed", "model"),)),
         ("whisper-medium", ()), ("recurrentgemma-9b", ()))


def family_case(payload, rank, world, device):
    """Every case of the test file on this rank: the MoE configs through the
    meshed scheduler (float on the cuda template, per-op fixed point on
    q16; each set of rules), the non-attention families through
    ``compiled_steps(mesh=)``, and a dense config under ``embed`` over
    "model"; each beside the port's single-device run."""
    mesh = Mesh((2, 2), ("data", "model")).init_groups()
    out = {"coords": dict(mesh.coords), "sched": {}, "steps": {},
           "draws": _sharded_draws(mesh)}
    for key, case in payload["sched"].items():
        name, mode, overrides, cfg_kw = key
        reset_plan_caches()
        cfg = cfg_of(name, cfg_kw)
        params = transformer_params_from_numpy(case["params"])
        tpl = default_template("cuda" if mode == "float" else "q16", device="cpu")
        rec = {"single": _scheduled(cfg, params, tpl, payload["prompts"])}
        rec["meshed"] = _scheduled(cfg, params, tpl, payload["prompts"], mesh,
                                   rules_of(overrides))
        out["sched"][key] = rec
    for name, case in payload["steps"].items():
        reset_plan_caches()
        cfg = cfg_of(name, ())
        params = transformer_params_from_numpy(case["params"])
        tpl = default_template("cuda", device="cpu")
        tokens = torch.from_numpy(case["tokens"]).long()
        ctx = None if case["ctx"] is None else torch.from_numpy(case["ctx"])
        out["steps"][name] = {
            "single": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"]),
            "meshed": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"], mesh,
                               sh.DECODE_RULES)}
    return out


#: the card test's meshes over two ranks: slots split over "data" (every
#: decode tick's MoE group spans the ranks), then gate / up's expert_mlp
#: columns over "model"
GPU_MESHES = (((2, 1), ()), ((1, 2), (("expert_mlp", "model"),)))
GPU_STEPS = ("mamba2-1.3b", "recurrentgemma-9b", "whisper-medium", "llama-3.2-vision-90b")


def gpu_case(payload, rank, world, device):
    """Two ranks on the card, on each mesh of :data:`GPU_MESHES`: reduced
    granite-moe through the meshed scheduler and the non-attention families
    through ``compiled_steps(mesh=)``, each beside the single-device run on
    the card (weights from ``init_params`` on the card's generator)."""
    from repro_torch.launch.serve import draw_context

    torch.backends.cuda.matmul.allow_tf32 = False
    tpl = default_template("cuda", device=device)
    out = {}
    for shape, overrides in GPU_MESHES:
        mesh = Mesh(shape, ("data", "model")).init_groups()
        rules = rules_of(overrides)
        cfg = cfg_of("granite-moe-3b-a800m", ())
        params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        rec = {"sched": {"single": _scheduled(cfg, params, tpl, payload["prompts"]),
                         "meshed": _scheduled(cfg, params, tpl, payload["prompts"], mesh,
                                              rules)}}
        for name in GPU_STEPS:
            cfg = cfg_of(name, ())
            params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
            gen = torch.Generator(device=device).manual_seed(1)
            tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=device)
            ctx = draw_context(cfg, 4, seed=2, device=device)
            rec[name] = {"single": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"]),
                         "meshed": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"],
                                            mesh, rules)}
        out[shape] = rec
    return out


def split_case(payload, rank, world, device):
    """Two ranks on the card on the data split (2, 1): each of
    ``payload["names"]`` reduced, in bf16, through ``compiled_steps(mesh=)``
    on ``payload["rows"]`` rows (half a rank) beside the single-device run
    on the card."""
    from repro_torch.launch.serve import draw_context

    torch.backends.cuda.matmul.allow_tf32 = False
    tpl = default_template("cuda", device=device)
    mesh = Mesh((world, 1), ("data", "model")).init_groups()
    out = {}
    for name in payload["names"]:
        cfg = cfg_of(name, (("dtype", "bfloat16"),))
        params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        gen = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (payload["rows"], 16), generator=gen,
                               device=device)
        ctx = draw_context(cfg, payload["rows"], seed=2, device=device, dtype=torch.bfloat16)
        out[name] = {"single": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"]),
                     "meshed": _stepped(cfg, params, tpl, tokens, ctx, payload["gen"], mesh,
                                        sh.DECODE_RULES)}
    return out
