"""Rank bodies of the meshed decode step's tests
(``tests/test_torch_meshed_capture.py`` on gloo CPU ranks,
``tests/test_torch_sharded_decode_nccl_gpu.py`` on NCCL ranks, a card
each), run by ``spawn_ranks``.

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port, and
returns numpy results: the meshed decode step (``compiled_steps(mesh=)``'s
``decode_next``, whose body cuts this rank's rows, enters the mesh and
gathers the tokens and logits) beside the port's single-device step, and
the step's bookkeeping: eager steps and captures counted, graphs held and
released.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.engine import reset_plan_caches
from repro_torch.core.template import default_template
from repro_torch.launch import scheduler as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh

#: the scheduler runs' shape: 4 slots, ladder (8, 16)
SLOTS = 4
LADDER = (8, 16)
#: (case, config, mesh shape over ("data", "model")) of the stepped runs:
#: dense on (1, 2), MoE on (2, 1) (two rows a rank: a decode step's routing
#: group spans both ranks), a recurrent family on (1, 2)
STEPPED = (("qwen2-float", "qwen2-0.5b", (1, 2)),
           ("moe", "granite-moe-3b-a800m", (2, 1)),
           ("recurrent", "mamba2-1.3b", (1, 2)))


def _trace(prompts):
    return [S.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                      rid=3000 + i) for i, p in enumerate(prompts)]


def _counts():
    return (sum(S.CAPTURE_COUNTS.values()), sum(S.MESHED_EAGER_COUNTS.values()),
            collections.Counter(sh.SEAM_COUNTS))


def _delta(before) -> dict:
    caps, eager, seams = before
    now = collections.Counter(sh.SEAM_COUNTS)
    now.subtract(seams)
    return {"captures": sum(S.CAPTURE_COUNTS.values()) - caps,
            "eager": sum(S.MESHED_EAGER_COUNTS.values()) - eager,
            "collectives": sh.collective_counts(now)}


def stepped(cfg, params, tpl, tokens, ctx, gen, mesh=None, capture=True):
    """``compiled_steps``: the prefill, then ``gen`` greedy decode steps
    (``mesh``: this rank's share, the cache cut to its rows); the logits of
    each, the tokens, the counts the steps ticked, the graphs the step held
    and how many ``release(None)`` dropped."""
    b, s = tokens.shape
    rules = None if mesh is None else sh.DECODE_RULES
    fns = S.compiled_steps(tpl, cfg, s + gen, mesh=mesh, rules=rules, capture=capture)
    if mesh is not None:
        params = sh.shard_tree(params, sh.column_parallel_shardings(
            mesh, rules, params, T.param_axes(cfg)))
    logits, cache = fns.prefill(params, tokens, ctx, None)
    if mesh is not None:
        cache = S.shard_cache(cfg, cache, mesh, rules)
    steps, toks = [logits.float().cpu().numpy()], [torch.argmax(logits, -1)]
    before = _counts()
    for i in range(gen):
        nxt, logits, cache = fns.decode_next(params, toks[-1][:, None], s + i, cache)
        steps.append(logits.float().cpu().numpy())
        toks.append(nxt.clone())
    out = {"logits": np.stack(steps), "tokens": torch.stack(toks, 1).cpu().numpy(),
           **_delta(before), "graphed": fns.decode_next.graphed,
           "held": len(fns.decode_next.graphs)}
    out["released"] = fns.decode_next.release(None)
    out["held_after"] = len(fns.decode_next.graphs)
    return out


def scheduled(cfg, params, tpl, policy, prompts, mesh=None, capture=True):
    """The scheduler's token streams and each picked token's logits row;
    its decode counters and what ``release()`` dropped."""
    s = S.ServeScheduler(cfg, params, tpl=tpl, policy=policy, clock=S.VirtualClock(),
                         mesh=mesh, capture=capture,
                         sched=S.SchedulerConfig(ladder=LADDER, slots=SLOTS,
                                                 max_new_limit=8))
    rows: dict = {}
    s.logit_sink = lambda r, row: rows.setdefault(r.rid, []).append(
        row.detach().float().cpu().numpy())
    s.warmup()
    before = _counts()
    S.replay_trace(s, _trace(prompts))
    out = {"tokens": {r.rid: list(r.generated) for r in s.results.values()},
           "logits": {rid: np.stack(v) for rid, v in rows.items()}, **_delta(before),
           **{k: int(s.counters[k]) for k in ("decode_steps", "meshed_eager_decode_steps",
                                              "meshed_replayed_decode_steps")},
           "held": sum(1 for key in s._decode_next.graphs if key[1] == id(s))}
    out["released"] = s._decode_next.release(s)
    s.release()
    return out


def _whole_group_calls():
    """Count :func:`moe._whole_groups`' calls (a routing group that spans
    ranks) into the returned counter."""
    calls = collections.Counter()
    inner = moe._whole_groups

    def counted(*args, **kw):
        calls["n"] += 1
        return inner(*args, **kw)

    moe._whole_groups = counted
    return calls


def cpu_case(payload, rank, world, device):
    """Every case of ``test_torch_meshed_capture.py`` on this gloo rank:
    :data:`STEPPED` through ``compiled_steps`` (single device, then meshed),
    reduced qwen2 on the grid through the scheduler on (1, 2), and the
    refusal of ``capture=False`` without a mesh."""
    meshes = {shape: Mesh(shape, ("data", "model")).init_groups()
              for shape in {m for _, _, m in STEPPED}}
    tpl = default_template("cuda", device="cpu")
    out = {"stepped": {}}
    calls = _whole_group_calls()
    for case, name, shape in STEPPED:
        reset_plan_caches()
        cfg = reduced(get_config(name))
        params = transformer_params_from_numpy(payload["params"][name])
        tokens = torch.from_numpy(payload["tokens"]).long()
        single = stepped(cfg, params, tpl, tokens, None, payload["gen"])
        calls.clear()
        meshed = stepped(cfg, params, tpl, tokens, None, payload["gen"], meshes[shape])
        meshed["whole_group_calls"] = calls["n"]
        out["stepped"][case] = {"single": single, "meshed": meshed}
    reset_plan_caches()
    cfg = reduced(get_config("qwen2-0.5b"))
    params = transformer_params_from_numpy(payload["params"]["qwen2-0.5b"])
    tq = default_template("q16", device="cpu")
    policy = T.calibrate_policy(tq, cfg, params, torch.from_numpy(payload["cal"]))
    out["grid"] = {"policy": policy.fmt.name,
                   "single": scheduled(cfg, params, tq, policy, payload["prompts"]),
                   "meshed": scheduled(cfg, params, tq, policy, payload["prompts"],
                                       meshes[(1, 2)])}
    try:
        S.compiled_steps(tpl, cfg, 32, capture=False)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


#: the card test's cases: (case, config, mesh shape, path)
GPU_CASES = (("qwen2-float", "qwen2-0.5b", (1, 2), "scheduler"),
             ("moe", "granite-moe-3b-a800m", (2, 1), "steps"),
             ("recurrent", "mamba2-1.3b", (1, 2), "steps"))


def gpu_case(payload, rank, world, device):
    """Two NCCL ranks, a card each: each case of :data:`GPU_CASES` eager
    (``capture=False``), then captured, on its mesh, beside the
    single-device run on the card (weights from ``init_params`` on the
    card's generator)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tpl = default_template("cuda", device=device)
    meshes = {shape: Mesh(shape, ("data", "model")).init_groups()
              for shape in {c[2] for c in GPU_CASES}}
    out = {"backend": meshes[(1, 2)].backend, "nccl": list(torch.cuda.nccl.version())}
    for case, name, shape, path in GPU_CASES:
        cfg = reduced(get_config(name))
        params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        mesh = meshes[shape]
        if path == "scheduler":
            runs = {"single": scheduled(cfg, params, tpl, None, payload["prompts"])}
            for mode, capture in (("eager", False), ("captured", True)):
                runs[mode] = scheduled(cfg, params, tpl, None, payload["prompts"], mesh,
                                       capture)
        else:
            gen = torch.Generator(device=device).manual_seed(1)
            tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=device)
            runs = {"single": stepped(cfg, params, tpl, tokens, None, payload["gen"])}
            for mode, capture in (("eager", False), ("captured", True)):
                runs[mode] = stepped(cfg, params, tpl, tokens, None, payload["gen"], mesh,
                                     capture)
        out[case] = runs
    return out
