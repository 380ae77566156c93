"""Rank bodies of ``tests/test_torch_serve_rules.py`` (gloo CPU ranks) and of
``tests/test_torch_serve_rules_gpu.py`` (two ranks on the card), run by
``spawn_ranks``: serving under ``SERVE_RULES`` (heads over "model", the KV
ring's sequence over "model", wo and the down projections row-parallel).

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port and
returns numpy results.  The weights are the payload's numpy trees (the
reference's draw on the CPU) or a seeded draw, cut to this rank's shards
in the rules' whole layout (``serve_shardings(full=True)``).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.engine import reset_plan_caches
from repro_torch.core.template import default_template
from repro_torch.kernels import _build
from repro_torch.launch import scheduler as S
from repro_torch.launch.dryrun import rules_for
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh

#: (case, config, mesh shape over ("data", "model"), ring slots, prompt
#: tokens, decode steps): prefill, then teacher-forced decode steps on the
#: shared-position ring, then a chunk and CHUNK_STEPS decode steps on a
#: per-slot ring.  "wrap": a 16-slot ring over 24 steps, so positions wrap
#: across the ranks; with 4 prompt tokens rank 1's slots 8..15 are all
#: masked until position 8
CASES = (("qwen2", "qwen2-0.5b", (1, 2), 32, 8, 12),
         ("wrap", "qwen2-0.5b", (1, 2), 16, 4, 24),
         ("granite", "granite-moe-3b-a800m", (2, 2), 32, 8, 12),
         ("phi", "phi3.5-moe-42b-a6.6b", (2, 2), 32, 8, 12))
B = 4
#: the chunk step: (tokens a row, each row's real tokens) then its decode steps
CHUNK = 6
CHUNK_VALID = (6, 3, 5, 6)
CHUNK_STEPS = 4
#: the scheduler case: reduced qwen2 on (1, 2), slots and ladder
SLOTS = 4
LADDER = (8, 16)
SCHED_RING = 32


def cfg_of(name: str):
    """The reduced config, MoE capacity large enough that no token drops."""
    cfg = reduced(get_config(name))
    return dataclasses.replace(cfg, capacity_factor=100.0) if "moe" in name else cfg


def _ring(cache) -> dict:
    """Layer 0's k ring and pos as this rank holds them."""
    a = cache["blocks"][0]["attn"]
    return {"k_shape": list(a["k"].shape), "pos_shape": list(a["pos"].shape),
            "pos": a["pos"].cpu().numpy().copy()}


def _seams_delta(before):
    now = collections.Counter(sh.SEAM_COUNTS)
    now.subtract(before)
    return {"/".join(k): n for k, n in now.items() if n}


def steps_case(cfg, params, tpl, mesh, rules, ring: int, tokens, gen: int, chunk=None):
    """On this rank: the prefill of ``tokens[:, :L]`` (L = its width less
    ``gen``) and ``gen`` teacher-forced decode steps through
    ``compiled_steps(mesh=, rules=)``; then (``chunk``: (tokens (B, S),
    n_valid (B,), next tokens (B, CHUNK_STEPS))) a chunk step on a fresh
    per-slot ring (``init_local_cache``) and its decode steps.  Logits a
    step, this rank's ring shapes and pos, seams ticked."""
    fns = S.compiled_steps(tpl, cfg, ring, mesh=mesh, rules=rules)
    length = tokens.shape[1] - gen
    before = collections.Counter(sh.SEAM_COUNTS)
    logits, cache = fns.prefill(params, tokens[:, :length], None, None)
    if mesh is not None:
        cache = S.shard_cache(cfg, cache, mesh, rules)
    out = {"prefill_ring": _ring(cache)}
    steps = [logits.float().cpu().numpy()]
    for i in range(gen):
        if i == 0:
            out["first_step_ring"] = _ring(cache)
        _, logits, cache = fns.decode_next(params, tokens[:, length + i:length + i + 1],
                                           length + i, cache)
        steps.append(logits.float().cpu().numpy())
    out["steps"] = np.stack(steps)
    out["ring"] = _ring(cache)
    if chunk is not None:
        ctoks, nv, nxt = chunk
        dev = tpl.engine.device
        slots = (T.init_cache(cfg, B, ring, per_slot=True, device=dev) if mesh is None else
                 S.init_local_cache(cfg, B, ring, mesh, rules, per_slot=True, device=dev))
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        logits, slots = fns.chunk(params, ctoks, zeros, nv, slots)
        chunked = [logits.float().cpu().numpy()]
        for i in range(nxt.shape[1]):
            logits, slots = fns.decode(params, nxt[:, i:i + 1], nv + i, slots)
            chunked.append(logits.float().cpu().numpy())
        out["chunk"] = np.stack(chunked)
        out["chunk_ring"] = _ring(slots)
    out["seams"] = _seams_delta(before)
    fns.decode_next.release(None)
    return out


def cpu_case(payload, rank, world, device):
    """Every case of :data:`CASES` on this rank's mesh shape (the payload's
    ``shape``), on the ``cuda`` template's plain versions; and, on (1, 2),
    the meshed scheduler over the payload's trace."""
    shape = payload["shape"]
    mesh = Mesh(shape, ("data", "model")).init_groups()
    tpl = default_template("cuda", device="cpu")
    out = {}
    for case, name, mshape, ring, _, gen in CASES:
        if mshape != shape:
            continue
        reset_plan_caches()
        cfg = cfg_of(name)
        rules = rules_for("decode", cfg)
        params = sh.shard_tree(transformer_params_from_numpy(payload["params"][name]),
                               S.serve_shardings(cfg, mesh, rules, full=True))
        tokens = torch.from_numpy(payload["tokens"][case]).long()
        chunk = tuple(torch.from_numpy(payload["chunk"][k]).long()
                      for k in ("tokens", "n_valid", "next"))
        _build.reset_launches()
        out[case] = steps_case(cfg, params, tpl, mesh, rules, ring, tokens, gen,
                               None if case == "wrap" else chunk)
    if shape == (1, 2):
        out["scheduler"] = scheduled(payload, mesh)
    return out


def scheduled(payload, mesh):
    """Reduced qwen2 through ``ServeScheduler(mesh=, rules=SERVE_RULES)``
    (the reference's column-parallel weights, the ring's sequence over
    "model"): the token streams, decode steps and this rank's ring."""
    reset_plan_caches()
    cfg = cfg_of("qwen2-0.5b")
    params = transformer_params_from_numpy(payload["params"]["qwen2-0.5b"])
    s = S.ServeScheduler(cfg, params, tpl=default_template("cuda", device="cpu"),
                         clock=S.VirtualClock(), mesh=mesh, rules=sh.SERVE_RULES,
                         sched=S.SchedulerConfig(ladder=LADDER, slots=SLOTS,
                                                 max_new_limit=8, cache_len=SCHED_RING,
                                                 prefill_chunk=8))
    s.warmup()
    trace = [S.Request(prompt=tuple(int(t) for t in p), max_new=int(n), arrival=0.0,
                       rid=4000 + i) for i, (p, n) in enumerate(payload["trace"])]
    S.replay_trace(s, trace)
    out = {"streams": {r.rid: list(r.generated) for r in trace},
           "decode_steps": int(s.counters["decode_steps"]),
           "ring": _ring(s.cache)}
    s.release()
    return out


#: the card test's row-parallel GEMMs: (m, k, n) at route S (m <= 16) and
#: route W (bf16, m > 16)
GPU_GEMMS = ((4, 1024, 512), (256, 1024, 512))


def gpu_case(payload, rank, world, device):
    """Two ranks on the card over gloo, mesh (1, 2): each row-parallel GEMM
    of :data:`GPU_GEMMS` in bf16 on the ``cuda`` template (this rank's
    K-half, bias and ReLU after the f32 sum) and its partial alone; then
    each (1, 2) case of :data:`CASES` meshed and on one device, weights
    drawn on the card from a seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh((1, 2), ("data", "model")).init_groups()
    tpl = default_template("cuda", device=device)
    out = {"gemms": []}
    for m, k, n in GPU_GEMMS:
        gen = torch.Generator(device=device).manual_seed(m + k + n)
        x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=device) * k ** -0.5).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=device).to(torch.bfloat16)
        lo, hi = sh.local_rows(k, mesh, "model")
        xs = sh.mark_shard(x[:, lo:hi].contiguous(), ((-1, "model", k),))
        ws = sh.mark_shard(w[lo:hi].contiguous(), ((-2, "model", k),))
        _build.reset_launches()
        part = tpl.matmul(xs, ws)
        with sh.use_mesh(mesh, sh.SERVE_RULES):
            whole = tpl.matmul(xs, ws, bias=b, relu=True)
            summed = sh.constrain(part, None, None)
        out["gemms"].append({
            "shape": (m, k, n), "partial_dtype": str(part.dtype),
            "partial_axes": list(sh.partial_axes(part)),
            "partial": part.cpu().numpy(),
            "partial_plain": (x[:, lo:hi].float() @ w[lo:hi].float()).cpu().numpy(),
            "whole": whole.float().cpu().numpy(), "summed": summed.float().cpu().numpy(),
            "want": torch.relu(x.float() @ w.float() + b.float()).cpu().numpy(),
            "want_sum": (x.float() @ w.float()).cpu().numpy(),
            "launches": {key: v for key, v in _build.launches.items() if v}})
    for case, name, mshape, ring, length, gen in CASES:
        if mshape != (1, 2):
            continue
        reset_plan_caches()
        cfg = cfg_of(name)
        rules = rules_for("decode", cfg)
        whole = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        params = sh.shard_tree(whole, S.serve_shardings(cfg, mesh, rules, full=True))
        g = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (B, length + gen), generator=g, device=device)
        chunk = (torch.randint(0, cfg.vocab, (B, CHUNK), generator=g, device=device),
                 torch.tensor(CHUNK_VALID, device=device),
                 torch.randint(0, cfg.vocab, (B, CHUNK_STEPS), generator=g, device=device))
        chunk = None if case == "wrap" else chunk
        _build.reset_launches()
        meshed = steps_case(cfg, params, tpl, mesh, rules, ring, tokens, gen, chunk)
        meshed["launches"] = {key: v for key, v in _build.launches.items() if v}
        single = steps_case(cfg, whole, tpl, None, None, ring, tokens, gen, chunk)
        out[case] = {"meshed": meshed, "single": single}
    return out
