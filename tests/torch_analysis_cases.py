"""Rank bodies of the op analyzer's tests, run by ``spawn_ranks``, and the
steps they share with the recording rank of the test process.

Each rank body runs one step on gloo CPU ranks with every collective the
port hands to ``torch.distributed`` logged as (kind, mesh axis, group
size, result bytes): the record a recording rank keeps
(``sharding.Collective``).  Imports only the port.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data import synthetic_batch
from repro_torch.launch import scheduler as S
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding as sh

ARCH = "qwen2-0.5b"
#: the train case: (mesh sizes, axes), global batch rows, sequence
TRAIN = (((2, 2), ("data", "model")), 8, 32)
#: the decode case: (mesh sizes, axes), batch rows, prompt tokens, cache length
DECODE = (((1, 2), ("data", "model")), 2, 8, 16)


def cfg():
    return reduced(get_config(ARCH))


def train_setup(mesh, real: bool):
    """(step, params, opt state, batch) of rank ``mesh.rank``'s reduced
    qwen2 train step under ``TRAIN_RULES``: real shards drawn from a seed,
    or fake ones (``steps.abstract_params``) for a recording rank."""
    c = cfg()
    rules = sh.TRAIN_RULES.with_overrides(**dict(c.rule_overrides))
    tpl = default_template("torch", device="cpu")
    p_sh, o_sh = steps.state_shardings(c, mesh, rules)
    _, rows, seq = TRAIN
    if real:
        params = T.init_params(torch.Generator().manual_seed(3), c, shardings=p_sh)
        opt = adamw_init(params)
    else:
        whole = steps.abstract_params(c)
        params = sh.shard_tree(whole, p_sh)
        opt = sh.shard_tree(steps.abstract_opt_state(c, whole), o_sh)
    take = sh.microbatch_rows(rows, 1, mesh, rules.get("batch"))
    tokens = synthetic_batch(5, 0, rows, seq, c.vocab)[take]
    batch = {"tokens": tokens, "labels": tokens}
    step = steps.make_train_step(c, tpl=tpl, mesh=mesh, rules=rules)
    return step, (params, opt, batch), tpl, rules


def decode_setup(mesh, real: bool, serve: bool = False):
    """(decode, (params, token, t, cache)) of rank ``mesh.rank``'s meshed
    decode step of reduced qwen2 under ``DECODE_RULES``, through
    ``compiled_steps(mesh=)`` as the meshed scheduler runs it, at position
    ``prompt`` of a cache of ``cache_len``; ``serve``: under the dry-run's
    decode rules (``SERVE_RULES``: the ring's sequence over "model", the
    weights in their whole layout, wo and down row-parallel) instead."""
    c = cfg()
    rules = sh.SERVE_RULES if serve else sh.DECODE_RULES
    tpl = default_template("torch", device="cpu")
    _, rows, prompt, cache_len = DECODE
    p_sh = S.serve_shardings(c, mesh, rules, full=serve)
    if real:
        params = T.init_params(torch.Generator().manual_seed(4), c, shardings=p_sh)
        cache = T.init_cache(c, rows, cache_len)
    else:
        params = sh.shard_tree(steps.abstract_params(c), p_sh)
        cache = steps.abstract_cache(c, rows, cache_len)
    cache = S.shard_cache(c, cache, mesh, rules)
    token = synthetic_batch(6, 0, rows, 1, c.vocab)
    fns = S.compiled_steps(tpl, c, cache_len, mesh=mesh, rules=rules)
    return fns.decode, (params, token, torch.tensor(prompt, dtype=torch.int32), cache), \
        tpl, rules


@contextlib.contextmanager
def logged(mesh):
    """Yields the list of (kind, axis, group size, result bytes) of every
    collective the port passes to ``torch.distributed`` on this rank while
    the block runs."""
    axis_of = {id(g): a for a, g in mesh.groups.items() if g is not None}
    log = []

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def add(kind, group, size):
        log.append((kind, axis_of[id(group)], dist.get_world_size(group), int(size)))

    orig = {k: getattr(dist, k) for k in ("all_gather", "all_gather_into_tensor",
                                          "all_reduce", "gather")}
    orig_rs = sh._reduce_scatter

    def all_gather(out, src, group=None, **kw):
        add("all-gather", group, nbytes(out))
        return orig["all_gather"](out, src, group=group, **kw)

    def all_gather_into_tensor(out, src, group=None, **kw):
        add("all-gather", group, nbytes([out]))
        return orig["all_gather_into_tensor"](out, src, group=group, **kw)

    def all_reduce(buf, group=None, **kw):
        add("all-reduce", group, nbytes([buf]))
        return orig["all_reduce"](buf, group=group, **kw)

    def gather(src, out=None, dst=0, group=None, **kw):
        add("gather", group, dist.get_world_size(group) * nbytes([src]))
        return orig["gather"](src, out, dst=dst, group=group, **kw)

    def reduce_scatter(out, src, group=None, **kw):
        add("reduce-scatter", group, nbytes([out]))
        return orig_rs(out, src, group=group, **kw)

    for k, fn in (("all_gather", all_gather), ("all_gather_into_tensor", all_gather_into_tensor),
                  ("all_reduce", all_reduce), ("gather", gather)):
        setattr(dist, k, fn)
    sh._reduce_scatter = reduce_scatter
    try:
        yield log
    finally:
        for k, fn in orig.items():
            setattr(dist, k, fn)
        sh._reduce_scatter = orig_rs


def _run_logged(mesh, setup):
    fn, args, _, _ = setup(mesh, real=True)
    sh.SEAM_COUNTS.clear()
    with logged(mesh) as log:
        fn(*args)
    return {"counts": dict(sh.SEAM_COUNTS), "log": log}


def train_case(payload, rank, world, device):
    """The train case on ``world`` gloo ranks; each rank returns its seam
    counts and its logged collectives."""
    mesh = Mesh(*TRAIN[0]).init_groups()
    return _run_logged(mesh, train_setup)


def decode_case(payload, rank, world, device):
    """The decode case on ``world`` gloo ranks, as :func:`train_case`."""
    mesh = Mesh(*DECODE[0]).init_groups()
    return _run_logged(mesh, decode_setup)


def serve_decode_setup(mesh, real: bool):
    """:func:`decode_setup` under ``SERVE_RULES``."""
    return decode_setup(mesh, real, serve=True)


def serve_decode_case(payload, rank, world, device):
    """The ``SERVE_RULES`` decode case on ``world`` gloo ranks."""
    mesh = Mesh(*DECODE[0]).init_groups()
    return _run_logged(mesh, serve_decode_setup)
