"""Rank bodies of the port's training tests, run by ``spawn_ranks``.

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port, and
returns numpy results to the test process.  Imported by name (``tests/``
is on ``sys.path`` under pytest).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import manager as M
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.template import default_template
from repro_torch.data import make_pipeline, synthetic_batch
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_init, cosine_warmup
from repro_torch.optim.compress import compressed_grad_reduce, init_error_feedback
from repro_torch.parallel import sharding as sh

#: the meshes of the meshed training cases: (sizes, axis names); those
#: whose "model" axis is above 1 are the tensor-parallel cases'
MESHES = {"4x1": ((4, 1), ("data", "model")), "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")), "1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the meshed optimizer step's schedule and clip norm (the test's reference
#: uses the same; the clip is below every case's grad norm, so it acts)
LR = (1e-3, 3, 30)
CLIP = 0.5


def compressed_reduce_case(payload, rank, world, device):
    """``compressed_grad_reduce`` over a ``world``-way "data" axis: this
    rank's gradient tree is ``payload["grads"][rank]``; once without and once
    with error feedback (a zero state)."""
    mesh = Mesh((world,), ("data",)).init_groups()
    grads = {k: torch.from_numpy(v).to(device) for k, v in payload["grads"][rank].items()}
    plain, ef = compressed_grad_reduce(grads, mesh, axis="data")
    assert ef is None
    with_ef, ef = compressed_grad_reduce(grads, mesh, axis="data",
                                         ef_state=init_error_feedback(grads))
    return {"plain": plain, "ef": with_ef, "residual": ef}


def _plain(state):
    """A {"params", "opt"} state with its OptState as a dict (results cross
    the process boundary as plain trees)."""
    return {"params": state["params"], "opt": state["opt"]._asdict()}


def _unshard_tree(tree, shardings):
    """Each leaf of this rank's shard tree gathered to its logical shape
    (``sharding.unshard_leaf`` leaf by leaf; every rank calls it, in one
    order)."""
    if shardings is None or tree is None:
        return tree
    if isinstance(shardings, sh.NamedSharding):
        if isinstance(tree, (dict, tuple, list)):
            assert not shardings.spec, f"a sharded spec {shardings.spec} over a subtree"
            return tree
        return sh.unshard_leaf(tree, shardings)
    if isinstance(shardings, dict):
        return {k: _unshard_tree(tree[k], shardings[k]) for k in shardings}
    items = [_unshard_tree(t, s) for t, s in zip(tree, shardings)]
    return type(shardings)(*items) if hasattr(shardings, "_fields") else type(shardings)(items)


def _cfg(case):
    return dataclasses.replace(reduced(get_config(case["arch"])), **case["overrides"])


def _rules(cfg, kind):
    rules = sh.TRAIN_RULES.with_overrides(**dict(cfg.rule_overrides))
    return rules.with_overrides(embed=None) if kind == "dp" else rules


def _rows(case, mesh, rules, accum=1):
    """This rank's rows of the case's batch, as the pipeline keeps them."""
    rows = sh.microbatch_rows(case["tokens"].shape[0], accum, mesh, rules.get("batch"))
    out = {"tokens": torch.from_numpy(case["tokens"][rows]).long()}
    if case["ctx"] is not None:
        out["ctx"] = torch.from_numpy(case["ctx"][rows])
    return out


def _meshed_step(case, mesh, kind, accum, lead):
    """One case on ``mesh``: the global loss, metrics and logical grads of
    ``loss_and_grads``, then ``make_train_step``'s metrics and its updated
    params and moments, gathered to their logical shapes, after one AdamW
    step (rank 0 returns them)."""
    cfg = _cfg(case)
    rules = _rules(cfg, kind)
    tpl = default_template("torch", device="cpu")
    p_sh, o_sh = steps.state_shardings(cfg, mesh, rules)
    params = sh.shard_tree(transformer_params_from_numpy(case["params"]), p_sh)
    batch = _rows(case, mesh, rules, accum)
    sh.SEAM_COUNTS.clear()
    loss, metrics, grads = steps.loss_and_grads(tpl, cfg, params, batch, accum=accum,
                                                mesh=mesh, rules=rules)
    counts = dict(sh.SEAM_COUNTS)  # the seams' collectives of one loss and grads
    grads = _unshard_tree(grads, p_sh)
    opt = AdamW(lr=cosine_warmup(*LR), clip_norm=CLIP)
    step = steps.make_train_step(cfg, tpl=tpl, opt=opt, accum=accum, mesh=mesh, rules=rules)
    new_params, new_opt, m = step(params, adamw_init(params), batch)
    # the updated shards, gathered: every rank calls it, in one order
    new = {"params": _unshard_tree(new_params, p_sh), "m": _unshard_tree(new_opt.m, p_sh),
           "v": _unshard_tree(new_opt.v, p_sh)}
    out = {"loss": loss, "metrics": metrics, "grads": grads, "step": m, "new": new,
           "embed_local": tuple(params["embed"].shape), "counts": counts}
    if case.get("save_dir"):
        # the state after the step, saved gathered (rank 0 writes) and whole
        state = {"params": new_params, "opt": new_opt}
        M.save(case["save_dir"], 1, state, shardings={"params": p_sh, "opt": o_sh})
        out["saved"] = _plain(_unshard_tree(state, {"params": p_sh, "opt": o_sh}))
    return out if lead else None


class _Meshes(dict):
    """The meshes of :data:`MESHES` by name, each made at its first use (its
    process groups are a collective: every rank asks in one order)."""

    def __missing__(self, name):
        self[name] = mesh = Mesh(*MESHES[name]).init_groups()
        return mesh


def train_mesh_case(payload, rank, world, device):
    """The meshed training cases on ``world`` ranks: ``payload["cases"]``
    (arch, mesh, kind "fsdp" / "dp", accum, weights and batch as numpy),
    then the rank-level checks named in ``payload``: pipeline rows, the
    training driver's run with and without a failure (on a ("data",
    "model") = (world / model, model) mesh, ``payload["restart"]["model"]``,
    default 1), refusals, and the restore of a checkpoint onto a
    (world, 1) FSDP mesh.  Rank 0 returns the results."""
    lead = rank == 0
    meshes = _Meshes()
    out = {"cases": []}
    for case in payload["cases"]:
        out["cases"].append(_meshed_step(case, meshes[case["mesh"]], case["kind"],
                                         case["accum"], lead))
    if "pipeline" in payload:
        mesh = meshes["4x1"]
        cfg = reduced(get_config("qwen2-0.5b"))
        rules = _rules(cfg, "fsdp")
        pipe = make_pipeline(cfg, SHAPES["train_4k"], seed=3, mesh=mesh, rules=rules,
                             global_batch=8, seq_len=16, device="cpu", accum=2)
        whole = synthetic_batch(3, 5, 8, 16, cfg.vocab)
        out["pipeline_rows"] = pipe.rows()
        out["pipeline_ok"] = bool(torch.equal(pipe.batch(5)["tokens"], whole[pipe.rows()]))
    if "restart" in payload:
        # the training driver called on every rank (it trains on these
        # ranks), fault-free and with a failure
        base = ["--steps", "4", "--batch", "8", "--seq", "32", "--log-every", "100",
                "--device", "cpu", "--mesh", "single",
                "--model", str(payload["restart"].get("model", 1))]
        free = train.main(base + ["--ckpt-dir", payload["restart"]["free"]])
        faulty = train.main(base + ["--ckpt-dir", payload["restart"]["faulty"],
                                    "--ckpt-every", "2", "--fail-at", "3"])
        out["restart"] = {"free": free, "faulty": faulty}
    if "refusals" in payload:
        tpl = default_template("torch", device="cpu")
        # an MoE batch whose groups straddle the ranks: 128 tokens a rank,
        # groups of 512
        case = payload["refusals"]
        moe = _cfg(case)
        rules = _rules(moe, "fsdp")
        mesh = meshes["4x1"]
        p_sh, _ = steps.state_shardings(moe, mesh, rules)
        params = sh.shard_tree(transformer_params_from_numpy(case["params"]), p_sh)
        try:
            steps.loss_and_grads(tpl, moe, params, _rows(case, mesh, rules), mesh=mesh,
                                 rules=rules)
            out["straddle"] = None
        except ValueError as e:
            out["straddle"] = str(e)
    if "restore" in payload:
        out["restore"] = _restore(payload["restore"], meshes[f"{world}x1"], rank)
    return out if lead else None


def _restore(payload, mesh, rank):
    """A checkpoint restored onto ``mesh``'s FSDP shardings, gathered back
    whole; rank 0 returns it and its local embed shape.  Waits (up to three
    minutes, a loaded host's start-up) for another call's ranks to write
    the checkpoint."""
    deadline = time.monotonic() + 180
    while M.latest_step(payload["dir"]) != payload["step"] and time.monotonic() < deadline:
        time.sleep(0.1)
    cfg = _cfg(payload)
    p_sh, o_sh = steps.state_shardings(cfg, mesh, _rules(cfg, "fsdp"))
    shardings = {"params": p_sh, "opt": o_sh}
    target = T.init_params(torch.Generator().manual_seed(7), cfg, shardings=p_sh)
    state = M.restore(payload["dir"], payload["step"],
                      {"params": target, "opt": adamw_init(target)}, shardings)
    whole = _plain(_unshard_tree(state, shardings))  # a collective: every rank
    return ({"state": whole, "embed_local": tuple(state["params"]["embed"].shape)}
            if rank == 0 else None)


def remat_case(payload, rank, world, device):
    """Reduced qwen2 with ``remat`` on, FSDP over a (world / model, model)
    mesh on ``device`` (``payload["model"]``, default 1): the meshed
    ``loss_and_grads`` from ``init_params`` at the seed (each recomputed
    region gathers its layer, and over "model" its sequence, again in the
    backward); rank 0 returns the loss and the logical grads."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=True)
    model = payload.get("model", 1)
    mesh = Mesh((world // model, model), ("data", "model")).init_groups()
    rules = _rules(cfg, "fsdp")
    p_sh, _ = steps.state_shardings(cfg, mesh, rules)
    params = T.init_params(torch.Generator(device=device).manual_seed(payload["seed"]), cfg,
                           shardings=p_sh)
    rows = sh.microbatch_rows(payload["batch"], 1, mesh, rules.get("batch"))
    tokens = synthetic_batch(payload["seed"], 0, payload["batch"], payload["seq"],
                             cfg.vocab)[rows].to(device)
    loss, _, grads = steps.loss_and_grads(default_template("torch", device=str(device)), cfg,
                                          params, {"tokens": tokens}, mesh=mesh, rules=rules)
    whole = _unshard_tree(grads, p_sh)  # a collective: every rank
    return {"loss": loss, "grads": whole} if rank == 0 else None
