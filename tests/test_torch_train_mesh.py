"""The port's data-parallel, FSDP and pod x data training on gloo CPU ranks,
held against the reference's single-device step.

Reduced configs with the reference's ``init_params`` weights (live norm
scales, ``tests/torch_family_cases.py``) and a numpy token batch: qwen2-0.5b
on 8 x 32 tokens, granite-moe at its default ``capacity_factor`` (tokens
drop) on 8 x 256 tokens, so its groups of 512 tokens align with the ranks
(mamba2 and whisper: ``tests/test_torch_train_mesh_families.py``).  Every
rank holds its rows of the batch and its shards of the weights; the
reference runs ``jax.value_and_grad(loss_fn)`` on its ``xla`` backend over
the whole batch (with ``accum`` 2, over each half in turn, grads summed in
f32 and averaged, as its scan does).  Meshes: (4, 1) FSDP
(``TRAIN_RULES``), (4, 1) data-parallel (``embed=None``), (2, 2, 1) pod x
data and (2, 1) FSDP at ``accum`` 2; qwen2 also with ``remat`` on (the
shards gathered inside each recomputed region).  Tolerances, those of
``tests/test_torch_train_step.py``: the loss (and ce, aux) within 1e-5
relative, every grad leaf within 1e-4 of its largest |g|, the step's
loss, grad norm and lr within 1e-5 after one AdamW step, and the step's
updated params and moments, gathered, against the reference's
``adamw_update`` (``check_update``).

Rank-level checks: the pipeline keeps a rank's rows of each microbatch; the
training driver's run on a mesh restarts bit for bit; a checkpoint saved on 4 ranks
restores onto 2 ranks and onto one device with equal logical params; an MoE
group that straddles two ranks is refused.  (The "model" axis:
``tests/test_torch_train_tp.py``.)
All cases of one rank count run in one ``spawn_ranks`` call, while the test
process computes the reference's steps.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.template import default_template as j_template
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.adamw import global_norm as j_global_norm
from repro_torch.checkpoint import manager as M
from repro_torch.configs import get_config, reduced
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.template import default_template
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

import torch_train_cases
from torch_family_cases import _cfgs, _ctx, _live, _np_tree

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6

#: (case id, arch, overrides, batch rows, seq, mesh, kind, accum)
CASES = [
    ("qwen2-fsdp", "qwen2-0.5b", {}, 8, 32, "4x1", "fsdp", 1),
    ("qwen2-dp", "qwen2-0.5b", {}, 8, 32, "4x1", "dp", 1),
    ("qwen2-pod-data", "qwen2-0.5b", {}, 8, 32, "2x2x1", "fsdp", 1),
    ("qwen2-fsdp-remat", "qwen2-0.5b", {"remat": True}, 8, 32, "4x1", "fsdp", 1),
    ("qwen2-accum2", "qwen2-0.5b", {}, 8, 32, "2x1", "fsdp", 2),
    ("granite-fsdp", "granite-moe-3b-a800m", {}, 8, 256, "4x1", "fsdp", 1),
    ("granite-dp", "granite-moe-3b-a800m", {}, 8, 256, "4x1", "dp", 1),
    ("granite-pod-data", "granite-moe-3b-a800m", {}, 8, 256, "2x2x1", "fsdp", 1),
    ("granite-accum2", "granite-moe-3b-a800m", {}, 8, 256, "2x1", "fsdp", 2),
]
IDS = [c[0] for c in CASES]

_SETUPS = {}


def _setup(arch, overrides, b, s):
    """(cfg_j, numpy weights, tokens, ctx) of a reduced config, memoized."""
    key = (arch, tuple(sorted(overrides.items())), b, s)
    if key not in _SETUPS:
        cfg_j, cfg = _cfgs(arch, **overrides)
        rng = np.random.default_rng(1)
        tree = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg_j))
        _live(tree, cfg, rng)
        tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        _SETUPS[key] = (cfg_j, tree, tokens, _ctx(cfg, rng, b))
    return _SETUPS[key]


def _payload(arch, overrides, b, s, **kw):
    _, tree, tokens, ctx = _setup(arch, overrides, b, s)
    return {"arch": arch, "overrides": overrides, "params": tree, "tokens": tokens,
            "ctx": ctx, **kw}


_REF = {}


def reference(arch, overrides, b, s, accum):
    """The reference's (loss, {"ce", "aux"}, grads, global norm) on the
    whole batch, ``accum`` microbatches as its train step splits them."""
    overrides = {k: v for k, v in overrides.items() if k != "remat"}  # the same numbers
    key = (arch, tuple(sorted(overrides.items())), b, s, accum)
    if key not in _REF:
        cfg_j, tree, tokens, ctx = _setup(arch, overrides, b, s)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        tpl = j_template("xla")
        fn = jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(tpl, cfg_j, p, bt),
                                        has_aux=True))
        mb = b // accum
        gsum, lsum, auxsum = None, 0.0, 0.0
        for i in range(accum):
            batch = {"tokens": jnp.asarray(tokens[i * mb:(i + 1) * mb])}
            if ctx is not None:
                batch["ctx"] = jnp.asarray(ctx[i * mb:(i + 1) * mb])
            (loss, metrics), g = fn(params, batch)
            g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
            lsum, auxsum = lsum + loss, auxsum + metrics["aux"]
            ce = metrics["ce"]
        grads = jax.tree.map(lambda x: x / accum, gsum) if accum > 1 else gsum
        loss = lsum / accum
        metrics = {"ce": loss if accum > 1 else ce, "aux": auxsum / accum}
        _REF[key] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     jax.tree.map(np.asarray, grads), float(j_global_norm(grads)))
    return _REF[key]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _update(jopt, params, grads):
    """The reference's ``adamw_update`` from ``adamw_init`` (step 1):
    (new params, m, v) as numpy trees."""
    params = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda g: jnp.asarray(np.asarray(g)), grads)
    new, state, _ = j_adamw_update(jopt, grads, j_adamw_init(params), params)
    return tuple(jax.tree.map(np.asarray, t) for t in (new, state.m, state.v))


def check_update(got, params, want_grads, jopt):
    """The meshed step's updated params and moments, gathered, against the
    reference's ``adamw_update`` on one device.  Fed the reference's grads,
    m and sqrt(v) (each |g| times a constant and the clip scale) stay within
    ``GRAD_TOL`` of each leaf's largest value, as the grads do.  The params
    at step 1 move by about lr·sign(g), so a grad near 0 that differs by
    less than the grad tolerance could flip a weight's step: they are held
    against the reference's update fed the port's own gathered grads
    (``ADAM_TOL`` of each leaf's largest value, m and v too), which checks
    the sharded update itself: the moments' shards, the decay on matrices
    only, the clip by the global norm (every case's norm exceeds ``CLIP``, so the
    clip acts)."""
    new = got["new"]
    _, want_m, want_v = _update(jopt, params, want_grads)
    for name, want, have in (("m", want_m, new["m"]), ("sqrt(v)", jax.tree.map(np.sqrt, want_v),
                                                       jax.tree.map(np.sqrt, new["v"]))):
        jax.tree_util.tree_map_with_path(
            lambda p, w, g, name=name: _within(f"{name}{jax.tree_util.keystr(p)}", w, g,
                                               GRAD_TOL), want, have)
    for name, want, have in zip(("params", "m", "v"), _update(jopt, params, got["grads"]),
                                (new["params"], new["m"], new["v"])):
        jax.tree_util.tree_map_with_path(
            lambda p, w, g, name=name: _within(f"{name}{jax.tree_util.keystr(p)}", w, g,
                                               ADAM_TOL), want, have)


def _within(path, want, got, tol):
    got = np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all(), path
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * max(scale, 1e-12), (path, err, scale)


def check_case(got, case):
    """One meshed case's results against the reference's single-device step
    (the tolerances of the module docstring)."""
    _, arch, ov, b, s, mesh, kind, accum = case
    want_loss, want, want_grads, want_norm = reference(arch, ov, b, s, accum)
    assert _rel(float(got["loss"]), want_loss) <= LOSS_TOL
    assert _rel(float(got["metrics"]["ce"]), want["ce"]) <= LOSS_TOL
    assert abs(float(got["metrics"]["aux"]) - want["aux"]) <= \
        LOSS_TOL * max(abs(want["aux"]), 1.0)
    n = []

    def check(path, w, g):
        g = np.asarray(g)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * max(scale, 1e-12), (path, err, scale)
        n.append(path)

    jax.tree_util.tree_map_with_path(lambda p, w, g: check(jax.tree_util.keystr(p), w, g),
                                     want_grads, got["grads"])
    assert len(n) == len(jax.tree.leaves(want_grads))
    m = got["step"]
    assert _rel(float(m["loss"]), want_loss) <= LOSS_TOL
    assert _rel(float(m["grad_norm"]), want_norm) <= LOSS_TOL
    jopt = JAdamW(lr=j_cosine_warmup(*torch_train_cases.LR), clip_norm=torch_train_cases.CLIP)
    assert want_norm > jopt.clip_norm  # the update below clips
    want_lr = float(jopt.lr(jnp.int32(1)))
    assert _rel(float(m["lr"]), want_lr) <= 1e-7
    check_update(got, _setup(arch, ov, b, s)[1], want_grads, jopt)
    # FSDP holds a quarter (a half) of the embedding's d_model a rank
    d = reduced(get_config(arch)).d_model
    shards = {"4x1": 4, "2x2x1": 2, "2x1": 2}[mesh] if kind == "fsdp" else 1
    assert got["embed_local"][1] == d // shards


def _spawn_all(tmp):
    """Rank 0's results of the 4-rank call (every 4-rank case and the
    rank-level checks) and of the 2-rank call (the accum-2 cases and the
    restore of the 4-rank checkpoint)."""
    cases4 = [c for c in CASES if c[5] != "2x1"]
    cases2 = [c for c in CASES if c[5] == "2x1"]
    payload4 = {
        "cases": [_payload(arch, ov, b, s, mesh=m, kind=k, accum=a,
                           save_dir=str(tmp / "saved") if cid == "qwen2-fsdp" else None)
                  for cid, arch, ov, b, s, m, k, a in cases4],
        "pipeline": True,
        "restart": {"free": str(tmp / "free"), "faulty": str(tmp / "faulty")},
        "refusals": _payload("granite-moe-3b-a800m", {}, 8, 64),
    }
    payload2 = {"cases": [_payload(arch, ov, b, s, mesh=m, kind=k, accum=a)
                          for cid, arch, ov, b, s, m, k, a in cases2],
                "restore": {"arch": "qwen2-0.5b", "overrides": {}, "dir": str(tmp / "saved"),
                            "step": 1}}
    # both calls at once: the 2 ranks restore once the 4 have saved
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(spawn_ranks, functools.partial(torch_train_cases.train_mesh_case,
                                                         payload2), 2, device="cpu",
                          timeout=240)
        out4 = spawn_ranks(functools.partial(torch_train_cases.train_mesh_case, payload4), 4,
                           device="cpu", timeout=240)[0]
        out2 = two.result()[0]
    by_id = dict(zip([c[0] for c in cases4], out4["cases"]))
    by_id.update(zip([c[0] for c in cases2], out2["cases"]))
    return {"cases": by_id, "out4": out4, "restored2": out2["restore"], "tmp": tmp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results; the reference's steps are computed while the
    ranks run (each side's start-up and compiles overlap)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn_all, tmp)
        for _, arch, ov, b, s, _, _, accum in CASES:
            reference(arch, ov, b, s, accum)
        return ranks.result()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_meshed_step_matches_reference(runs, case):
    check_case(runs["cases"][case[0]], case)


def test_granite_drops_tokens_at_the_default_capacity(monkeypatch):
    """The granite cases run at the default capacity factor, where the
    groups overflow: in the forward over their batch, each MoE layer's four
    groups of 512 tokens drop some (token, choice) pairs."""
    _, tree, tokens, _ = _setup("granite-moe-3b-a800m", {}, 8, 256)
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    assert cfg.capacity_factor == 1.25 and cfg.moe_group == 512
    seen, groups, queues = [], moe._groups, moe._queue_positions

    def record_groups(cfg_, x):
        out = groups(cfg_, x)
        seen.append([out[0].shape[0], out[2], None])
        return out

    def record_queues(cfg_, idx):
        pos, onehot = queues(cfg_, idx)
        seen[-1][2] = int((pos >= seen[-1][1]).sum())
        return pos, onehot

    monkeypatch.setattr(moe, "_groups", record_groups)
    monkeypatch.setattr(moe, "_queue_positions", record_queues)
    T.forward(default_template("torch", device="cpu"), cfg,
              transformer_params_from_numpy(tree), torch.from_numpy(tokens).long())
    assert len(seen) == cfg.n_layers
    assert all(g == 4 and dropped > 0 for g, _, dropped in seen), seen


def test_pipeline_keeps_each_rank_rows(runs):
    """With accum 2 over 4 ranks, rank 0 holds row 0 of each 4-row
    microbatch, and the pipeline's batch is the global draw's rows."""
    out = runs["out4"]
    assert out["pipeline_rows"] == [0, 4] and out["pipeline_ok"]


def test_restart_on_a_mesh_resumes_bit_for_bit(runs):
    """The driver called on each of 4 ranks (it trains on them, a (4, 1)
    mesh): a failure at step 3 resumes from the step-2 checkpoint and
    replays the fault-free run's losses bit for bit."""
    (free_stats, free), (stats, faulty) = (runs["out4"]["restart"][k]
                                           for k in ("free", "faulty"))
    assert free_stats["failures"] == 0 and len(free) == 4
    assert stats["failures"] == 1 and stats["restarts"] == [2]
    assert faulty == free[:3] + free[2:]
    assert all(np.isfinite(free))


def _equal_trees(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_checkpoint_restores_onto_other_meshes(runs):
    """The state after a (4, 1) FSDP step, saved gathered by rank 0,
    restores onto a (2, 1) mesh (each rank its half) and onto one device,
    equal to the 4-rank state leaf for leaf."""
    saved = runs["cases"]["qwen2-fsdp"]["saved"]
    r2 = runs["restored2"]
    assert r2["embed_local"][1] == reduced(get_config("qwen2-0.5b")).d_model // 2
    _equal_trees(r2["state"], saved)
    cfg = reduced(get_config("qwen2-0.5b"))
    target = T.init_params(torch.Generator().manual_seed(7), cfg)
    one = M.restore(str(runs["tmp"] / "saved"), 1, {"params": target,
                                                    "opt": adamw_init(target)})
    one = {"params": one["params"], "opt": one["opt"]._asdict()}
    _equal_trees(jax.tree.map(lambda t: t.numpy(), one), saved)


def test_a_straddling_moe_group_raises(runs):
    """granite on 8 x 64 tokens over 4 ranks: 128 tokens a rank, groups of
    512, so a group would span ranks: a ValueError, not a silent regroup."""
    msg = runs["out4"]["straddle"]
    assert msg is not None and "span two ranks" in msg and "512" in msg
