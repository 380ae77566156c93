"""The port's tensor-parallel training (the "model" axis of ``TRAIN_RULES``:
sequence-parallel activations, row-parallel reduce-scatter seams) on gloo
CPU ranks, held against the reference's single-device step.

The setup, reference and tolerances are ``tests/test_torch_train_mesh.py``'s:
reduced configs with the reference's ``init_params`` weights (live norm
scales and cross gates), a numpy token batch, the reference's
``jax.value_and_grad(loss_fn)`` on its ``xla`` backend over the whole batch.
Each rank holds its rows of the batch (ranks that share a data coordinate
the same rows) and its shards of the weights; the residual stream holds its
shard of the sequence.  Held: the loss (and ce, aux) within 1e-5 relative,
every grad leaf, gathered, within 1e-4 of its largest |g|, the step's loss,
grad norm and lr after one AdamW step, and the updated params and moments
through ``check_update``.

Meshes: qwen2-0.5b on (1, 2), (1, 4) (two kv heads over four ranks: a
column shard of wk / wv holds half a head, gathered whole), (2, 2) FSDP x TP
plain, with ``remat`` and at ``accum`` 2, and (2, 2, 2) pod x data x model
(the reference's ``make_test_mesh(multi_pod=True)``); granite-moe on (2, 2)
(``expert_cap`` over "model") and phi3.5-moe on (1, 2) (experts over
"model"), tokens dropping at the default capacity; mamba2, whisper,
recurrentgemma and llama-vision on (1, 2).  Also: the seams' collective
counts on one qwen2 step, the driver's run on (2, 2) restarting bit for
bit, and a (2, 2) checkpoint restoring onto (4, 1) and onto one device.
One ``spawn_ranks`` call a rank count (2, 4 and 8), all at once, while the
test process computes the reference's steps.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import cosine_warmup as j_cosine_warmup
from repro_torch.checkpoint import manager as M
from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.convert import transformer_params_from_numpy

import torch_train_cases
from test_torch_train_mesh import (GRAD_TOL, LOSS_TOL, _equal_trees, _payload, _rel, _setup,
                                   check_update, reference)

#: (case id, arch, overrides, batch rows, seq, mesh, kind, accum)
CASES = [
    ("qwen2-tp2", "qwen2-0.5b", {}, 8, 32, "1x2", "fsdp", 1),
    ("qwen2-tp4-half-kv-head", "qwen2-0.5b", {}, 8, 32, "1x4", "fsdp", 1),
    ("qwen2-fsdp-tp", "qwen2-0.5b", {}, 8, 32, "2x2", "fsdp", 1),
    ("qwen2-fsdp-tp-remat", "qwen2-0.5b", {"remat": True}, 8, 32, "2x2", "fsdp", 1),
    ("qwen2-fsdp-tp-accum2", "qwen2-0.5b", {}, 8, 32, "2x2", "fsdp", 2),
    ("qwen2-pod-data-tp", "qwen2-0.5b", {}, 8, 32, "2x2x2", "fsdp", 1),
    ("granite-fsdp-tp", "granite-moe-3b-a800m", {}, 8, 256, "2x2", "fsdp", 1),
    ("phi3.5-tp2", "phi3.5-moe-42b-a6.6b", {}, 4, 128, "1x2", "fsdp", 1),
    ("mamba2-tp2", "mamba2-1.3b", {}, 8, 16, "1x2", "fsdp", 1),
    ("whisper-tp2", "whisper-medium", {}, 8, 16, "1x2", "fsdp", 1),
    ("recurrentgemma-tp2", "recurrentgemma-9b", {}, 8, 32, "1x2", "fsdp", 1),
    ("llama-vision-tp2", "llama-3.2-vision-90b", {}, 8, 16, "1x2", "fsdp", 1),
]
IDS = [c[0] for c in CASES]
RANKS = {"1x2": 2, "1x4": 4, "2x2": 4, "2x2x2": 8}
#: (data, model) shards of each mesh: the embedding table's local shape
SHARDS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "2x2x2": (2, 2)}


def _spawn_all(tmp):
    """Rank 0's results of the three calls: 2 ranks (the (1, 2) cases), 4
    ranks (the (1, 4) and (2, 2) cases, the driver's restart, the (2, 2)
    checkpoint and its restore onto (4, 1)) and 8 ranks (pod x data x
    model)."""
    def payload(world, **kw):
        cases = [c for c in CASES if RANKS[c[5]] == world]
        return cases, {"cases": [
            _payload(arch, ov, b, s, mesh=m, kind=k, accum=a,
                     save_dir=str(tmp / "saved") if cid == "qwen2-fsdp-tp" else None)
            for cid, arch, ov, b, s, m, k, a in cases], **kw}

    calls = {2: payload(2), 8: payload(8),
             4: payload(4, restart={"free": str(tmp / "free"), "faulty": str(tmp / "faulty"),
                                    "model": 2},
                        restore={"arch": "qwen2-0.5b", "overrides": {},
                                 "dir": str(tmp / "saved"), "step": 1})}
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = {world: pool.submit(spawn_ranks,
                                      functools.partial(torch_train_cases.train_mesh_case, p),
                                      world, device="cpu", timeout=240)
                   for world, (_, p) in calls.items()}
        outs = {world: f.result()[0] for world, f in futures.items()}
    by_id = {}
    for world, (cases, _) in calls.items():
        by_id.update(zip([c[0] for c in cases], outs[world]["cases"]))
    return {"cases": by_id, "out4": outs[4], "tmp": tmp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results; the reference's steps are computed while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("train_tp")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn_all, tmp)
        for _, arch, ov, b, s, _, _, accum in CASES:
            reference(arch, ov, b, s, accum)
        return ranks.result()


def check_tp_case(got, case):
    """One tensor-parallel case against the reference's single-device step:
    the tolerances of ``tests/test_torch_train_mesh.py``."""
    _, arch, ov, b, s, mesh, _, accum = case
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
    assert _rel(float(m["lr"]), float(jopt.lr(jnp.int32(1)))) <= 1e-7
    check_update(got, _setup(arch, ov, b, s)[1], want_grads, jopt)
    # the table: vocab over "model", d_model over "data"
    cfg = reduced(get_config(arch))
    data, model = SHARDS[mesh]
    assert got["embed_local"] == (cfg.vocab // model, cfg.d_model // data)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_parallel_step_matches_reference(runs, case):
    check_tp_case(runs["cases"][case[0]], case)


def test_seam_collectives_on_one_qwen2_step(runs):
    """The seams' collectives of one reduced qwen2 loss and grads on (1, 2),
    by (seam, pass, axis): per layer two sequence gathers (attention's and
    the MLP's input) and two reduce-scatters (wo's and down's partial sums),
    plus the embedding's reduce-scatter and the head's vocab gather, each
    with its adjoint in the backward; no cut, no activation all-reduce; one
    bucket of grads all-reduced over "model", the mask count and the
    metrics summed over it."""
    layers = reduced(get_config("qwen2-0.5b")).n_layers
    got = runs["cases"]["qwen2-tp2"]["counts"]
    want = {}
    for phase in ("fwd", "bwd"):
        want[("act_gather", phase, "model")] = 2 * layers
        want[("act_scatter", phase, "model")] = 2 * layers + 1
        want[("param_gather", phase, "model")] = 1
    want[("grad_all_reduce", "fwd", "model")] = 1
    want[("psum", "fwd", "model")] = 2
    assert got == want


def test_half_kv_heads_gather_whole(runs):
    """On (1, 4) the two kv heads are whole on every rank (the drop rule):
    wk's and wv's column shards, half a head each, are gathered before the
    split into heads, two more sequence-free gathers a layer."""
    layers = reduced(get_config("qwen2-0.5b")).n_layers
    got = runs["cases"]["qwen2-tp4-half-kv-head"]["counts"]
    assert got[("act_gather", "fwd", "model")] == 4 * layers
    assert got[("act_scatter", "fwd", "model")] == 2 * layers + 1


def test_phi_drops_tokens_at_the_default_capacity(monkeypatch):
    """The phi3.5 case runs at the default capacity factor, where its one
    group of 512 tokens a layer overflows: each MoE layer drops some
    (token, choice) pairs in the forward over the case's batch."""
    _, tree, tokens, _ = _setup("phi3.5-moe-42b-a6.6b", {}, 4, 128)
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
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
    assert all(g == 1 and dropped > 0 for g, _, dropped in seen), seen


@pytest.mark.parametrize("backend", ["cuda", "q16"])
def test_a_row_parallel_gemm_needs_the_torch_template(backend):
    """A GEMM whose contraction holds a shard on both operands (a
    row-parallel weight): on the ``cuda`` template each rank's K-shard runs
    the float GEMM (here its plain version) into an f32 partial sum, marked
    so, with no epilogue, and the two ranks' partials sum to the whole
    product; the fixed-point template runs column-parallel shards only and
    raises before it plans a block for the local k."""
    gen = torch.Generator().manual_seed(11)
    x, w = torch.randn(4, 16, generator=gen), torch.randn(16, 6, generator=gen)
    tpl = default_template(backend, device="cpu")
    halves = []
    for lo in (0, 8):
        xs = sh.mark_shard(x[:, lo:lo + 8].contiguous(), ((-1, "model", 16),))
        ws = sh.mark_shard(w[lo:lo + 8].contiguous(), ((-2, "model", 16),))
        if backend == "q16":
            with pytest.raises(ValueError, match="row-parallel GEMM"):
                tpl.matmul(xs, ws)
            return
        part = tpl.matmul(xs, ws)
        assert sh.partial_axes(part) == ("model",) and part.dtype == torch.float32
        halves.append(part)
    torch.testing.assert_close(halves[0] + halves[1], x @ w, rtol=1e-5, atol=1e-5)


def test_restart_on_a_tp_mesh_resumes_bit_for_bit(runs):
    """The driver called on each of 4 ranks with ``--model 2`` (a (2, 2)
    mesh): a failure at step 3 resumes from the step-2 checkpoint and
    replays the fault-free run's losses bit for bit."""
    (free_stats, free), (stats, faulty) = (runs["out4"]["restart"][k]
                                           for k in ("free", "faulty"))
    assert free_stats["failures"] == 0 and len(free) == 4
    assert stats["failures"] == 1 and stats["restarts"] == [2]
    assert faulty == free[:3] + free[2:]
    assert all(np.isfinite(free))


def test_tp_checkpoint_restores_onto_four_data_ranks(runs):
    """The state after a (2, 2) step, saved gathered by rank 0, restores
    onto a (4, 1) FSDP mesh (each rank a quarter of d_model, the whole
    vocab), equal to the saved state leaf for leaf."""
    saved = runs["cases"]["qwen2-fsdp-tp"]["saved"]
    r4 = runs["out4"]["restore"]
    cfg = reduced(get_config("qwen2-0.5b"))
    assert r4["embed_local"] == (cfg.vocab, cfg.d_model // 4)
    _equal_trees(r4["state"], saved)


def test_tp_checkpoint_restores_onto_one_device(runs):
    """The same checkpoint restored onto one device equals the (2, 2)
    state gathered, leaf for leaf."""
    saved = runs["cases"]["qwen2-fsdp-tp"]["saved"]
    cfg = reduced(get_config("qwen2-0.5b"))
    target = T.init_params(torch.Generator().manual_seed(7), cfg)
    one = M.restore(str(runs["tmp"] / "saved"), 1, {"params": target,
                                                    "opt": adamw_init(target)})
    one = {"params": one["params"], "opt": one["opt"]._asdict()}
    _equal_trees(jax.tree.map(lambda t: t.numpy(), one), saved)
