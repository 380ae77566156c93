"""Meshed serving of the families beyond the dense stack, on
``torch.distributed``: the port's meshed runs against the reference's
single-device runs.

Four ``gloo`` ranks on the CPU form a (2, 2) ("data", "model") mesh
(``launch/mesh.py:spawn_ranks``), spawned once for the module; their bodies
are in ``torch_family_shard_cases.py``.  Weights are the reference's,
reduced configs with live norm scales and cross gates, carried across as
numpy arrays (``torch_family_cases.py``).  The reference's own
multi-device tests fail on this tree, so each meshed run is held against
the reference's single-device run on the same inputs:

* granite-moe and phi3.5-moe through the meshed ``ServeScheduler``, float
  (the ``cuda`` template) and per-op fixed point (``q16``), under
  ``DECODE_RULES`` and under ``expert_mlp`` over "model": four slots split
  two a rank over "data", so every decode tick's routing group spans both
  data ranks (the group is the logical batch's four tokens), and the
  config's capacity factor drops tokens;
* mamba2, recurrentgemma, whisper and llama-vision through
  ``compiled_steps(mesh=)``: the prefill, then eight greedy decode steps
  on this rank's rows of the cache (``scheduler.shard_cache``);
* reduced qwen2 (tied embeddings) through the scheduler under ``embed``
  over "model";
* ``init_params(shardings=serve_shardings(...))``: each rank's draw equals
  the unsharded draw cut, leaf for leaf;
* ``serve --arch granite-moe-3b-a800m --scheduler --shards 2`` equals the
  unsharded CLI's streams.

Gates: token streams equal to the reference's; logits within the
reference's decode tolerance (``torch_family_cases.DECODE_TOL``); the
port's meshed runs equal its single-device runs: streams byte for byte,
fixed-point logits bit for bit, float logits within :data:`MESH_TOL` (the
host BLAS's blocking follows the shard's shape; the card test holds them
bit for bit).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro_torch.launch.mesh import spawn_ranks

import torch_family_shard_cases as cases
from torch_family_cases import DECODE_TOL, _make, _np_tree

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 300
LENS = [5, 9, 3, 15, 8, 16, 2]
#: (config, numerics, rule overrides, config fields) of the scheduler runs
MOE = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
EXPERT_MLP = (("expert_mlp", "model"),)
SCHED = [(name, mode, rules, ()) for name in MOE for mode in ("float", "q16")
         for rules in ((), EXPERT_MLP)] + [("qwen2-0.5b", "float", (("embed", "model"),), ())]
STEPS = ("mamba2-1.3b", "recurrentgemma-9b", "whisper-medium", "llama-3.2-vision-90b")
GEN = 8
B = 4
#: the port's float meshed logits against its single-device logits on the
#: CPU: the plain GEMM (``torch.matmul``, the host BLAS) picks its blocking,
#: and so its summation order, by the operands' shape, and a rank's GEMMs
#: are a row and column shard of the single device's.  The card's kernels
#: plan a shard's GEMM at its logical shape and are held bit for bit there
#: (``tests/test_torch_sharded_decode_families_gpu.py``); the per-op fixed
#: point sums integers and is held bit for bit here.
MESH_TOL = 1e-5


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, n).astype(np.int64) for n in LENS]


def _setup(name):
    cfg_j, _, params_j, _, _, _ = _make(name)
    return cfg_j, params_j


def _steps_inputs(cfg_j):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_j.vocab, (B, 16)).astype(np.int64)
    ctx = None
    if cfg_j.family in ("encdec", "vlm"):
        n = cfg_j.n_frames if cfg_j.family == "encdec" else cfg_j.n_image_tokens
        ctx = (0.1 * rng.standard_normal((B, n, cfg_j.d_model))).astype(np.float32)
    return tokens, ctx


@pytest.fixture(scope="module")
def ranks():
    setups = {name: _setup(name) for name in {k[0] for k in SCHED} | set(STEPS)}
    payload = {"prompts": _prompts(), "gen": GEN,
               "sched": {key: {"params": _np_tree(setups[key[0]][1])} for key in SCHED},
               "steps": {}}
    for name in STEPS:
        tokens, ctx = _steps_inputs(setups[name][0])
        payload["steps"][name] = {"params": _np_tree(setups[name][1]), "tokens": tokens,
                                  "ctx": ctx}
    out = spawn_ranks(functools.partial(cases.family_case, payload), 4, device="cpu",
                      timeout=RANKS_TIMEOUT_S)
    return setups, payload, out


def _reference_sched(cfg_j, params_j, mode):
    s = jsched.ServeScheduler(cfg_j, params_j, tpl=j_template("xla" if mode == "float"
                                                              else "q16"),
                              clock=jsched.VirtualClock(),
                              sched=jsched.SchedulerConfig(ladder=cases.LADDER,
                                                           slots=cases.SLOTS,
                                                           max_new_limit=8))
    trace = [jsched.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                            rid=3000 + i) for i, p in enumerate(_prompts())]
    jsched.replay_trace(s, trace)
    return {r.rid: list(r.generated) for r in s.results.values()}


def _reference_steps(cfg_j, params_j, tokens, ctx):
    fns = jsched.compiled_steps(j_template("xla"), cfg_j, tokens.shape[1] + GEN)
    logits, cache = fns.prefill(params_j, jnp.asarray(tokens, jnp.int32),
                                None if ctx is None else jnp.asarray(ctx), None)
    out, toks = [np.asarray(logits)], [np.argmax(np.asarray(logits), -1)]
    for i in range(GEN):
        logits, cache = fns.decode(params_j, jnp.asarray(toks[-1][:, None], jnp.int32),
                                   tokens.shape[1] + i, cache)
        out.append(np.asarray(logits))
        toks.append(np.argmax(out[-1], -1))
    return np.stack(out), np.stack(toks, 1)


def _same_run(a: dict, b: dict, exact: bool):
    """Two runs of the port: the same streams, and each picked token's
    logits row bit for bit (``exact``) or within :data:`MESH_TOL`."""
    assert a["tokens"] == b["tokens"]
    assert a["logits"].keys() == b["logits"].keys()
    for rid in a["logits"]:
        if exact:
            np.testing.assert_array_equal(a["logits"][rid], b["logits"][rid])
        else:
            np.testing.assert_allclose(a["logits"][rid], b["logits"][rid], rtol=0,
                                       atol=MESH_TOL)


@pytest.mark.parametrize("key", SCHED, ids=lambda k: "-".join(
    [k[0], k[1]] + [f"{n}={a}" for n, a in k[2]]))
def test_meshed_scheduler_equals_reference(ranks, key):
    """The meshed scheduler's streams on every rank: the reference's
    single-device streams, and the port's single-device run bit for bit
    (tokens and each picked token's logits row)."""
    setups, _, out = ranks
    cfg_j, params_j = setups[key[0]]
    want = _reference_sched(cfg_j, params_j, key[1])
    assert len(want) == len(LENS) and sum(len(v) for v in want.values()) > len(LENS)
    for rank, rec in enumerate(out):
        rec = rec["sched"][key]
        assert rec["single"]["tokens"] == want, rank
        assert rec["meshed"]["tokens"] == want, rank
        _same_run(rec["single"], rec["meshed"], exact=key[1] == "q16")
        # column shards held, and every meshed decode step ran eagerly
        assert rec["meshed"]["sharded_leaves"] > 0
        assert rec["meshed"]["meshed_eager_steps"] == rec["meshed"]["decode_steps"] > 0


@pytest.mark.parametrize("name", STEPS)
def test_meshed_compiled_steps_equal_reference(ranks, name):
    """``compiled_steps(mesh=)`` on every rank: the prefill and eight decode
    steps' logits within the reference's decode tolerance of its
    single-device steps, the same greedy tokens, the port's single-device
    steps bit for bit; each rank's cache holds its two of the four rows
    (recurrent states, conv histories and cross k / v included)."""
    setups, payload, out = ranks
    cfg_j, params_j = setups[name]
    case = payload["steps"][name]
    want_logits, want_tokens = _reference_steps(cfg_j, params_j, case["tokens"], case["ctx"])
    for rank, rec in enumerate(out):
        rec = rec["steps"][name]
        np.testing.assert_allclose(rec["meshed"]["logits"], rec["single"]["logits"],
                                   rtol=0, atol=MESH_TOL)
        np.testing.assert_array_equal(rec["meshed"]["tokens"], rec["single"]["tokens"])
        np.testing.assert_array_equal(rec["meshed"]["tokens"], want_tokens)
        np.testing.assert_allclose(rec["meshed"]["logits"], want_logits, atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        assert all(v == [B] for v in rec["single"]["cache_rows"].values())
        assert all(v == [B // 2] for v in rec["meshed"]["cache_rows"].values()), rec
        kinds = set(rec["meshed"]["cache_rows"])
        want_kinds = {"mamba2-1.3b": {"state", "conv"},
                      "recurrentgemma-9b": {"h", "conv", "k", "v"},
                      "whisper-medium": {"k", "v"},
                      "llama-3.2-vision-90b": {"k", "v"}}[name]
        assert want_kinds <= kinds, kinds


@pytest.mark.parametrize("draw", cases.DRAWS, ids=lambda d: "-".join(
    [d[0]] + [f"{n}={a}" for n, a in d[1]]))
def test_sharded_draw_equals_the_unsharded_draw_cut(ranks, draw):
    """Each rank draws only its shards (one stacked layer at a time), and
    they equal the whole tree's draw cut by the same shardings."""
    _, _, out = ranks
    for rank, rec in enumerate(out):
        got = rec["draws"][draw]
        assert got["equal"], rank
        assert got["cut"] > 0


def test_serve_cli_shards_an_moe_arch():
    """``serve --scheduler --shards 2`` on an MoE arch: two ranks, the
    streams of the unsharded run."""
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--arch", "granite-moe-3b-a800m", "--scheduler", "--prompts",
            "4", "--prompt-len", "8", "--gen", "3"]
    want = serve.main(argv)
    assert [len(row) for row in want] == [3, 3, 3, 3]
    assert serve.main(argv + ["--shards", "2"]) == want
