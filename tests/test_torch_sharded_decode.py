"""Tensor-parallel decode on ``torch.distributed``: the port's meshed
scheduler against the reference's single-device scheduler.

The reference's ``tests/test_sharded_decode.py`` on the port: a reduced
qwen2-0.5b (the reference's weights, carried across as numpy arrays), a
(2, 2) ("data", "model") mesh of four ``gloo`` ranks on the CPU
(``launch/mesh.py:spawn_ranks``), ``DECODE_RULES`` (column-parallel
weights, activations gathered at the seams, the per-slot KV cache sharded
over slots on "data"), the ladder (8, 16), four slots, seven requests.
Every rank's token streams must equal the reference scheduler's on one
device, in float and in q16; a warmed scheduler never searches during a
replay, and after a plan-store round trip a warm restart makes no search
in warm-up either (the shard-local plans come from the store).  The ranks
are spawned once for the module; their bodies are in
``torch_shard_cases.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro.models import transformer as JT
from repro_torch.launch.mesh import spawn_ranks

import torch_shard_cases

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 300

LADDER = (8, 16)
LENS = [5, 9, 3, 15, 8, 16, 2]


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 64, n).astype(np.int64) for n in LENS]


def _cal(vocab):
    return np.random.default_rng(9).integers(0, vocab, (2, 16)).astype(np.int64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    payload = {"params": jax.tree_util.tree_map(np.asarray, params_j),
               "cal": _cal(cfg_j.vocab), "ladder": LADDER, "prompts": _prompts(),
               "store_dir": str(tmp_path_factory.mktemp("stores"))}
    ranks = spawn_ranks(functools.partial(torch_shard_cases.decode_case, payload), 4,
                        device="cpu", timeout=RANKS_TIMEOUT_S)
    return cfg_j, params_j, ranks


def _reference(cfg_j, params_j, mode):
    tpl = j_template("pallas" if mode == "float" else "q16")
    policy = None
    if mode == "q16":
        policy = JT.calibrate_policy(tpl, cfg_j, params_j,
                                     jnp.asarray(_cal(cfg_j.vocab), jnp.int32))
    s = jsched.ServeScheduler(cfg_j, params_j, tpl=tpl, clock=jsched.VirtualClock(),
                              policy=policy,
                              sched=jsched.SchedulerConfig(ladder=LADDER, slots=4,
                                                           max_new_limit=8))
    s.warmup()
    trace = [jsched.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                            rid=3000 + i) for i, p in enumerate(_prompts())]
    jsched.replay_trace(s, trace)
    return ({r.rid: list(r.generated) for r in s.results.values()},
            None if policy is None else policy.fmt.name)


@pytest.mark.parametrize("mode", ["float", "q16"])
def test_sharded_decode_equals_the_reference_and_warm_store(setup, mode):
    cfg_j, params_j, ranks = setup
    want, fmt = _reference(cfg_j, params_j, mode)
    assert len(want) == 7 and sum(len(v) for v in want.values()) > 0
    for rank, rec in enumerate(ranks):
        rec = rec[mode]
        assert rec["policy"] == fmt
        # the differential contract: byte-identical token streams on every rank
        assert rec["single"] == want, rank
        assert rec["sharded"] == want, rank
        assert rec["warm"] == want, rank
        # a warmed scheduler never searches during replay, sharded or not
        assert rec["single_replay_misses"] == 0, rec
        assert rec["shard_replay_misses"] == 0, rec
        # the meshed warm-up plans shard-local shapes the single-device run
        # never met; a store round trip makes every one of them a hit
        assert rec["cold_mesh_warmup_misses"] > 0, rec
        assert rec["warm_mesh_warmup_misses"] == 0, rec
        assert rec["warm_warmup_shard_misses"] == 0, rec
        assert rec["warm_replay_misses"] == 0, rec
        assert rec["store_entries"] > 0


def test_meshed_ranks_hold_shards_and_decode_eagerly(setup):
    _, _, ranks = setup
    for rec in ranks:
        for mode in ("float", "q16"):
            r = rec[mode]
            # column shards: wq / wk / wv (+ biases), gate / up (and the
            # grid's untied head) per layer
            assert r["sharded_leaves"] > 0
            assert r["cache_rows"] == 2  # 4 slots over the 2-way data axis
            # no CUDA graph holds a gloo collective: every meshed step eager
            assert r["meshed_eager_steps"] == r["decode_steps"] > 0
            assert r["meshed_captures"] == 0
