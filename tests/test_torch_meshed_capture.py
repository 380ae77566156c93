"""The meshed decode step's body on ``torch.distributed``: the port's meshed
``decode_next`` against the reference's single-device decode.

The meshed step takes the whole batch's inputs and does everything inside
its body (this rank's rows, ``use_mesh`` / ``batch_split``, the step, the
gathers of tokens and logits), so that over NCCL one CUDA graph holds it
all.  Two ``gloo`` ranks on the CPU run that body eagerly
(``launch/mesh.py:spawn_ranks``, spawned once for the module; the rank
bodies are in ``torch_capture_cases.py``), on the reference's reduced
configs and weights carried across as numpy arrays:

* reduced qwen2 in float through ``compiled_steps(mesh=)`` on (1, 2), and
  on the grid (per-op Q2.14) through the meshed scheduler on (1, 2);
* reduced granite-moe on (2, 1): two rows a rank, so each decode step's
  routing group spans both ranks (``moe._whole_groups``);
* reduced mamba2 (a recurrent family) on (1, 2).

Gates: tokens equal to the reference's single-device decode (greedy), float
logits within its decode tolerance (``torch_family_cases.DECODE_TOL``);
the port's meshed step against its single-device step: grid logits bit
for bit, float within :data:`MESH_TOL` (the host BLAS blocks by the
shard's shape; the card holds them bit for bit,
``tests/test_torch_sharded_decode_nccl_gpu.py``).  Under gloo the meshed
step stays eager: ``MESHED_EAGER_COUNTS`` ticks once a step,
``CAPTURE_COUNTS`` not at all, it holds no graph and ``release`` drops
nothing; ``capture=False`` without a mesh is refused.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro.models import transformer as JT
from repro_torch.launch.mesh import spawn_ranks

import torch_capture_cases as cases
from torch_family_cases import DECODE_TOL, _make, _np_tree

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 240
#: the port's float meshed logits against its single-device logits on the
#: CPU (``test_torch_sharded_decode_families.py``'s tolerance)
MESH_TOL = 1e-5
GEN = 4
B, S = 4, 16
LENS = [5, 9, 3, 15, 8, 16, 2]
NAMES = sorted({name for _, name, _ in cases.STEPPED})


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, n).astype(np.int64) for n in LENS]


@pytest.fixture(scope="module")
def ranks():
    setups = {name: _make(name) for name in NAMES}
    tokens = np.random.default_rng(3).integers(0, 128, (B, S)).astype(np.int64)
    cal = np.random.default_rng(9).integers(0, 128, (2, 16)).astype(np.int64)
    payload = {"params": {name: _np_tree(setups[name][2]) for name in NAMES},
               "tokens": tokens, "cal": cal, "gen": GEN, "prompts": _prompts()}
    out = spawn_ranks(functools.partial(cases.cpu_case, payload), 2, device="cpu",
                      timeout=RANKS_TIMEOUT_S)
    return setups, payload, out


def _reference_steps(cfg_j, params_j, tokens):
    fns = jsched.compiled_steps(j_template("xla"), cfg_j, tokens.shape[1] + GEN)
    logits, cache = fns.prefill(params_j, jnp.asarray(tokens, jnp.int32), None, None)
    out, toks = [np.asarray(logits)], [np.argmax(np.asarray(logits), -1)]
    for i in range(GEN):
        logits, cache = fns.decode(params_j, jnp.asarray(toks[-1][:, None], jnp.int32),
                                   tokens.shape[1] + i, cache)
        out.append(np.asarray(logits))
        toks.append(np.argmax(out[-1], -1))
    return np.stack(out), np.stack(toks, 1)


@pytest.mark.parametrize("case", cases.STEPPED, ids=lambda c: c[0])
def test_meshed_step_equals_the_reference_decode(ranks, case):
    """``compiled_steps(mesh=)``'s decode_next on every rank: the reference's
    single-device tokens and logits, the port's single-device step within
    :data:`MESH_TOL`; eager under gloo, counted, holding nothing."""
    setups, payload, out = ranks
    key, name, shape = case
    cfg_j, _, params_j, _, _, _ = setups[name]
    want_logits, want_tokens = _reference_steps(cfg_j, params_j, payload["tokens"])
    for rank, rec in enumerate(out):
        single, meshed = rec["stepped"][key]["single"], rec["stepped"][key]["meshed"]
        np.testing.assert_array_equal(meshed["tokens"], want_tokens, err_msg=str(rank))
        np.testing.assert_allclose(meshed["logits"], want_logits, atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        np.testing.assert_array_equal(meshed["tokens"], single["tokens"])
        np.testing.assert_allclose(meshed["logits"], single["logits"], rtol=0, atol=MESH_TOL)
        # gloo: every meshed step eager and counted, nothing captured or held
        assert not meshed["graphed"]
        assert (meshed["eager"], meshed["captures"]) == (GEN, 0), meshed
        assert (meshed["held"], meshed["released"]) == (0, 0)
        # the single-device step on the CPU keeps a capture's bookkeeping,
        # and release drops it
        assert (single["eager"], single["captures"]) == (0, 1), single
        assert (single["held"], single["released"], single["held_after"]) == (1, 1, 0)
        if shape[0] > 1:
            # each step's tokens and logits gathered over "data" (two rows a rank)
            assert meshed["collectives"]["all_gather"]["data"] >= 2 * GEN
        if key == "moe":
            assert meshed["whole_group_calls"] > 0  # a routing group spans the ranks


def _reference_grid(cfg_j, params_j, cal):
    tpl = j_template("q16")
    policy = JT.calibrate_policy(tpl, cfg_j, params_j, jnp.asarray(cal, jnp.int32))
    s = jsched.ServeScheduler(cfg_j, params_j, tpl=tpl, clock=jsched.VirtualClock(),
                              policy=policy,
                              sched=jsched.SchedulerConfig(ladder=cases.LADDER,
                                                           slots=cases.SLOTS,
                                                           max_new_limit=8))
    s.warmup()
    trace = [jsched.Request(prompt=tuple(int(t) for t in p), max_new=4, arrival=0.0,
                            rid=3000 + i) for i, p in enumerate(_prompts())]
    jsched.replay_trace(s, trace)
    return {r.rid: list(r.generated) for r in s.results.values()}, policy.fmt.name


def test_meshed_grid_scheduler_equals_the_reference(ranks):
    """Reduced qwen2 on the grid through the meshed scheduler on (1, 2): the
    reference's single-device streams, the port's single-device logits bit
    for bit; every meshed decode step eager and counted so."""
    setups, payload, out = ranks
    cfg_j, _, params_j, _, _, _ = setups["qwen2-0.5b"]
    want, fmt = _reference_grid(cfg_j, params_j, payload["cal"])
    assert len(want) == len(LENS) and sum(len(v) for v in want.values()) > len(LENS)
    for rank, rec in enumerate(out):
        grid = rec["grid"]
        assert grid["policy"] == fmt
        assert grid["meshed"]["tokens"] == want, rank
        assert grid["single"]["tokens"] == want, rank
        assert grid["meshed"]["logits"].keys() == grid["single"]["logits"].keys()
        for rid, row in grid["single"]["logits"].items():
            np.testing.assert_array_equal(grid["meshed"]["logits"][rid], row)
        m = grid["meshed"]
        assert m["meshed_eager_decode_steps"] == m["decode_steps"] == m["eager"] > 0
        assert (m["meshed_replayed_decode_steps"], m["captures"]) == (0, 0)
        assert (m["held"], m["released"]) == (0, 0)


def test_eager_mode_needs_a_mesh(ranks):
    """``capture=False`` sets a meshed step's mode: without a mesh it
    raises."""
    _, _, out = ranks
    for rec in out:
        assert rec["refused"]
