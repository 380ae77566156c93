"""The meshed decode step captured over NCCL: two ranks, a card each
(``launch/mesh.py:spawn_ranks(device="cuda")`` picks NCCL when every rank
has a card of its own).

Each rank runs each case eager (``capture=False``), then captured (one
CUDA graph per signature and owner, the collectives inside, replayed every
step), and the single-device run on its card:

* reduced qwen2 through the meshed ``ServeScheduler`` on (1, 2);
* reduced granite-moe through ``compiled_steps(mesh=)`` on (2, 1): two
  rows a rank, so each step's routing group is gathered across the ranks
  inside the graph;
* reduced mamba2 (a recurrent family) through ``compiled_steps(mesh=)`` on
  (1, 2).

Gates: captured logits and tokens equal to the eager meshed step's bit for
bit, and to the single device's; one capture a (signature, owner), every
step after it a replay, the replay's collectives those of an eager step;
``release`` drops the graphs.  The rank bodies are in
``torch_capture_cases.py``.  Needs two NVIDIA cards and skips otherwise;
run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_sharded_decode_nccl_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch.mesh import spawn_ranks

import torch_capture_cases as cases

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 600

pytestmark = pytest.mark.gpu


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, n).astype(np.int64) for n in (5, 9, 3, 15, 8, 16, 2)]


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' records, made when a test runs (never at import or
    collection)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL, a card a rank)")
    _build.build_all()  # once, before the ranks load the libraries
    return spawn_ranks(functools.partial(cases.gpu_case, {"prompts": _prompts(), "gen": 8}),
                       2, device="cuda", backend="nccl", timeout=RANKS_TIMEOUT_S)


def test_ranks_run_nccl(ranks):
    for rec in ranks:
        assert rec["backend"] == "nccl"
        assert tuple(rec["nccl"]) >= (2, 9, 6)  # NCCL's graph capture


@pytest.mark.parametrize("case", cases.GPU_CASES, ids=lambda c: c[0])
def test_captured_equals_eager_bitwise(ranks, case):
    key, _, _, path = case
    for rec in ranks:
        runs = rec[key]
        eager, captured, single = runs["eager"], runs["captured"], runs["single"]
        if path == "scheduler":
            assert captured["tokens"] == eager["tokens"] == single["tokens"]
            assert sum(len(v) for v in single["tokens"].values()) > 7
            for rid, want in eager["logits"].items():
                np.testing.assert_array_equal(captured["logits"][rid], want)
                np.testing.assert_array_equal(single["logits"][rid], want)
            steps = captured["decode_steps"]
            assert eager["meshed_eager_decode_steps"] == eager["decode_steps"] > 0
            assert captured["meshed_replayed_decode_steps"] == steps > 0
            assert (captured["meshed_eager_decode_steps"], captured["eager"]) == (0, 0)
            # warm-up captured the scheduler's one decode graph: the trace
            # only replays it
            assert captured["captures"] == 0 and captured["held"] == 1
            assert captured["released"] == 1
        else:
            assert np.isfinite(eager["logits"]).all()
            for got in (captured, single):
                np.testing.assert_array_equal(got["logits"], eager["logits"])
                np.testing.assert_array_equal(got["tokens"], eager["tokens"])
            assert captured["graphed"] and not eager["graphed"]
            assert (eager["eager"], eager["captures"]) == (8, 0)
            assert (captured["eager"], captured["captures"]) == (0, 1)
            assert (captured["held"], captured["released"], captured["held_after"]) == (1, 1, 0)
            # a replay gathers what an eager step gathers (the first
            # captured step adds its warm-up's); the data split gathers
            # every step's tokens, logits and routing groups
            assert set(captured["collectives"]) == set(eager["collectives"])
            assert bool(eager["collectives"]) == (case[2][0] > 1)
            for kind, by_axis in eager["collectives"].items():
                for axis, n in by_axis.items():
                    assert captured["collectives"][kind][axis] == n + n // 8, (kind, axis)
