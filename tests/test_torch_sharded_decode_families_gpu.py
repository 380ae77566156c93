"""Meshed serving of the families beyond the dense stack on the card: two
ranks on one NVIDIA card over ``gloo`` (``launch/mesh.py:spawn_ranks``),
each running the port's kernels, on a (2, 1) mesh (the four slots split
over "data": every decode tick's MoE routing group spans both ranks) and
a (1, 2) mesh (granite's expert_mlp columns over "model").

* reduced granite-moe through the meshed ``ServeScheduler``: token streams
  and each picked token's logits equal the single-device scheduler's on
  the card bit for bit;
* reduced mamba2, recurrentgemma, whisper and llama-vision through
  ``compiled_steps(mesh=)``: the prefill and eight decode steps' logits and
  tokens equal the single-device steps' bit for bit, each rank holding its
  rows of the cache.

The rank bodies are in ``torch_family_shard_cases.py``.  Every test needs
an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_sharded_decode_families_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch.mesh import spawn_ranks

import torch_family_shard_cases as cases

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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    _build.build_all()  # once, before the ranks load the libraries
    payload = {"prompts": _prompts(), "gen": 8}
    return spawn_ranks(functools.partial(cases.gpu_case, payload), 2, device="cuda",
                       backend="gloo", timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("shape", [m[0] for m in cases.GPU_MESHES], ids=str)
def test_meshed_moe_scheduler_bitwise(ranks, shape):
    for rec in ranks:
        got = rec[shape]["sched"]
        assert got["meshed"]["tokens"] == got["single"]["tokens"]
        assert sum(len(v) for v in got["single"]["tokens"].values()) > 7
        for rid, want in got["single"]["logits"].items():
            np.testing.assert_array_equal(got["meshed"]["logits"][rid], want)
        assert got["meshed"]["meshed_eager_steps"] == got["meshed"]["decode_steps"] > 0


@pytest.mark.parametrize("shape", [m[0] for m in cases.GPU_MESHES], ids=str)
@pytest.mark.parametrize("name", cases.GPU_STEPS)
def test_meshed_compiled_steps_bitwise(ranks, shape, name):
    for rec in ranks:
        got = rec[shape][name]
        assert np.isfinite(got["single"]["logits"]).all()
        np.testing.assert_array_equal(got["meshed"]["logits"], got["single"]["logits"])
        np.testing.assert_array_equal(got["meshed"]["tokens"], got["single"]["tokens"])
        rows = 4 // shape[0]
        assert all(v == [rows] for v in got["meshed"]["cache_rows"].values())
