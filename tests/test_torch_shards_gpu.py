"""Sharding on the card: two ranks on one NVIDIA card over ``gloo``
(``launch/mesh.py:spawn_ranks``), each running the port's kernels.

* VGG16 at 224², full width, grid-resident Q2.14: the logits with two H
  slabs (one a rank, the halo rows staged through the host) equal the
  unsharded forward on the card bit for bit;
* tensor-parallel decode of a reduced qwen2-0.5b over a 2-way "model" axis
  (column shards of the weights, decode eager): token streams equal the
  single-device scheduler's on the card, float and q16;
* the float GEMM's local plan of a column shard (route split-k at n / 2,
  the logical plan's k slices) gives the unsharded call's columns bit for
  bit; the plan made at the local n cuts k otherwise.

Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_shards_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import dse
from repro_torch.core.tiling import H100
from repro_torch.kernels import _build
from repro_torch.kernels import matmul_fp
from repro_torch.launch.mesh import spawn_ranks

import torch_shard_cases

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 300

pytestmark = pytest.mark.gpu

BATCH = 2


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 64, n).astype(np.int64) for n in (5, 9, 3, 15, 8, 16, 2)]


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()  # once, before the ranks load the libraries
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ranks(dev):
    payload = {"batch": BATCH, "prompts": _prompts()}
    return spawn_ranks(functools.partial(torch_shard_cases.gpu_case, payload), 2,
                       device="cuda", backend="gloo", timeout=RANKS_TIMEOUT_S)


def test_spatial_vgg16_grid_bitwise(dev, ranks):
    want = torch_shard_cases.gpu_vgg_grid(dev, None, BATCH).cpu().numpy()
    assert np.isfinite(want).all()
    for rec in ranks:
        np.testing.assert_array_equal(rec["vgg"], want)


def test_tensor_parallel_decode_tokens_equal(dev, ranks):
    want = torch_shard_cases.gpu_streams(dev, None, _prompts())
    for rec in ranks:
        for mode in ("float", "q16"):
            assert rec[mode] == want[mode], mode
            assert rec[mode + "_eager_steps"] > 0


def test_local_splitk_plan_keeps_the_columns_bitwise(dev):
    m, k, n = 4, 896, 151936  # qwen2-0.5b's head at decode
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((m, k), device=dev, generator=gen)
    w = torch.randn((k, n), device=dev, generator=gen) * k ** -0.5
    whole = dse.default_fp_block_for(m, n, k, H100)
    local = dse.default_fp_block_for(m, n // 2, k, H100, logical=(m, n, k))
    naive = dse.default_fp_block_for(m, n // 2, k, H100)
    assert (local.bk, local.splits) == (whole.bk, whole.splits) != (naive.bk, naive.splits)
    full = matmul_fp.matmul_fp_cuda(x, w, block=whole)
    for half in (0, 1):
        cols = w[:, half * n // 2:(half + 1) * n // 2].contiguous()
        got = matmul_fp.matmul_fp_cuda(x, cols, block=local)
        assert torch.equal(got, full[:, half * n // 2:(half + 1) * n // 2])
