"""Serving under ``SERVE_RULES`` on the card: two ranks on one NVIDIA card
over ``gloo`` (``launch/mesh.py:spawn_ranks``), mesh (1, 2), each running
the port's kernels (rank bodies in ``torch_serve_rules_cases.py``).

* The row-parallel float GEMM on the ``cuda`` template, in bf16 at route S
  (m = 4) and route W (m = 256): each rank's K-half through the kernel's
  partial launch (f32 out, no epilogue, counted as
  ``matmul_fp.<route>.partial``) against its plain version, the two
  partials' f32 sum against ``torch.matmul`` of the whole product, and the
  GEMM with bias and ReLU, which apply once after the sum, against the
  whole product's epilogue.
* The (1, 2) cases of the CPU test (reduced qwen2, its wrapping 16-slot
  ring, f32) meshed against the single-device steps on the card, weights
  drawn on the card from a seed: logits within :data:`TOL`.

Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_serve_rules_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch.mesh import spawn_ranks

import torch_serve_rules_cases as cases

pytestmark = pytest.mark.gpu

RANKS_TIMEOUT_S = 300
#: the meshed f32 logits against one device's on the card (the partial sums
#: and the softmax combine add in another order)
TOL = 1e-4
#: bf16 outputs against the f32 product: two bf16 steps of the largest value
BF16_REL = 2 ** -7


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    _build.build_all()  # once, before the ranks load the libraries
    return spawn_ranks(functools.partial(cases.gpu_case, {}), 2, device="cuda",
                       backend="gloo", timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("i", range(len(cases.GPU_GEMMS)),
                         ids=lambda i: "S" if cases.GPU_GEMMS[i][0] <= 16 else "W")
def test_row_parallel_gemm_on_the_card(ranks, i):
    route = "splitk" if cases.GPU_GEMMS[i][0] <= 16 else "wgmma"
    for rank, rec in enumerate(ranks):
        g = rec["gemms"][i]
        assert g["partial_dtype"] == "torch.float32" and g["partial_axes"] == ["model"]
        np.testing.assert_allclose(g["partial"], g["partial_plain"], rtol=1e-5, atol=1e-4)
        # reduced, each sum rounds once to bf16, the operands' dtype
        for got, want in ((g["summed"], g["want_sum"]), (g["whole"], g["want"])):
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= BF16_REL * scale, rank
        # the partial alone and the GEMM with its epilogue: two partial launches
        assert g["launches"][f"matmul_fp.{route}.partial"] == 2, g["launches"]
        assert g["launches"][f"matmul_fp.{route}"] == 2


@pytest.mark.parametrize("case", [c for c in cases.CASES if c[2] == (1, 2)],
                         ids=lambda c: c[0])
def test_serve_rules_steps_on_the_card(ranks, case):
    key = case[0]
    for rank, rec in enumerate(ranks):
        got, want = rec[key]["meshed"], rec[key]["single"]
        for part in ("steps", "chunk"):
            if part in want:
                assert np.isfinite(got[part]).all()
                err = float(np.abs(got[part] - want[part]).max())
                assert err <= TOL, (key, part, rank, err)
        assert got["ring"]["k_shape"][-2] == case[3] // 2
        assert got["launches"].get("matmul_fp.splitk.partial", 0) > 0, got["launches"]
