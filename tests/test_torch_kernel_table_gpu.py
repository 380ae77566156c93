"""``repro_torch.benchmarks.kernel_table`` on the card: each H100 row of
every case launches its planned route through the engine (counted in
``_build.launches``) and is timed beside its bound and, in bf16,
``torch.matmul``; the correctness pass launches the kernels, the integer
ones exact.  Every test needs an NVIDIA card and skips without one; run
them there with ``python -m pytest --noconftest -m gpu``.
"""
import pytest
import torch

from repro_torch.benchmarks import kernel_table
from repro_torch.core.tiling import H100
from repro_torch.kernels import _build

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def rows(dev):
    return kernel_table.structural_rows(H100, device=dev)


@pytest.mark.parametrize("label", list(kernel_table.CASES))
def test_h100_rows_launch_their_planned_route(rows, label):
    got = [r for r in rows if r["gemm"] == label]
    assert [r["numerics"] for r in got] == ["bf16", "int16"]
    for r in got:
        kernel = "matmul_fp" if r["numerics"] == "bf16" else "matmul_q16"
        assert r["launches"][f"{kernel}.{r['route']}"] == 1
        if r["route"] == "wgmma" and kernel == "matmul_q16":
            assert r["launches"]["matmul_q16.prep"] == 1
        assert r["ms"] > 0 and r["bound_ms"] > 0
        assert (r["library_ms"] is None) == (kernel == "matmul_q16")


def test_correctness_pass_launches_the_kernels(dev):
    before = dict(_build.launches)
    corr = kernel_table.correctness_pass(dev)
    torch.cuda.synchronize()
    ran = {k for k, c in _build.launches.items() if c != before.get(k, 0)}
    assert {"matmul_fp", "matmul_q16", "conv2d", "conv2d_q16", "flash_attention"} <= ran
    assert corr["matmul_q16_raw"] == corr["conv2d_q16_raw"] == 0
    for name, tol in kernel_table.CORRECTNESS_TOL.items():
        assert corr[name] <= tol, (name, corr[name])


def test_conv_routes_row_runs_both_routes_on_one_image(dev):
    """One image's im2col columns are a transposed view: the float GEMM must
    get them dense (the row's im2col route once raised here)."""
    before = dict(_build.launches)
    row = kernel_table.im2col_vs_direct_row(device=dev)
    ran = {k: c - before.get(k, 0) for k, c in _build.launches.items() if c != before.get(k, 0)}
    assert ran["matmul_fp.tile"] > 0 and ran["conv2d.tc"] > 0
    assert row["im2col_ms"] > 0 and row["direct_ms"] > 0
