"""The port's CUDA kernels on the card, each held against its plain version
on the same inputs: integers bit for bit, floats at 1e-4 (GEMM) and 2e-3
(conv), with TF32 off.  Every test here needs an NVIDIA Hopper card and
skips without one; run them there with ``python -m pytest -m gpu``.
"""
import pytest
import torch

from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import (
    conv2d_cuda,
    conv2d_plain,
    conv2d_q16_cuda,
    conv2d_q16_plain,
)
from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain
from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
from repro_torch.models import cnn

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


def _raws(shape, dtype, gen, dev):
    lim = 127 if dtype == torch.int8 else 32767
    return torch.randint(-lim - 1, lim + 1, shape, generator=gen).to(dtype).to(dev)


@pytest.mark.parametrize("tile", H100.gemm_tiles)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_fp_kernel_vs_plain(dev, tile, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 300, generator=g).to(dev, dtype)
    w = torch.randn(300, 130, generator=g).to(dev, dtype)
    b = torch.randn(130, generator=g).to(dev)
    before = _build.launches["matmul_fp"]
    got = matmul_fp_cuda(x, w, b, block=MatmulBlock(*tile), relu=True, qout=Q2_14)
    assert _build.launches["matmul_fp"] == before + 1
    want = matmul_fp_plain(x, w, b, relu=True, qout=Q2_14)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("tile", H100.gemm_tiles)
@pytest.mark.parametrize("xd,wd,wide", [(torch.int16, torch.int16, False),
                                        (torch.int8, torch.int16, False),
                                        (torch.int16, torch.int8, True)])
def test_matmul_q16_kernel_vs_plain(dev, tile, xd, wd, wide):
    g = torch.Generator().manual_seed(1)
    x, w = _raws((21, 3000), xd, g, dev), _raws((3000, 70), wd, g, dev)
    b = _raws((70,), torch.int16, g, dev)
    got = matmul_q16_cuda(x, w, b, fmt=Q2_14, block=MatmulBlock(*tile), relu=True,
                          shift=20, bias_shift=3, wide=wide)
    want = matmul_q16_plain(x, w, b, shift=20, bias_shift=3, raw_min=Q2_14.raw_min,
                            raw_max=Q2_14.raw_max, out_dtype=got.dtype, relu=True,
                            wide=wide)
    assert torch.equal(got, want)


CONVS = [  # n, h, w, cin, cout, k, stride, pad, tau, tile_rows, tile_cols, halo
    (2, 30, 30, 3, 64, 11, 4, 2, 64, 0, 0, "none"),
    (2, 28, 28, 1, 6, 5, 1, 0, 8, 0, 0, "none"),
    (1, 20, 20, 40, 96, 3, 1, 1, 32, 0, 0, "none"),
    (1, 20, 20, 16, 16, 3, 1, 1, 16, 7, 0, "two_block"),
    (1, 33, 40, 8, 24, 3, 1, 1, 8, 16, 24, "dma"),
]


@pytest.mark.parametrize("case", CONVS)
def test_conv_kernels_vs_plain(dev, case):
    n, h, w, cin, cout, k, s, p, tau, tr, tc, hm = case
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n, h, w, cin, generator=g).to(dev)
    wt = (torch.randn(k, k, cin, cout, generator=g) * 0.2).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    kw = dict(stride=s, padding=p, tau=tau, tile_rows=tr, tile_cols=tc, halo_mode=hm)
    got = conv2d_cuda(x, wt, b, relu=True, **kw)
    want = conv2d_plain(x, wt, b, stride=s, padding=p, relu=True)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    for xd, fmt, shift in [(torch.int16, Q2_14, 16), (torch.int8, Q2_6, 9)]:
        xq, wq = _raws(x.shape, xd, g, dev), _raws(wt.shape, torch.int16, g, dev)
        bq = _raws((cout,), xd, g, dev)
        got = conv2d_q16_cuda(xq, wq, bq, relu=True, fmt=fmt, shift=shift,
                              bias_shift=2, **kw)
        want = conv2d_q16_plain(xq, wq, bq, stride=s, padding=p, shift=shift,
                                bias_shift=2, raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                                out_dtype=fmt.storage_dtype, relu=True)
        assert torch.equal(got, want)


def test_lenet_forward_on_card_matches_cpu(dev):
    params = cnn.init_cnn(torch.Generator().manual_seed(0), cnn.LENET)
    x = torch.rand(4, 32, 32, 1, generator=torch.Generator().manual_seed(1)) * 2 - 1
    cpu = default_template("q16", device="cpu")
    gpu = default_template("q16", device="cuda")
    pol = cnn.calibrate_cnn_policy(cpu, cnn.LENET, params, x)
    want = cnn.cnn_forward(cpu, cnn.LENET, cnn.quantize_cnn_params(cpu, cnn.LENET, params, pol),
                           x, policy=pol)
    gparams = {g_: [{k: v.to(dev) for k, v in l.items()} for l in params[g_]]
               for g_ in ("convs", "fcs")}
    _build.reset_launches()
    got = cnn.cnn_forward(gpu, cnn.LENET,
                          cnn.quantize_cnn_params(gpu, cnn.LENET, gparams, pol),
                          x.to(dev), policy=pol)
    assert _build.launches["conv2d_q16"] == 2 and _build.launches["matmul_q16"] == 3
    assert torch.equal(got.cpu(), want)
