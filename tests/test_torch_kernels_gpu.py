"""The port's CUDA kernels on the card, each held against its plain version
on the same inputs: integers bit for bit, floats at 1e-4 (GEMM) and 2e-3
(conv, flash attention), with TF32 off; the float GEMM's bf16 routes at
2e-2, each of its routes also bit for bit equal on a second launch.  Every
test here needs an NVIDIA Hopper card and skips without one; run them there
with ``python -m pytest -m gpu``.
"""
import pytest
import torch

from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d import (
    conv2d_cuda,
    conv2d_plain,
    conv2d_q16_cuda,
    conv2d_q16_plain,
)
from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain, plan_for
from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_fp_transposed_b_vs_plain(dev, dtype):
    """The tied head's operand: w the transposed view of an (n, k) table."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 96, generator=g).to(dev, dtype)
    table = torch.randn(1000, 96, generator=g).to(dev, dtype)
    got = matmul_fp_cuda(x, table.T)
    want = matmul_fp_plain(x, table.T)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _fp_operands(m, n, k, dtype, trans_b, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    if trans_b:  # the tied head's operand: the transposed view of an (n, k) table
        w = (torch.randn(n, k, generator=g) * k ** -0.5).to(dev, dtype).T
    else:
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, dtype)
    b = (0.1 * torch.randn(n, generator=g)).to(dev)
    return x, w, b


def _check_route(x, w, b, route, **epi):
    """The planner's route for x @ w is ``route``; the kernel agrees with
    the plain version (1e-4 in f32, 2e-2 in bf16) and repeats bit for bit."""
    blk = plan_for(x, w)
    assert blk.route == route, blk
    before = dict(_build.launches)
    got = matmul_fp_cuda(x, w, b, block=blk, **epi)
    again = matmul_fp_cuda(x, w, b, block=blk, **epi)
    torch.cuda.synchronize()
    assert _build.launches[f"matmul_fp.{route}"] == before[f"matmul_fp.{route}"] + 2
    assert _build.launches["matmul_fp"] == before["matmul_fp"] + 2
    reduces = 2 if route == "splitk" and blk.splits > 1 else 0
    assert (_build.launches["matmul_fp.splitk_reduce"]
            == before["matmul_fp.splitk_reduce"] + reduces)
    want = matmul_fp_plain(x, w, b, **epi)
    tol = 1e-4 if x.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("trans_b", [False, True], ids=["w", "wT"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 64, 200])
@pytest.mark.parametrize("n,k", [(136, 200), (130, 1000)], ids=["n136k200", "n130k1000"])
def test_matmul_fp_routes_vs_plain(dev, m, n, k, dtype, trans_b):
    """Each route the planner takes: S for m <= 16, W for bf16 with m > 16
    and n, k multiples of 8, L otherwise; ragged m and n on every route."""
    x, w, b = _fp_operands(m, n, k, dtype, trans_b, dev, m + n + k)
    if m <= 16:
        route = "splitk"
    elif dtype == torch.bfloat16 and n % 8 == 0:
        route = "wgmma"
    else:
        route = "tile"
    _check_route(x, w, b, route, relu=True)


QWEN_GEMMS = [  # name, n, k (qwen2-0.5b: d 896, q 1024, kv 128, d_ff 4864)
    ("q", 1024, 896), ("kv", 128, 896), ("o", 896, 1024), ("gate_up", 4864, 896),
    ("down", 896, 4864),
]


@pytest.mark.parametrize("name,n,k", QWEN_GEMMS, ids=[c[0] for c in QWEN_GEMMS])
@pytest.mark.parametrize("m,route", [(16384, "wgmma"), (4, "splitk")], ids=["prefill", "decode"])
def test_matmul_fp_qwen_shapes(dev, name, n, k, m, route):
    x, w, b = _fp_operands(m, n, k, torch.bfloat16, False, dev, n + k)
    _check_route(x, w, b, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_matmul_fp_tied_head_and_fc0(dev, dtype):
    x, w, _ = _fp_operands(4, 151936, 896, dtype, True, dev, 5)
    _check_route(x, w, None, "splitk")
    x, w, b = _fp_operands(8, 4096, 25088, torch.float32, False, dev, 6)
    _check_route(x, w, b, "splitk", relu=True, qout=Q2_14)


def test_matmul_fp_wgmma_epilogue_and_refusals(dev):
    """Route W fuses the same epilogue; it refuses f32 and unaligned rows."""
    x, w, b = _fp_operands(300, 256, 128, torch.bfloat16, False, dev, 7)
    _check_route(x, w, b, "wgmma", relu=True, qout=Q2_14)
    blk = MatmulBlock(128, 256, 64, route="wgmma")
    with pytest.raises(ValueError):
        matmul_fp_cuda(x.float(), w.float(), block=blk)
    with pytest.raises(ValueError):
        matmul_fp_cuda(x[:, :124], w[:124, :252].contiguous(), block=blk)


FA_CASES = [  # b, hq, hkv, sq, sk, d, causal, q_offset, dtype
    (1, 4, 4, 64, 64, 32, True, 0, torch.float32),
    (2, 8, 2, 64, 64, 32, True, 0, torch.float32),
    (1, 4, 1, 128, 128, 64, True, 0, torch.float32),
    (2, 4, 4, 64, 64, 32, False, 0, torch.float32),
    (1, 2, 2, 96, 96, 32, True, 0, torch.float32),
    (1, 2, 2, 16, 64, 32, True, 48, torch.float32),
    (2, 16, 2, 300, 300, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 200, 200, 128, True, 0, torch.float32),
]


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_kernel_vs_plain(dev, case):
    b, hq, hkv, sq, sk, d, causal, q_offset, dtype = case
    g = torch.Generator().manual_seed(sq + d)
    # the model's layout: (B, S, H, D) memory viewed as (B, H, S, D)
    q = (0.5 * torch.randn(b, sq, hq, d, generator=g)).to(dev, dtype).transpose(1, 2)
    k = (0.5 * torch.randn(b, sk, hkv, d, generator=g)).to(dev, dtype).transpose(1, 2)
    v = (0.5 * torch.randn(b, sk, hkv, d, generator=g)).to(dev, dtype).transpose(1, 2)
    before = _build.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset, bq=32, bk=32)
    assert _build.launches["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, bk=32)
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_reduced_qwen_on_card_matches_torch_backend(dev, monkeypatch):
    """Reduced qwen2-0.5b with the chunked route forced: the cuda backend
    (GEMM and flash kernels) against the plain torch backend on the card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention, transformer as T

    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 8)
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(dev)
    _build.reset_launches()
    got, _ = T.forward(default_template("cuda"), cfg, params, tokens)
    assert _build.launches["flash_attention"] == cfg.n_layers
    want, _ = T.forward(default_template("torch"), cfg, params, tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
