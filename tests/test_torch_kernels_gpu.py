"""The port's CUDA kernels on the card, each held against its plain version
on the same inputs: integers bit for bit, floats at 1e-4 (GEMM, and the
float conv's tensor-core route in 3xTF32) and 2e-3 (the conv's CUDA-core
route, flash attention on both routes), with TF32 off; the float GEMM's
bf16 routes at 2e-2; the float GEMM's routes and the conv's tensor-core
route also bit for bit equal on a second launch; the q16 GEMM's routes
bit for bit on every width mix and rung, with both wrap-around cases; the
fixed-point conv's tensor-core route bit for bit at the zoo's layers on
every width mix and rung, its Cin split, regions and wrap-around cases, and
its preparation pass bit for bit equal to ``ref.conv_q16_weight_planes``;
flash attention's route
wgmma also within 1e-4 (bf16: about one bf16 step) of the emulation of its
split-bf16 arithmetic (``ref.attention_split_bf16``), and its preparation pass bit for bit equal
to ``ref.bf16_split``.  Every test here needs an NVIDIA Hopper card
and skips without one; run them there with ``python -m pytest -m gpu``.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d import (
    conv2d_cuda,
    conv2d_plain,
    conv2d_q16_cuda,
    conv2d_q16_plain,
    prep_q16_tc,
    prep_tc,
    q16_tc_planes_for,
)
from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain, plan_for
from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
from repro_torch.kernels.matmul_q16 import plan_for as q16_plan_for
from repro_torch.kernels.matmul_q16 import planes_for as q16_planes_for
from repro_torch.kernels.matmul_q16 import prep as q16_prep
from repro_torch.core.dse import plan_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels._common import stream_of
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
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


TC_CONVS = [  # n, h, w, cin, cout, k, stride, pad, tau, splits, (tile_rows, tile_cols, halo)
    (2, 20, 20, 64, 64, 3, 1, 1, 64, 1, None),        # VGG16-like, sub-tiles past the edge
    (1, 13, 17, 32, 128, 3, 1, 1, 128, 1, None),      # pixels not a multiple of 128
    (2, 18, 18, 64, 192, 5, 1, 2, 64, 1, None),       # AlexNet conv1: 5x5, pad 2
    (2, 18, 18, 64, 192, 5, 1, 2, 128, 2, None),      # Cout 192 in two τ=128 slices, split
    (1, 6, 6, 192, 384, 3, 1, 1, 128, 6, None),       # AlexNet conv2: Cout 384, 6-way split
    (1, 12, 10, 40, 24, 3, 1, 0, 64, 1, None),        # pad 0, Cin 40 (a part chunk), Cout 24
    (1, 15, 15, 16, 64, 3, 2, 1, 64, 1, None),        # stride 2
    (2, 112, 112, 64, 128, 3, 2, 1, 128, 1, None),    # stride 2, a sub-tile of 80 pixels
    (1, 56, 56, 64, 256, 11, 1, 5, 128, 1, None),     # 11x11, a sub-tile of 88 pixels
    (2, 14, 14, 512, 512, 3, 1, 1, 128, 2, None),     # VGG16 conv10: the planner's split
    (2, 14, 14, 512, 256, 3, 1, 1, 128, 3, None),     # an uneven split (6, 6, 4 chunks)
    (1, 33, 40, 32, 64, 3, 1, 1, 64, 1, (16, 24, "dma")),       # a (𝒯, ℭ) region
    (1, 20, 20, 16, 16, 3, 1, 1, 64, 1, (7, 0, "two_block")),  # row tiles
]


@pytest.mark.parametrize("case", TC_CONVS, ids=lambda c: "-".join(map(str, c[:10])))
def test_conv_tc_route_vs_plain(dev, case):
    """Route "tc" within 1e-4 of the plain version at ragged shapes, bit for
    bit the same on a second launch, each call one prep, one conv and (when
    split) one reduction launch."""
    n, h, w, cin, cout, k, s, p, tau, splits, tiles = case
    tr, tc, hm = tiles or (0, 0, "none")
    g = torch.Generator().manual_seed(sum(case[:10]))
    x = torch.randn(n, h, w, cin, generator=g).to(dev)
    wt = (torch.randn(k, k, cin, cout, generator=g) * (k * k * cin) ** -0.5).to(dev)
    b = (0.1 * torch.randn(cout, generator=g)).to(dev)
    kw = dict(stride=s, padding=p, tau=tau, splits=splits, tile_rows=tr, tile_cols=tc,
              halo_mode=hm, conv_route="tc")
    before = dict(_build.launches)
    got = conv2d_cuda(x, wt, b, relu=True, **kw)
    again = conv2d_cuda(x, wt, b, relu=True, **kw)
    torch.cuda.synchronize()
    grew = {name: _build.launches[name] - before[name] for name in before}
    assert grew["conv2d"] == grew["conv2d.tc"] == grew["conv2d.tc_prep"] == 2
    assert grew["conv2d.cudacore"] == 0 and grew["conv2d.tc_reduce"] == 2 * (splits > 1)
    want = conv2d_plain(x, wt, b, stride=s, padding=p, relu=True)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)


def test_conv_tc_epilogue_and_planned_shapes(dev):
    """Bias, ReLU and fake-quant fused on both of the route's write-backs
    (the conv's own and the split reduction's), at the planner's plans."""
    g = torch.Generator().manual_seed(9)
    for n, h, cin, cout in ((2, 28, 256, 512), (2, 14, 512, 512)):
        x = torch.randn(n, h, h, cin, generator=g).to(dev)
        wt = (torch.randn(3, 3, cin, cout, generator=g) * (9 * cin) ** -0.5).to(dev)
        b = (0.1 * torch.randn(cout, generator=g)).to(dev)
        tpl = default_template("cuda")
        plan = tpl.engine.plan_conv(x.shape, wt.shape, stride=1, padding=1)
        assert plan.conv_route == "tc"
        got = tpl.engine.conv2d(x, wt, bias=b, padding=1, relu=True, qout=Q2_14, plan=plan)
        want = conv2d_plain(x, wt, b, padding=1, relu=True, qout=Q2_14)
        # fake-quant may move a value that sits on a rounding boundary by a step
        step = 1.0 / Q2_14.scale
        diff = (got - want).abs()
        assert float(diff.max()) <= step + 1e-6
        assert float((diff > 1e-4).float().mean()) < 1e-3


def test_conv_tc_weight_prep_is_the_tf32_split(dev):
    """The preparation launch writes (2, Cout, K·K, Cin): the hi and lo
    halves of ``ref.tf32_split``, bit for bit."""
    g = torch.Generator().manual_seed(10)
    w = (torch.randn(5, 5, 40, 72, generator=g) * 3.0).to(dev)
    wp = torch.empty((2, 72, 25, 40), device=dev)
    prep_tc(_build.library("conv2d"), w, wp, device=dev.index,
            stream=torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    hi, lo = ref.tf32_split(w.reshape(25, 40, 72).permute(2, 0, 1))
    assert torch.equal(wp[0], hi) and torch.equal(wp[1], lo)


def test_conv_tc_refuses_unaligned_operands(dev):
    """TMA needs 16-byte aligned bases: the launcher refuses an x that is
    contiguous but starts 4 bytes into its storage, and the wrapper raises."""
    x = torch.randn(1 + 8 * 8 * 16, device=dev)[1:].view(1, 8, 8, 16)
    w = torch.randn(3, 3, 16, 16, device=dev)
    with pytest.raises(RuntimeError, match="does not take"):
        conv2d_cuda(x, w, padding=1, conv_route="tc")


def _zoo_conv(net, i):
    """(h, cin, cout, k, stride, pad) of conv ``i`` of a zoo net."""
    spec = cnn.CNN_ZOO[net]
    hh, ch = spec.input_hw, spec.input_ch
    for j, (cout, k, s, p, pool) in enumerate(spec.convs):
        if j == i:
            return hh, ch, cout, k, s, p
        hh = (hh + 2 * p - k) // s + 1
        hh, ch = hh // (pool or 1), cout


#: x bits, w bits, output format, shift (the int32 sum's top bits on the
#: rung: random raws wrap it over its whole range), ReLU
Q16_TC_MIXES = [
    (torch.int16, torch.int16, Q2_14, 16, True),
    (torch.int16, torch.int8, Q2_6, 24, False),
    (torch.int8, torch.int16, Q2_14, 16, False),
    (torch.int8, torch.int8, Q2_6, 12, True),
]
Q16_TC_ZOO = [("vgg16", 1), ("vgg16", 4), ("vgg16", 8), ("vgg16", 12), ("alexnet", 1),
              ("alexnet", 2), ("alexnet", 3), ("alexnet", 4)]


def _q16_tc_check(x, w, b, *, fmt, shift, relu, **kw):
    """Route "tc" bit for bit against the plain version and on a second
    launch, each call one prep, one conv and (when split) one reduction."""
    before = dict(_build.launches)
    args = dict(relu=relu, fmt=fmt, shift=shift, bias_shift=3, conv_route="tc", **kw)
    got = conv2d_q16_cuda(x, w, b, **args)
    again = conv2d_q16_cuda(x, w, b, **args)
    torch.cuda.synchronize()
    grew = {name: _build.launches[name] - before[name] for name in before}
    assert grew["conv2d_q16"] == grew["conv2d_q16.tc"] == grew["conv2d_q16.tc_prep"] == 2
    assert grew["conv2d_q16.cudacore"] == 0
    assert grew["conv2d_q16.tc_reduce"] == 2 * (kw.get("splits", 1) > 1)
    want = conv2d_q16_plain(x, w, b, stride=kw.get("stride", 1), padding=kw.get("padding", 0),
                            shift=shift, bias_shift=3, raw_min=fmt.raw_min,
                            raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype, relu=relu)
    assert got.dtype == want.dtype
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("mix", range(len(Q16_TC_MIXES)))
@pytest.mark.parametrize("net,i", Q16_TC_ZOO)
def test_conv_q16_tc_zoo_layers(dev, net, i, mix):
    """The zoo's tensor-core layers at full width (batch 2) on the engine's
    plan, every width mix and rung, ReLU on and off."""
    h, cin, cout, k, s, p = _zoo_conv(net, i)
    xd, wd, fmt, shift, relu = Q16_TC_MIXES[mix]
    plan = default_template("q16").engine.plan_conv((2, h, h, cin), (k, k, cin, cout),
                                                    stride=s, padding=p)
    assert plan.conv_route == "tc" and plan.tau == 64
    g = torch.Generator().manual_seed(100 * i + mix)
    x, w = _raws((2, h, h, cin), xd, g, dev), _raws((k, k, cin, cout), wd, g, dev)
    b = _raws((cout,), xd, g, dev)
    _q16_tc_check(x, w, b, fmt=fmt, shift=shift, relu=relu, stride=s, padding=p,
                  tau=plan.tau, splits=plan.splits, sub_rows=plan.sub_rows,
                  sub_cols=plan.sub_cols)


Q16_TC_CONVS = [  # n, h, cin, cout, k, stride, pad, x, w, tau, splits, (tiles)
    (2, 14, 512, 512, 3, 1, 1, torch.int16, torch.int16, 64, 3, None),  # uneven split
    (1, 13, 192, 384, 3, 1, 1, torch.int8, torch.int8, 64, 2, None),    # int8 x int8, split
    (1, 20, 40, 24, 3, 1, 0, torch.int16, torch.int8, 64, 1, None),     # part chunk, Cout 24
    (1, 15, 16, 64, 3, 2, 1, torch.int8, torch.int16, 64, 1, None),     # stride 2
    (1, 19, 8, 16, 5, 4, 2, torch.int16, torch.int16, 64, 1, None),     # stride 4, Cin 8
    (1, 512, 64, 64, 3, 1, 1, torch.int16, torch.int16, 64, 1, (256, 128, "dma")),
    (1, 56, 128, 256, 3, 1, 1, torch.int16, torch.int16, 64, 1, (8, 0, "two_block")),
    (1, 33, 32, 64, 3, 1, 1, torch.int8, torch.int8, 64, 1, (16, 24, "dma")),
]


@pytest.mark.parametrize("case", Q16_TC_CONVS, ids=lambda c: "-".join(map(str, c[:7])))
def test_conv_q16_tc_route_vs_plain(dev, case):
    """Ragged shapes, strides 1 / 2 / 4, Cin splits, Cout past the last τ
    slice's end, the DMA (256 x 128) region and the two-block region."""
    n, h, cin, cout, k, s, p, xd, wd, tau, splits, tiles = case
    tr, tc, hm = tiles or (0, 0, "none")
    g = torch.Generator().manual_seed(h * cin + cout)
    x, w = _raws((n, h, h, cin), xd, g, dev), _raws((k, k, cin, cout), wd, g, dev)
    b = _raws((cout,), xd, g, dev)
    fmt = Q2_14 if xd == torch.int16 else Q2_6
    _q16_tc_check(x, w, b, fmt=fmt, shift=16 if fmt is Q2_14 else 24, relu=True, stride=s,
                  padding=p, tau=tau, splits=splits, tile_rows=tr, tile_cols=tc,
                  halo_mode=hm)


@pytest.mark.parametrize("cout", [16, 24])
@pytest.mark.parametrize("xd", [torch.int16, torch.int8])
def test_conv_q16_tc_cout_inside_one_tau_slice(dev, cout, xd):
    """Cout 16 / 24 with a bias, one split: the τ slice runs past Cout, so
    the one-split epilogue takes its edge path (columns past Cout read no
    bias and are not written).  Bit for bit the plain version over the
    whole output."""
    g = torch.Generator().manual_seed(cout)
    x, w = _raws((2, 12, 12, 32), xd, g, dev), _raws((3, 3, 32, cout), xd, g, dev)
    b = _raws((cout,), xd, g, dev)
    fmt = Q2_14 if xd == torch.int16 else Q2_6
    _q16_tc_check(x, w, b, fmt=fmt, shift=16 if fmt is Q2_14 else 10, relu=False,
                  padding=1, tau=64, splits=1)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("k,cin,v,total", [(3, 4096, -1, 36864), (1, 8, -32768, 0)])
def test_conv_q16_tc_wraps_mod_2_32(dev, k, cin, v, total, splits):
    """Raws -1 at 3x3 x Cin 4096 (the ll limb sum alone passes 2^31; the
    total is 36,864) and -32768 at 1x1 x Cin 8 (the int32 sum 2^33 wraps to
    0): exact, so no ``.satfinite`` and no lost carry."""
    if cin // 64 < splits:
        splits = 1
    x = torch.full((1, 3, 3, cin), v, dtype=torch.int16, device=dev)
    w = torch.full((k, k, cin, 16), v, dtype=torch.int16, device=dev)
    acc = ref.conv_taps_i32(x, w)
    assert int(acc.min()) == int(acc.max()) == total
    got = _q16_tc_check(x, w, None, fmt=Q2_14, shift=1, relu=False, tau=64, splits=splits)
    assert int(got.min()) == int(got.max()) == (total + 1) >> 1


def test_conv_q16_tc_weight_prep_is_the_limb_split(dev):
    """The preparation launch writes (limbs, Cout, K·K, Cinp) bytes, bit for
    bit ``ref.conv_q16_weight_planes``, zeros from Cin to Cinp."""
    g = torch.Generator().manual_seed(11)
    for wd in (torch.int16, torch.int8):
        w = _raws((5, 5, 40, 72), wd, g, dev)
        wp = q16_tc_planes_for(w)
        wp.fill_(0xAB)
        prep_q16_tc(_build.library("conv2d"), w, wp, device=dev.index,
                    stream=torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        assert torch.equal(wp, ref.conv_q16_weight_planes(w, 64))


def test_conv_q16_tc_refuses_what_it_does_not_take(dev):
    """Cin·bytes not a multiple of 16, Cout not a multiple of 8, a τ other
    than 64 (int16 x int16 or int8 x int8) and a misaligned base raise;
    nothing moves to the CUDA cores."""
    before = dict(_build.launches)
    z = dict(padding=1, conv_route="tc", tau=64)
    for xs, ws, kw in (((1, 8, 8, 12), (3, 3, 12, 16), {}),      # 24 bytes of int16
                       ((1, 8, 8, 8), (3, 3, 8, 16), {"x8": 1}),  # 8 bytes of int8
                       ((1, 8, 8, 16), (3, 3, 16, 12), {}),       # Cout 12
                       ((1, 8, 8, 16), (3, 3, 16, 16), {"tau": 128}),
                       ((1, 8, 8, 16), (3, 3, 16, 16), {"tau": 128, "x8": 1, "w8": 1})):
        xd = torch.int8 if kw.pop("x8", 0) else torch.int16
        wd = torch.int8 if kw.pop("w8", 0) else torch.int16
        x = torch.zeros(xs, dtype=xd, device=dev)
        with pytest.raises(ValueError):
            conv2d_q16_cuda(x, torch.zeros(ws, dtype=wd, device=dev), **{**z, **kw})
    x = torch.zeros(1 + 8 * 8 * 16, dtype=torch.int16, device=dev)[1:].view(1, 8, 8, 16)
    with pytest.raises(RuntimeError, match="does not take"):
        conv2d_q16_cuda(x, torch.zeros((3, 3, 16, 16), dtype=torch.int16, device=dev), **z)
    assert _build.launches["conv2d_q16.cudacore"] == before["conv2d_q16.cudacore"]
    assert _build.launches["conv2d_q16.tc"] == before["conv2d_q16.tc"]


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


Q16_MIXES = [(torch.int16, torch.int16), (torch.int16, torch.int8),
             (torch.int8, torch.int16), (torch.int8, torch.int8)]
Q16_RUNGS = {"int16": Q2_14, "int8": Q2_6, "wide": Q2_14}


def _check_q16(x, w, b, blk, rung, *, shift=17, bias_shift=3, relu=True):
    """The q16 GEMM on ``blk`` bit for bit equal to ``matmul_q16_plain``, on
    two launches, each counted once under its route (and its preparation
    or reduction launch)."""
    fmt, wide = Q16_RUNGS[rung], rung == "wide"
    kw = dict(fmt=fmt, block=blk, relu=relu, shift=shift, bias_shift=bias_shift, wide=wide)
    before = dict(_build.launches)
    got = matmul_q16_cuda(x, w, b, **kw)
    again = matmul_q16_cuda(x, w, b, **kw)
    torch.cuda.synchronize()
    grew = {k: _build.launches[k] - before[k] for k in before if k.startswith("matmul_q16")}
    want_grew = {"matmul_q16": 2, f"matmul_q16.{blk.route}": 2,
                 "matmul_q16.prep": 2 if blk.route == "wgmma" else 0,
                 "matmul_q16.splitk_reduce": 2 if blk.route == "splitk" and blk.splits > 1
                 else 0}
    assert {k: grew[k] for k in want_grew} == want_grew, grew
    want = matmul_q16_plain(x, w, b, shift=shift, bias_shift=bias_shift, raw_min=fmt.raw_min,
                            raw_max=fmt.raw_max, out_dtype=got.dtype, relu=relu, wide=wide)
    assert got.dtype == (torch.int32 if wide else fmt.storage_dtype)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.parametrize("rung", list(Q16_RUNGS))
@pytest.mark.parametrize("xd,wd", Q16_MIXES, ids=["16x16", "16x8", "8x16", "8x8"])
@pytest.mark.parametrize("m,n,k", [
    (1, 300, 200), (4, 896, 4864), (8, 4096, 3000), (16, 130, 1000),  # route splitk
    (17, 136, 200), (200, 130, 1000), (300, 1001, 77), (1024, 512, 4608),  # route wgmma
])
def test_matmul_q16_routes_vs_plain(dev, m, n, k, xd, wd, rung):
    """Each route the planner takes (splitk to m = 16, wgmma above, k and n
    ragged; an int8 x with k a multiple of 16 read in place) on every width
    mix and output rung, bit for bit."""
    g = torch.Generator().manual_seed(m + n + k)
    x, w, b = _raws((m, k), xd, g, dev), _raws((k, n), wd, g, dev), _raws((n,), xd, g, dev)
    blk = q16_plan_for(x, w)
    assert blk.route == ("splitk" if m <= 16 else "wgmma"), blk
    _check_q16(x, w, b, blk, rung, shift=(8 * x.element_size() + 8 * w.element_size()) // 2 + 3)


@pytest.mark.parametrize("xd,wd", Q16_MIXES[1:], ids=["16x8", "8x16", "8x8"])
@pytest.mark.parametrize("bn", [64, 128])
def test_matmul_q16_wgmma_tiles(dev, xd, wd, bn):
    """Both compiled tensor-core tiles on each mix that takes them (BN 128
    only with at most two limb products)."""
    g = torch.Generator().manual_seed(bn)
    x, w, b = _raws((333, 520), xd, g, dev), _raws((520, 250), wd, g, dev), _raws(
        (250,), wd, g, dev)
    _check_q16(x, w, b, MatmulBlock(128, bn, 128, route="wgmma"), "int16", shift=12)


@pytest.mark.parametrize("route", ["splitk", "wgmma"])
def test_matmul_q16_wraps_mod_2_32(dev, route):
    """The two wrap cases on each route: x = w = -1 at k = 40,960, where
    the ll limb sum alone passes 2^31 and ``wide`` must read exactly
    40,960 (a .satfinite, or any saturating accumulator, would not); and
    x = w = -32768 at k = 4, where the int32 sum 2^32 wraps to 0."""
    m = 8 if route == "splitk" else 40
    for k, v, want in ((40960, -1, 40960), (4, -32768, 0)):
        x = torch.full((m, k), v, dtype=torch.int16, device=dev)
        w = torch.full((k, 24), v, dtype=torch.int16, device=dev)
        blk = q16_plan_for(x, w)
        assert blk.route == route
        got = matmul_q16_cuda(x, w, block=blk, wide=True, shift=0, bias_shift=0)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.full((m, 24), want, dtype=torch.int32, device=dev))
        _check_q16(x, w, None, blk, "wide", shift=0, bias_shift=0, relu=False)


Q16_SERVING = [  # name, m, n, k: qwen2-0.5b's grid GEMMs, VGG16's fc0
    ("prefill q", 16384, 1024, 896), ("prefill kv", 16384, 128, 896),
    ("prefill o", 16384, 896, 1024), ("prefill gate_up", 16384, 4864, 896),
    ("prefill down", 16384, 896, 4864), ("decode gate_up", 4, 4864, 896),
    ("decode down", 4, 896, 4864), ("head", 4, 151936, 896), ("vgg16 fc0", 8, 4096, 25088),
]


@pytest.mark.parametrize("name,m,n,k", Q16_SERVING, ids=[c[0] for c in Q16_SERVING])
def test_matmul_q16_main_path_shapes(dev, name, m, n, k):
    """The main paths' int16 GEMMs on their planned routes, bit for bit."""
    g = torch.Generator().manual_seed(n + k)
    x, w = _raws((m, k), torch.int16, g, dev), _raws((k, n), torch.int16, g, dev)
    b = _raws((n,), torch.int16, g, dev)
    blk = q16_plan_for(x, w)
    assert blk.route == ("splitk" if m <= 16 else "wgmma")
    _check_q16(x, w, b, blk, "int16", shift=20, bias_shift=4)


def test_matmul_q16_prep_is_the_limb_split(dev):
    """Route wgmma's preparation launch on the card writes
    ``ref.q16_limb_planes`` bit for bit (x planes, w transposed, zero pad)."""
    g = torch.Generator().manual_seed(9)
    x, w = _raws((70, 300), torch.int16, g, dev), _raws((300, 90), torch.int8, g, dev)
    xp, wp, kp = q16_planes_for(x, w, q16_plan_for(x, w))
    q16_prep(_build.library("matmul_q16"), x, w, xp, wp, kp=kp, device=dev.index,
             stream=stream_of(x))
    torch.cuda.synchronize()
    assert torch.equal(xp, ref.q16_limb_planes(x, kp))
    assert torch.equal(wp, ref.q16_limb_planes(w.t(), kp))


def test_matmul_q16_refuses_illegal_blocks(dev):
    g = torch.Generator().manual_seed(2)
    x, w = _raws((64, 64), torch.int16, g, dev), _raws((64, 64), torch.int16, g, dev)
    for blk in (MatmulBlock(128, 128, 128, route="wgmma"), MatmulBlock(4, 256, 64,
                route="splitk"), MatmulBlock(32, 32, 32)):
        with pytest.raises(ValueError, match="does not take"):
            matmul_q16_cuda(x, w, block=blk)


FA_CASES = [  # b, hq, hkv, sq, sk, d, causal, q_offset, dtype
    (1, 4, 4, 64, 64, 32, True, 0, torch.float32),
    (2, 8, 2, 64, 64, 32, True, 0, torch.float32),
    (1, 4, 1, 128, 128, 64, True, 0, torch.float32),
    (2, 4, 4, 64, 64, 32, False, 0, torch.float32),
    (1, 2, 2, 96, 96, 32, True, 0, torch.float32),
    (1, 2, 2, 16, 64, 32, True, 48, torch.float32),
    (2, 16, 2, 300, 300, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 200, 200, 128, True, 0, torch.float32),
    # route wgmma (head dims 64 and 128): MHA over two q tiles, GQA and MQA
    # with Sq / Sk off the 128-row and 128 / 64-key tiles, non-causal, a
    # q_offset with a ragged Sk, and bf16
    (2, 4, 4, 256, 256, 64, True, 0, torch.float32),
    (2, 8, 2, 200, 200, 64, True, 0, torch.float32),
    (1, 8, 1, 130, 130, 128, True, 0, torch.float32),
    (2, 4, 2, 96, 160, 64, False, 0, torch.float32),
    (1, 4, 4, 64, 192, 128, False, 0, torch.float32),
    (1, 4, 2, 100, 300, 128, True, 200, torch.float32),
    (1, 2, 2, 77, 333, 64, True, 256, torch.float32),
    (2, 16, 2, 300, 300, 128, True, 0, torch.bfloat16),
    (1, 4, 4, 64, 64, 64, False, 0, torch.bfloat16),
    # tensors smaller than one TMA box (10 q rows, 9 kv rows)
    (1, 2, 1, 5, 9, 64, True, 4, torch.float32),
    (1, 1, 1, 3, 7, 128, False, 0, torch.bfloat16),
]
#: route wgmma against the emulation of its own split-bf16 arithmetic: only
#: the order of the f32 sums (and exp2's last bits) differ.  bf16 outputs to
#: one bf16 step relative, plus 2^-12 (one step at the typical |out| ~ 0.04):
#: there p is rounded to bf16, and an f32 p that differs in its last bits
#: can round to the neighbouring value, 2^-8 of p (2^-14 seen on an H100)
FA_SPLIT_TOL = 1e-4
FA_SPLIT_TOL_BF16 = dict(atol=2 ** -12, rtol=2 ** -7)


def _fa_operands(case, dev):
    b, hq, hkv, sq, sk, d, _, _, dtype = case
    g = torch.Generator().manual_seed(sq + d)
    # the model's layout: (B, S, H, D) memory viewed as (B, H, S, D)
    q = (0.5 * torch.randn(b, sq, hq, d, generator=g)).to(dev, dtype).transpose(1, 2)
    k = (0.5 * torch.randn(b, sk, hkv, d, generator=g)).to(dev, dtype).transpose(1, 2)
    v = (0.5 * torch.randn(b, sk, hkv, d, generator=g)).to(dev, dtype).transpose(1, 2)
    return q, k, v


def _fa_counts():
    return {r: _build.launches[f"flash_attention.{r}"] for r in ("simt", "wgmma", "prep")}


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_kernel_vs_plain(dev, case):
    b, hq, hkv, sq, sk, d, causal, q_offset, dtype = case
    q, k, v = _fa_operands(case, dev)
    plan = plan_flash(d, q.element_size(), H100)
    before = _fa_counts()
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset, bq=32, bk=32)
    wgmma = plan.route == "wgmma"
    assert _fa_counts() == {"simt": before["simt"] + (not wgmma),
                            "wgmma": before["wgmma"] + wgmma,
                            "prep": before["prep"] + wgmma}
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, bk=32)
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if wgmma:
        split = ref.attention_split_bf16(q, k, v, causal=causal, q_offset=q_offset,
                                         bk=plan.bk)
        tols = (dict(atol=FA_SPLIT_TOL, rtol=FA_SPLIT_TOL) if dtype == torch.float32
                else FA_SPLIT_TOL_BF16)
        torch.testing.assert_close(got, split, **tols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_prep_is_the_bf16_split(dev, dtype):
    """Route wgmma's preparation launch writes q, k and v (strided views) as
    dense (B·H·S, D) planes equal bit for bit to ``ref.bf16_split``: hi and
    lo for f32, hi alone (the operand itself) for bf16."""
    q, k, v = _fa_operands((2, 8, 2, 200, 136, 64, True, 0, dtype), dev)
    qp, kp, vp = fa.planes(q, k)
    assert qp.shape[0] == (2 if dtype == torch.float32 else 1)
    fa.prep(_build.library("flash_attention"), q, k, v, qp, kp, vp, device=dev.index,
            stream=stream_of(q))
    torch.cuda.synchronize()
    for x, xp in ((q, qp), (k, kp), (v, vp)):
        hi, lo = ref.bf16_split(x.contiguous().reshape(-1, x.shape[-1]))
        assert torch.equal(xp[0], hi)
        if dtype == torch.float32:
            assert torch.equal(xp[1], lo)
        else:
            assert torch.equal(xp[0], x.contiguous().reshape(-1, x.shape[-1]))


def test_flash_refuses_what_no_route_takes(dev):
    """A head dim, dtype, layout or alignment that no route takes raises,
    on a CUDA tensor as on the kernels' C entry points; nothing moves to
    another route."""
    def qkv(d, dtype=torch.float32):
        return (torch.zeros(1, 2, 64, d, device=dev, dtype=dtype) for _ in range(3))

    for d in (24, 256):
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_cuda(*qkv(d))
    with pytest.raises(TypeError):
        flash_attention_cuda(*qkv(64, torch.float16))
    q, k, v = qkv(64)
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention_cuda(q.transpose(2, 3), k, v)
    # rows of 65 floats (260 bytes), and a base 4 bytes off 16
    wide = torch.zeros(1, 2, 64, 65, device=dev)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(wide, k, v)
    off = torch.zeros(1 + 2 * 64 * 64, device=dev)[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(off, k, v)
    lib = _build.library("flash_attention")
    qp, kp, vp = fa.planes(q, k)
    with pytest.raises(RuntimeError, match="does not take"):  # the C check, unaligned q
        fa.prep(lib, off, k, v, qp, kp, vp, device=dev.index, stream=stream_of(q))
    plan = plan_flash(64, 4, H100)
    with pytest.raises(RuntimeError, match="does not take"):  # head dim 32 on wgmma
        q32, k32, _ = qkv(32)
        qp, kp, vp = fa.planes(q32, k32)
        fa.launch_wgmma(lib, qp, kp, vp, torch.empty_like(q32), plan=plan,
                        kv_shape=k32.shape, causal=True, q_offset=0, device=dev.index,
                        stream=stream_of(q))
    # a plan whose kv tile or shared memory is not the header's
    qp, kp, vp = fa.planes(q, k)
    for bad in (dataclasses.replace(plan, bk=64), dataclasses.replace(plan, smem=plan.smem + 8)):
        with pytest.raises(RuntimeError, match="does not take"):
            fa.launch_wgmma(lib, qp, kp, vp, torch.empty_like(q), plan=bad, kv_shape=k.shape,
                            causal=True, q_offset=0, device=dev.index, stream=stream_of(q))
    # head dim 64 on route simt, which is compiled for 16 and 32
    with pytest.raises(RuntimeError, match="does not take"):
        fa.launch(lib, q, k, v, torch.empty_like(q), plan=plan_flash(32, 4, H100),
                  causal=True, q_offset=0, device=dev.index, stream=stream_of(q))


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
    # head dim 16: route simt, once a layer
    assert _build.launches["flash_attention.simt"] == cfg.n_layers
    assert _build.launches["flash_attention.wgmma"] == 0
    want, _ = T.forward(default_template("torch"), cfg, params, tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_reduced_qwen_at_head_dim_64_takes_route_wgmma(dev, monkeypatch):
    """The reduced qwen2-0.5b at the model's own head dim, 64: flash runs on
    route wgmma (and its preparation) once a layer, and the logits stay
    within the reference's flash tolerance, 2e-3, of the torch backend."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention, transformer as T

    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 8)
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), head_dim=64)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(dev)
    _build.reset_launches()
    got, _ = T.forward(default_template("cuda"), cfg, params, tokens)
    assert _build.launches["flash_attention.wgmma"] == cfg.n_layers
    assert _build.launches["flash_attention.prep"] == cfg.n_layers
    assert _build.launches["flash_attention.simt"] == 0
    want, _ = T.forward(default_template("torch"), cfg, params, tokens)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
