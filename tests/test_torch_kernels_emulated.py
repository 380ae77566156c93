"""The CUDA kernels' own code, run on the CPU under an emulation of CUDA.

``tests/cuda_cpu_shim.h`` lets g++ compile ``src/repro_torch/kernels/csrc``
(every block in turn, each CUDA thread a std::thread).  The modules'
``launch`` functions then call the kernels' C entry points on CPU tensors,
exactly as the wrappers do on the card, and the results are held against
the plain versions: integers bit for bit, floats at 1e-4.  This checks the
kernels' indexing, tiling, masking, Cin chunks, epilogues, the GEMM's
transposed-B operand, both GEMMs' split-k route (the float one in both
layouts, the q16 one on every width mix; their slices and fixed-order
reductions), the q16 GEMM's preparation launch (byte planes, transpose,
zero pad) and flash attention's GQA indexing, causal block skip, ragged
rows, ``q_offset`` and strided views at tiny shapes here; it says nothing
about speed, and the card runs the real build.  The GEMMs' wgmma routes
are inline PTX for sm_90a with no CPU counterpart (``csrc/gemm_wgmma.cuh``
and the main kernel of ``csrc/gemm_q16_wgmma.cuh`` are left out under the
shim): only the card tests (``tests/test_torch_kernels_gpu.py``) run them.
"""
import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.core import dse as tdse
from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import _build, conv2d, flash_attention, matmul_fp, matmul_q16, ref

SHIM = Path(__file__).with_name("cuda_cpu_shim.h")
NULL_STREAM = ctypes.c_void_p(0)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each csrc/*.cu built by g++ against the shim, all at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels against the CPU shim")
    out = tmp_path_factory.mktemp("emulated")
    procs = {}
    for name, src in _build.SOURCES.items():
        cmd = [gxx, "-std=c++20", "-x", "c++", "-include", str(SHIM), "-O1",
               "-shared", "-fPIC", "-pthread", "-o", str(out / f"lib{name}.so"),
               str(_build.CSRC / src)]
        procs[name] = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    return {name: _build.bind(ctypes.CDLL(str(out / f"lib{name}.so")), name)
            for name in _build.SOURCES}


def _raws(shape, dtype, gen):
    lim = 127 if dtype == torch.int8 else 32767
    return torch.randint(-lim - 1, lim + 1, shape, generator=gen).to(dtype)


@pytest.mark.parametrize("tile", H100.gemm_tiles)
@pytest.mark.parametrize("m,n,k", [(5, 70, 33), (130, 129, 40)])
def test_gemm_kernels_emulated(libs, tile, m, n, k):
    g = torch.Generator().manual_seed(m * n + k)
    blk = MatmulBlock(*tile)
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    b = torch.randn(n, generator=g)
    out = torch.empty(m, n)
    matmul_fp.launch(libs["matmul_fp"], x, w, b, out, blk, True, Q2_14, 0, NULL_STREAM)
    torch.testing.assert_close(out, matmul_fp.matmul_fp_plain(x, w, b, relu=True, qout=Q2_14),
                               atol=1e-4, rtol=1e-4)
    for xd, wd, od, shift, bs, wide in [
        (torch.int16, torch.int16, torch.int16, 14, 14, False),
        (torch.int8, torch.int16, torch.int8, 20, 3, False),
        (torch.int16, torch.int8, torch.int16, -2, 0, False),
        (torch.int16, torch.int16, torch.int32, 0, 5, True),
    ]:
        xq, wq = _raws((m, k), xd, g), _raws((k, n), wd, g)
        bq = _raws((n,), torch.int16, g)
        fmt = Q2_6 if od == torch.int8 else Q2_14
        out = torch.empty(m, n, dtype=od)
        matmul_q16.launch(libs["matmul_q16"], xq, wq, bq.to(torch.int32), out, blk,
                          relu=not wide, shift=shift, bias_shift=bs, raw_min=fmt.raw_min,
                          raw_max=fmt.raw_max, device=0, stream=NULL_STREAM)
        want = matmul_q16.matmul_q16_plain(xq, wq, bq, shift=shift, bias_shift=bs,
                                           raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                                           out_dtype=od, relu=not wide, wide=wide)
        assert torch.equal(out, want), (xd, wd, od, shift)


@pytest.mark.parametrize("tile", H100.gemm_tiles)
def test_gemm_transposed_b_emulated(libs, tile):
    """w as the transposed view of a contiguous (n, k) matrix (the tied LM
    head's ``embed.T``) is read in place and gives the plain product."""
    g = torch.Generator().manual_seed(7)
    m, n, k = 5, 133, 37
    x, wt = torch.randn(m, k, generator=g), torch.randn(n, k, generator=g)
    w = wt.t()
    assert matmul_fp.transposed(w) and not matmul_fp.transposed(wt)
    out = torch.empty(m, n)
    matmul_fp.launch(libs["matmul_fp"], x, w, None, out, MatmulBlock(*tile), False, None,
                     0, NULL_STREAM)
    torch.testing.assert_close(out, matmul_fp.matmul_fp_plain(x, w), atol=1e-4, rtol=1e-4)


SPLITK_CASES = [  # m, n, k, trans_b, slice (None: the planner's)
    (1, 300, 200, False, None),   # one thread row's groups end inside the slice
    (4, 70, 333, False, 64),      # ragged n (scalar loads), k not a multiple of 64
    (8, 260, 1000, False, None),  # ragged last column tile, vector loads
    (16, 33, 130, False, 64),     # m = 16 in four reduction passes
    (1, 70, 333, True, 64),       # transposed, k not a multiple of 4 (scalar loads)
    (4, 133, 896, True, None),    # the tied head's layout: one slice, whole rows
    (8, 64, 1000, True, 128),     # transposed, several slices
    (16, 9, 96, True, None),
]


@pytest.mark.parametrize("case", SPLITK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_gemm_splitk_route_emulated(libs, case):
    """Route S (csrc/gemm_splitk.cuh) in f32, against the plain version at
    1e-4, and bit for bit equal on a second launch (no atomics)."""
    m, n, k, tb, piece = case
    g = torch.Generator().manual_seed(m * n + k)
    x, b = torch.randn(m, k, generator=g), torch.randn(n, generator=g)
    w = torch.randn(n, k, generator=g).t() if tb else torch.randn(k, n, generator=g)
    blk = tdse.default_fp_block_for(m, n, k, H100, dtype_bytes=4)
    if piece is not None:
        blk = MatmulBlock(blk.bm, blk.bn, piece, route="splitk", splits=-(-k // piece))
    assert blk.route == "splitk"
    assert tdse.fp_block_legal(blk, m, n, k, dtype_bytes=4, spec=H100)
    want = matmul_fp.matmul_fp_plain(x, w, b, relu=True)
    outs = []
    for _ in range(2):
        out = torch.full((m, n), float("nan"))
        matmul_fp.launch(libs["matmul_fp"], x, w, b, out, blk, True, None, 0, NULL_STREAM,
                         matmul_fp.workspace_for(blk, m, n, "cpu"))
        outs.append(out)
    torch.testing.assert_close(outs[0], want, atol=1e-4, rtol=1e-4)
    assert torch.equal(outs[0], outs[1])


def test_gemm_splitk_epilogue_emulated(libs):
    """Bias, ReLU and fake-quant fused into route S's write-back, with one
    slice (in the streaming kernel) and several (in the reduction)."""
    g = torch.Generator().manual_seed(11)
    m, n, k = 8, 120, 400
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    b = torch.randn(n, generator=g)
    want = matmul_fp.matmul_fp_plain(x, w, b, relu=True, qout=Q2_14)
    for piece in (448, 64):
        blk = MatmulBlock(8, 256, piece, route="splitk", splits=-(-k // piece))
        out = torch.full((m, n), float("nan"))
        matmul_fp.launch(libs["matmul_fp"], x, w, b, out, blk, True, Q2_14, 0, NULL_STREAM,
                         matmul_fp.workspace_for(blk, m, n, "cpu"))
        torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


Q16_SPLITK_CASES = [  # m, n, k, x dtype, w dtype, out rung, slice (None: the planner's)
    (1, 300, 200, torch.int16, torch.int16, "int16", None),
    (4, 70, 333, torch.int8, torch.int16, "int8", 64),     # ragged n (scalar loads)
    (8, 260, 1000, torch.int16, torch.int8, "wide", None),  # vector loads, ragged tile
    (16, 33, 130, torch.int8, torch.int8, "int16", 64),    # m = 16, four reduction passes
    (3, 264, 700, torch.int16, torch.int16, "int8", 128),   # several slices, vector loads
]


@pytest.mark.parametrize("case", Q16_SPLITK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_q16_splitk_route_emulated(libs, case):
    """The q16 GEMM's route "splitk" (the integer instantiation of
    csrc/gemm_splitk.cuh: int32-staged x, uint32_t multiply-adds, uint32_t
    partial sums reduced in slice order with IntEpilogue) bit for bit equal
    to the plain version, on one slice and on several, and on a second
    launch."""
    m, n, k, xd, wd, rung, piece = case
    g = torch.Generator().manual_seed(m * n + k)
    xq, wq, bq = _raws((m, k), xd, g), _raws((k, n), wd, g), _raws((n,), torch.int16, g)
    blk = tdse.default_q16_block_for(m, n, k, H100, xbits=8 * xq.element_size(),
                                     wbits=8 * wq.element_size())
    if piece is not None:
        blk = MatmulBlock(blk.bm, blk.bn, piece, route="splitk", splits=-(-k // piece))
    assert blk.route == "splitk"
    assert tdse.q16_block_legal(blk, m, n, k, xbits=8 * xq.element_size(),
                                wbits=8 * wq.element_size(), spec=H100)
    fmt = Q2_6 if rung == "int8" else Q2_14
    wide = rung == "wide"
    od = torch.int32 if wide else fmt.storage_dtype
    kw = dict(shift=17, bias_shift=4, raw_min=fmt.raw_min, raw_max=fmt.raw_max)
    want = matmul_q16.matmul_q16_plain(xq, wq, bq, out_dtype=od, relu=not wide, wide=wide,
                                       **kw)
    outs = []
    for _ in range(2):
        out = torch.full((m, n), -7, dtype=od)
        matmul_q16.launch(libs["matmul_q16"], xq, wq, bq.to(torch.int32), out, blk,
                          relu=not wide, device=0, stream=NULL_STREAM,
                          workspace=matmul_q16.workspace_for(blk, m, n, "cpu"), **kw)
        outs.append(out)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)


def test_q16_splitk_wraps_mod_2_32_emulated(libs):
    """Raws x = w = -32768 at k = 4: the int32 sum 2^32 wraps to 0 on route
    "splitk" across two slices' partial sums, as in the plain version."""
    xq = torch.full((2, 128), -32768, dtype=torch.int16)
    wq = torch.full((128, 8), -32768, dtype=torch.int16)
    blk = MatmulBlock(2, 256, 64, route="splitk", splits=2)
    out = torch.full((2, 8), 5, dtype=torch.int32)
    matmul_q16.launch(libs["matmul_q16"], xq, wq, None, out, blk, relu=False, shift=0,
                      bias_shift=0, raw_min=-1, raw_max=1, device=0, stream=NULL_STREAM,
                      workspace=matmul_q16.workspace_for(blk, 2, 8, "cpu"))
    want = matmul_q16.matmul_q16_plain(xq, wq, shift=0, bias_shift=0, raw_min=-1, raw_max=1,
                                       out_dtype=torch.int32, wide=True)
    assert torch.equal(out, want) and int(want.abs().max()) == 0


Q16_PREP_CASES = [  # m, n, k, x dtype, w dtype
    (5, 70, 33, torch.int16, torch.int16),    # ragged everything, k padded to 128
    (130, 129, 200, torch.int8, torch.int16),  # int8 x with unaligned rows: a plane
    (17, 64, 128, torch.int16, torch.int8),
    (9, 3, 256, torch.int8, torch.int8),       # int8 x with 16-byte rows: read in place
]


@pytest.mark.parametrize("case", Q16_PREP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_q16_prep_launch_emulated(libs, case):
    """Route "wgmma"'s preparation launch writes each operand's byte planes
    (signed hi and unsigned lo limbs of int16, the int8 raw itself), w
    transposed to (n, kp), and zeros from k to kp, bit for bit equal to
    ``ref.q16_limb_planes``; an aligned int8 x gets no planes."""
    m, n, k, xd, wd = case
    g = torch.Generator().manual_seed(m + n + k)
    xq, wq = _raws((m, k), xd, g), _raws((k, n), wd, g)
    xp, wp, kp = matmul_q16.planes_for(xq, wq, MatmulBlock(128, 64, 128, route="wgmma"))
    assert kp % 128 == 0 and k <= kp < k + 128
    assert (xp is None) == (xd == torch.int8 and k % 16 == 0)
    for t in (xp, wp):
        if t is not None:
            t.fill_(0xAB)
    matmul_q16.prep(libs["matmul_q16"], xq, wq, xp, wp, kp=kp, device=0, stream=NULL_STREAM)
    assert torch.equal(wp, ref.q16_limb_planes(wq.t(), kp))
    if xp is not None:
        assert torch.equal(xp, ref.q16_limb_planes(xq, kp))


def test_q16_routes_refuse_bad_launches(libs):
    """The q16 entry points refuse what their routes were not compiled for:
    a split-k plan that does not cover m or k, a preparation whose kp is
    not a multiple of the 128-byte k step, an int8 x read in place whose
    rows TMA cannot address, and (under the shim) route "wgmma" itself."""
    lib = libs["matmul_q16"]
    xq = torch.zeros(4, 8, dtype=torch.int16)
    wq = torch.zeros(8, 5, dtype=torch.int16)
    out = torch.empty(4, 5, dtype=torch.int16)
    kw = dict(relu=False, shift=0, bias_shift=0, raw_min=-1, raw_max=1, device=0,
              stream=NULL_STREAM)
    for blk in (MatmulBlock(2, 256, 64, route="splitk"),            # m = 4 rows > 2
                MatmulBlock(4, 256, 32, route="splitk"),            # slice not x 64
                MatmulBlock(4, 256, 64, route="splitk", splits=2)):  # 2 slices, k = 8
        with pytest.raises(RuntimeError, match="does not take"):
            matmul_q16.launch(lib, xq, wq, None, out, blk, workspace=torch.empty(
                2, 4, 5, dtype=torch.int32) if blk.splits > 1 else None, **kw)
    xp, wp, kp = matmul_q16.planes_for(xq, wq, MatmulBlock(128, 64, 128, route="wgmma"))
    with pytest.raises(RuntimeError, match="does not take"):
        matmul_q16.prep(lib, xq, wq, xp, wp, kp=kp - 8, device=0, stream=NULL_STREAM)
    x8 = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="does not take"):  # k = 8: no in-place read
        matmul_q16.prep(lib, x8, wq, None, wp, kp=kp, device=0, stream=NULL_STREAM)
    with pytest.raises(RuntimeError, match="does not take"):
        matmul_q16.launch(lib, xq, wq, None, out, MatmulBlock(128, 64, 128, route="wgmma"),
                          planes=(xp, wp, kp), **kw)


FA_CASES = [  # b, hq, hkv, sq, sk, d, causal, q_offset, strided
    (1, 2, 2, 64, 64, 16, True, 0, False),
    (2, 4, 2, 70, 70, 32, True, 0, True),     # GQA, ragged rows, (B, S, H, D) views
    (1, 4, 1, 130, 130, 16, True, 0, False),  # MQA, three q tiles, causal skip
    (1, 2, 2, 16, 80, 32, True, 64, False),   # decode-style rows at the end of the keys
    (1, 2, 1, 40, 64, 16, False, 0, True),    # non-causal
]


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_emulated(libs, case):
    b, hq, hkv, sq, sk, d, causal, q_offset, strided = case
    g = torch.Generator().manual_seed(sq * d + hq)

    def draw(h, s):
        if strided:  # the model's layout: (B, S, H, D) memory, viewed as (B, H, S, D)
            return (torch.randn(b, s, h, d, generator=g) * 0.5).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=g) * 0.5

    q, k, v = draw(hq, sq), draw(hkv, sk), draw(hkv, sk)
    out = torch.empty_like(q)
    flash_attention.launch(libs["flash_attention"], q, k, v, out,
                           plan=tdse.plan_flash(d, 4, H100), causal=causal,
                           q_offset=q_offset, device=0, stream=NULL_STREAM)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d,change", [(32, {"smem": 4}), (32, {"bk": -32}), (64, {})],
                         ids=["smem", "bk", "head-dim-64"])
def test_flash_simt_refuses_a_plan_it_did_not_compile(libs, d, change):
    """Route simt's C entry point takes the planner's kv tile and shared
    memory and refuses a plan that differs from its compiled kernel, and it
    is compiled for head dims 16 and 32 only (64 and 128 are route wgmma's)."""
    plan = tdse.plan_flash(32, 4, H100)
    plan = dataclasses.replace(plan, **{f: getattr(plan, f) + dv for f, dv in change.items()})
    q = torch.randn(1, 2, 64, d)
    with pytest.raises(RuntimeError, match="does not take"):
        flash_attention.launch(libs["flash_attention"], q, q, q, torch.empty_like(q),
                               plan=plan, causal=True, q_offset=0, device=0,
                               stream=NULL_STREAM)


CONVS = [  # n, h, w, cin, cout, k, stride, pad, tau, chunk, tile_rows, tile_cols, halo
    (2, 12, 12, 3, 10, 3, 1, 1, 8, 0, 0, 0, "none"),
    (1, 9, 9, 5, 70, 3, 1, 1, 64, 2, 0, 0, "none"),
    (1, 23, 19, 3, 16, 11, 4, 2, 16, 0, 0, 0, "none"),
    (1, 13, 17, 6, 40, 3, 1, 1, 32, 4, 5, 0, "two_block"),
    (1, 20, 20, 4, 8, 3, 1, 1, 8, 0, 7, 9, "dma"),
    (1, 8, 8, 2, 260, 3, 1, 1, 256, 0, 3, 5, "dma"),
]


@pytest.mark.parametrize("case", CONVS, ids=lambda c: f"k{c[5]}s{c[6]}tau{c[8]}{c[12]}")
def test_conv_kernels_emulated(libs, case):
    n, h, wd, cin, cout, k, s, p, tau, chunk, tr, tc, hm = case
    g = torch.Generator().manual_seed(sum(case[:12]))
    x = torch.randn(n, h, wd, cin, generator=g)
    w = torch.randn(k, k, cin, cout, generator=g) * 0.3
    b = torch.randn(cout, generator=g)
    geo = conv2d.conv_launch_geometry(x.shape, w.shape, stride=s, padding=p, tau=tau,
                                      cin_chunk=chunk, tile_rows=tr, tile_cols=tc,
                                      halo_mode=hm)
    out = torch.full((n, geo.ho, geo.wo, cout), float("nan"))
    conv2d.launch(libs["conv2d"], x, w, b, out, geo, relu=False, qout=Q2_14, device=0,
                  stream=NULL_STREAM)
    want = conv2d.conv2d_plain(x, w, b, stride=s, padding=p, qout=Q2_14)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    for xd, wd_, fmt in [(torch.int16, torch.int16, Q2_14), (torch.int8, torch.int16, Q2_6)]:
        xq, wq = _raws(x.shape, xd, g), _raws(w.shape, wd_, g)
        bq = _raws((cout,), torch.int16, g)
        out = torch.zeros((n, geo.ho, geo.wo, cout), dtype=fmt.storage_dtype)
        conv2d.launch_q16(libs["conv2d"], xq, wq, bq.to(torch.int32), out, geo, relu=True,
                          shift=16, bias_shift=6, raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                          device=0, stream=NULL_STREAM)
        want = conv2d.conv2d_q16_plain(xq, wq, bq, stride=s, padding=p, shift=16,
                                       bias_shift=6, raw_min=fmt.raw_min,
                                       raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype,
                                       relu=True)
        assert torch.equal(out, want), xd


def test_kernels_refuse_bad_launches(libs):
    """The C entry points return an error, and ``check`` raises, for a tile
    that was not compiled or a shift out of range."""
    x, w = torch.randn(4, 8), torch.randn(8, 5)
    out = torch.empty(4, 5)
    with pytest.raises(RuntimeError, match="does not take"):
        matmul_fp.launch(libs["matmul_fp"], x, w, None, out, MatmulBlock(32, 32, 32),
                         False, None, 0, NULL_STREAM)
    bad_splitk = [
        MatmulBlock(2, 256, 64, route="splitk"),             # m = 4 rows > 2
        MatmulBlock(4, 64, 64, route="splitk"),              # row-major w takes 256 columns
        MatmulBlock(4, 256, 32, route="splitk"),             # slice not a multiple of 64
        MatmulBlock(4, 256, 64, route="splitk", splits=2),   # 2 slices of 64 != k = 8
    ]
    for blk in bad_splitk:
        with pytest.raises(RuntimeError, match="does not take"):
            matmul_fp.launch(libs["matmul_fp"], x, w, None, out, blk, False, None, 0,
                             NULL_STREAM)
    with pytest.raises(RuntimeError, match="does not take"):  # wgmma: f32, and no shim
        matmul_fp.launch(libs["matmul_fp"], x, w, None, out,
                         MatmulBlock(128, 128, 64, route="wgmma"), False, None, 0, NULL_STREAM)
    q = torch.zeros(4, 8, dtype=torch.int16)
    qf = torch.randn(1, 2, 8, 24)
    with pytest.raises(RuntimeError, match="does not take"):  # head dim 24 not compiled
        flash_attention.launch(libs["flash_attention"], qf, qf, qf, torch.empty_like(qf),
                               plan=tdse.plan_flash(32, 4, H100), causal=True, q_offset=0,
                               device=0, stream=NULL_STREAM)
    with pytest.raises(RuntimeError, match="does not take"):
        matmul_q16.launch(libs["matmul_q16"], q, q.t().contiguous(), None,
                          torch.empty(4, 4, dtype=torch.int16), MatmulBlock(16, 64, 16),
                          relu=False, shift=40, bias_shift=0, raw_min=-1, raw_max=1,
                          device=0, stream=NULL_STREAM)
