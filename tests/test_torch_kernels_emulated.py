"""The CUDA kernels' own code, run on the CPU under an emulation of CUDA.

``tests/cuda_cpu_shim.h`` lets g++ compile ``src/repro_torch/kernels/csrc``
(every block in turn, each CUDA thread a std::thread).  The modules'
``launch`` functions then call the kernels' C entry points on CPU tensors,
exactly as the wrappers do on the card, and the results are held against
the plain versions: integers bit for bit, floats at 1e-4.  This checks the
kernels' indexing, tiling, masking, Cin chunks and epilogues at tiny shapes
here; it says nothing about speed, and the card runs the real build.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.core.quantization import Q2_6, Q2_14
from repro_torch.core.tiling import H100, MatmulBlock
from repro_torch.kernels import _build, conv2d, matmul_fp, matmul_q16

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
    x, w, b = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g), torch.randn(n, generator=g)
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
    q = torch.zeros(4, 8, dtype=torch.int16)
    with pytest.raises(RuntimeError, match="does not take"):
        matmul_q16.launch(libs["matmul_q16"], q, q.t().contiguous(), None,
                          torch.empty(4, 4, dtype=torch.int16), MatmulBlock(16, 64, 16),
                          relu=False, shift=40, bias_shift=0, raw_min=-1, raw_max=1,
                          device=0, stream=NULL_STREAM)
