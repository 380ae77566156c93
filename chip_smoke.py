#!/usr/bin/env python3
"""Drive the PyTorch port's CNN main path on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the run exits
non-zero without its result line):

1. the card: name, count, ``nvidia-smi`` name and power limit, versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. each kernel held against its plain version on the same inputs at the
   main path's shapes (floats at a stated tolerance, integers bit for bit),
   with its time, the plain version's, one PyTorch call's where there is
   one, and the least time the card could take (its bound);
3. the main path: ``plan_cnn`` -> ``cnn_forward`` for LeNet, AlexNet and
   VGG16 at full width, batch 8, random weights and biases from a seed
   (each hidden layer fitted onto the activation grid), in float,
   grid-resident Q2.14 and a forced int8/int16 mix, with every kernel's
   launch count set to 0 just before and read just after.  Float logits
   are held to the plain ``torch`` backend on the card; the fixed-point
   logits to the same engine on the CPU (the kernels' plain versions), bit
   for bit, and that run shows how few of each layer's raws are clipped;
4. the time, images/s and peak memory of one forward of each, and the
   device time by kernel of VGG16's forwards (``torch.profiler``).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds no ``src/repro_torch``, it exits with code 2 and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: float tolerances (atol = rtol), the reference's own (tests/test_kernels.py)
GEMM_TOL = 1e-4
CONV_TOL = 2e-3
#: end-to-end float logits, cuda kernels vs the torch backend on the card
E2E_TOL = 2e-3
#: H100 SXM dense peaks (NVIDIA data sheet, 700 W)
HBM_BW = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
BATCH = 8
SEED = 0
#: He-style weight scale: keeps the activations O(1) through VGG16's ReLU
#: stack (at the reference's default 0.5 its logits fall to ~4e-7, below the
#: Q2.14 grid's resolution, and the fixed-point checks would compare zeros)
INIT_SCALE = 2 ** 0.5
#: random biases, N(0, BIAS_STD^2), so the bias path carries non-zero values
BIAS_STD = 0.1
#: every hidden layer's float output on the input batch peaks here
#: (``fit_cnn_activations``): inside the activation grid that calibration
#: picks from an input in [-1, 1], so the grid-resident forward clips nothing
FIT_LIMIT = 0.5
#: most share of a grid-resident layer's output raws allowed at its bounds
MAX_CLIPPED_SHARE = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    res = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else res.stderr.strip()


def smi_clocks() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    res = subprocess.run([exe, "--query-gpu=clocks.sm,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() if res.returncode == 0 else res.stderr.strip()


def nvcc_version() -> str:
    from repro_torch.kernels._build import _nvcc

    res = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[-1]


def time_ms(fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over repeated calls, by CUDA events, after
    a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    reps = max(3, min(50, math.ceil(target_ms / est)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------


def phase_card(torch, dev):
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)  # loads, and binds every entry point
    regs = {}
    for name in _build.SOURCES:
        log = _build.build_log(name)
        used = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        regs[name] = {"kernels": len(used), "max_registers": max(used, default=None),
                      "spill_lines": spills[:4]}
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version(), "build_s": round(build_s, 3),
          "built": {k: round(v, 3) for k, v in built.items()}, "ptxas": regs})


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


class KernelBook:
    """Per-kernel record: worst error over its checks, and the timings of its
    representative main-path shape."""

    def __init__(self):
        self.rows = {}

    def check(self, kernel, case, got, want, *, exact, tol=None):
        import torch

        if exact:
            if got.dtype != want.dtype or not torch.equal(got, want):
                diff = (got.long() - want.long()).abs()
                raise AssertionError(f"{kernel} {case}: {int((diff > 0).sum())} integer "
                                     f"results differ (max {int(diff.max())})")
            err = 0.0
        else:
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                                       msg=lambda m: f"{kernel} {case}: {m}")
        row = self.rows.setdefault(kernel, {"max_abs_err": 0.0, "checks": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["checks"] += 1
        emit({"phase": "kernel_check", "kernel": kernel, "case": case,
              "max_abs_err": err, "exact": exact, "tol": tol})

    def timing(self, kernel, case, *, kernel_fn, plain_fn, library_fn, library,
               nbytes_, ops, peak, record=True):
        """Time one call of the kernel, its plain version and the library
        call on the same inputs; ``record`` makes it the kernel's row in the
        ``kernels`` line, else it is printed as an extra case."""
        b_ms, b_by = bound(nbytes_, ops, peak)
        row = {
            "shape": case,
            "ms": time_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "library": library,
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        if record:
            self.rows[kernel].update(row)
        emit({"phase": "kernel_time" if record else "kernel_time_extra",
              "kernel": kernel, **row})


def _gen(dev, seed):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def _randn(torch, shape, dev, seed, scale=1.0):
    return torch.randn(shape, device=dev, generator=_gen(dev, seed)) * scale


def _raws(torch, shape, dtype, dev, seed):
    lim = 127 if dtype == torch.int8 else 32767
    return torch.randint(-lim - 1, lim + 1, shape, device=dev, generator=_gen(dev, seed),
                         dtype=torch.int32).to(dtype)


def phase_kernels(torch, dev, book: KernelBook):
    import torch.nn.functional as F

    from repro_torch.core import dse
    from repro_torch.core.quantization import Q2_6, Q2_14
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import (conv2d_cuda, conv2d_plain, conv2d_q16_cuda,
                                            conv2d_q16_plain)
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain

    def conv_plan(n, h, cin, cout, k, s, p, in_bytes):
        ho = (h + 2 * p - k) // s + 1
        c = dse.default_conv_tile_for(h + 2 * p, h + 2 * p, cin, k, k, ho, ho, cout, s,
                                      H100, in_bytes)
        return c.tau, c.cin_chunk

    # -- float conv ----------------------------------------------------------
    float_convs = [
        # name, n, h, cin, cout, k, stride, pad, tiles (rows, cols, regime)
        ("vgg16.conv1", BATCH, 224, 64, 64, 3, 1, 1, None),
        ("vgg16.conv8", BATCH, 28, 512, 512, 3, 1, 1, None),
        ("alexnet.conv0", BATCH, 224, 3, 64, 11, 4, 2, None),
        ("lenet.conv0", BATCH, 32, 1, 6, 5, 1, 0, None),
        ("vgg16@512.conv1 dma(256x128)", BATCH, 512, 64, 64, 3, 1, 1, (256, 128, "dma")),
        ("vgg16.conv4 two_block(8)", BATCH, 56, 128, 256, 3, 1, 1, (8, 0, "two_block")),
    ]
    for i, (name, n, h, cin, cout, k, s, p, tiles) in enumerate(float_convs):
        x = _randn(torch, (n, h, h, cin), dev, 10 + i)
        w = _randn(torch, (k, k, cin, cout), dev, 20 + i, (k * k * cin) ** -0.5)
        b = _randn(torch, (cout,), dev, 30 + i, 0.1)
        tau, chunk = conv_plan(n, h, cin, cout, k, s, p, 4)
        tr, tc, hm = tiles or (0, 0, "none")
        kw = dict(stride=s, padding=p, tau=tau, cin_chunk=chunk, tile_rows=tr,
                  tile_cols=tc, halo_mode=hm, relu=True)
        got = conv2d_cuda(x, w, b, **kw)
        want = conv2d_plain(x, w, b, stride=s, padding=p, relu=True)
        torch.cuda.synchronize()
        book.check("conv2d", f"{name} tau={tau} chunk={chunk}", got, want, exact=False,
                   tol=CONV_TOL)
        if name == "vgg16.conv1" or tiles is not None and hm == "dma":
            ho = (h + 2 * p - k) // s + 1
            wn = w.permute(3, 2, 0, 1)
            book.timing(
                "conv2d", f"{name} x{tuple(x.shape)} w{tuple(w.shape)} tau={tau} chunk={chunk}",
                record=tiles is None,
                kernel_fn=lambda: conv2d_cuda(x, w, b, **kw),
                plain_fn=lambda: conv2d_plain(x, w, b, stride=s, padding=p, relu=True),
                library_fn=lambda: F.conv2d(x.permute(0, 3, 1, 2), wn, b, stride=s,
                                            padding=p),
                library="F.conv2d (cuDNN, TF32 off, channels_last input; no ReLU)",
                nbytes_=nbytes(x, w, b) + n * ho * ho * cout * 4,
                ops=2 * n * ho * ho * cout * k * k * cin, peak=PEAK_F32)
        del x, w, got, want

    # -- float GEMM ----------------------------------------------------------
    gemms = [
        ("vgg16.fc0", BATCH, 25088, 4096),
        ("vgg16.fc2", BATCH, 4096, 1000),
        ("lenet.fc0", BATCH, 400, 120),
    ]
    for i, (name, m, k, n) in enumerate(gemms):
        x = _randn(torch, (m, k), dev, 40 + i)
        w = _randn(torch, (k, n), dev, 50 + i, k ** -0.5)
        b = _randn(torch, (n,), dev, 60 + i, 0.1)
        blk = dse.default_block_for(m, n, k, H100)
        got = matmul_fp_cuda(x, w, b, block=blk, relu=True)
        want = matmul_fp_plain(x, w, b, relu=True)
        torch.cuda.synchronize()
        book.check("matmul_fp", f"{name} ({m},{k})@({k},{n}) block={blk.bm}x{blk.bn}",
                   got, want, exact=False, tol=GEMM_TOL)
        if name == "vgg16.fc0":
            book.timing(
                "matmul_fp", f"{name} ({m},{k})@({k},{n}) block={blk.bm}x{blk.bn}x{blk.bk}",
                kernel_fn=lambda: matmul_fp_cuda(x, w, b, block=blk, relu=True),
                plain_fn=lambda: matmul_fp_plain(x, w, b, relu=True),
                library_fn=lambda: torch.relu(torch.addmm(b, x, w)),
                library="torch.relu(torch.addmm(b, x, w)) (cuBLAS, TF32 off)",
                nbytes_=nbytes(x, w, b) + m * n * 4, ops=2 * m * n * k, peak=PEAK_F32)
        del x, w
    # the forced im2col route: im2col + the float GEMM kernel
    x = _randn(torch, (BATCH, 28, 28, 512), dev, 70)
    w = _randn(torch, (3, 3, 512, 512), dev, 71, 4608 ** -0.5)
    blk = dse.default_block_for(BATCH * 28 * 28, 512, 4608, H100)
    got = ops.conv2d(x, w, padding=1, relu=True, route="im2col", block=blk)
    want = conv2d_plain(x, w, padding=1, relu=True)
    torch.cuda.synchronize()
    book.check("matmul_fp", f"im2col route vgg16.conv8 block={blk.bm}x{blk.bn}", got, want,
               exact=False, tol=CONV_TOL)
    del x, w, got, want

    # -- fixed-point conv ----------------------------------------------------
    q_convs = [
        # name, n, h, cin, cout, k, s, p, x dtype, w dtype, out fmt, shift, tiles
        ("vgg16.conv1 Q2.14", BATCH, 224, 64, 64, 3, 1, 1, torch.int16, torch.int16,
         Q2_14, 16, None),
        ("vgg16.conv8 int8->int16", BATCH, 28, 512, 512, 3, 1, 1, torch.int8, torch.int8,
         Q2_14, 1, None),
        ("alexnet.conv0 int16->int8", BATCH, 224, 3, 64, 11, 4, 2, torch.int16,
         torch.int16, Q2_6, 24, None),
        ("lenet.conv0 Q2.14", BATCH, 32, 1, 6, 5, 1, 0, torch.int16, torch.int16, Q2_14,
         15, None),
        ("vgg16@512.conv1 dma(256x128)", BATCH, 512, 64, 64, 3, 1, 1, torch.int16,
         torch.int16, Q2_14, 16, (256, 128, "dma")),
        ("vgg16.conv4 two_block(8)", BATCH, 56, 128, 256, 3, 1, 1, torch.int16,
         torch.int16, Q2_14, 17, (8, 0, "two_block")),
    ]
    for i, (name, n, h, cin, cout, k, s, p, xd, wd, fmt, shift, tiles) in enumerate(q_convs):
        x = _raws(torch, (n, h, h, cin), xd, dev, 80 + i)
        w = _raws(torch, (k, k, cin, cout), wd, dev, 90 + i)
        b = _raws(torch, (cout,), xd, dev, 100 + i)
        tau, chunk = conv_plan(n, h, cin, cout, k, s, p, 2)
        tr, tc, hm = tiles or (0, 0, "none")
        kw = dict(stride=s, padding=p, tau=tau, cin_chunk=chunk, tile_rows=tr,
                  tile_cols=tc, halo_mode=hm, relu=True, fmt=fmt, shift=shift,
                  bias_shift=3)
        got = conv2d_q16_cuda(x, w, b, **kw)
        pkw = dict(stride=s, padding=p, shift=shift, bias_shift=3, raw_min=fmt.raw_min,
                   raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype, relu=True)
        want = conv2d_q16_plain(x, w, b, **pkw)
        torch.cuda.synchronize()
        book.check("conv2d_q16", f"{name} tau={tau} chunk={chunk}", got, want, exact=True)
        if name == "vgg16.conv1 Q2.14" or tiles is not None and hm == "dma":
            ho = (h + 2 * p - k) // s + 1
            book.timing(
                "conv2d_q16", f"{name} x{tuple(x.shape)} int16 tau={tau} chunk={chunk}",
                record=tiles is None,
                kernel_fn=lambda: conv2d_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: conv2d_q16_plain(x, w, b, **pkw),
                library_fn=None,
                library="none: no PyTorch call convolves int16 on CUDA",
                nbytes_=nbytes(x, w, b) + n * ho * ho * cout * 2,
                ops=2 * n * ho * ho * cout * k * k * cin, peak=PEAK_INT8 / 4)
        del x, w, got, want

    # -- fixed-point GEMM ----------------------------------------------------
    q_gemms = [
        # name, m, k, n, x dtype, w dtype, out fmt, shift, wide
        ("vgg16.fc0 Q2.14", BATCH, 25088, 4096, torch.int16, torch.int16, Q2_14, 16, False),
        ("vgg16.fc1 int8->int16", BATCH, 4096, 4096, torch.int8, torch.int8, Q2_14, 1, False),
        ("vgg16.fc1 int16->int8", BATCH, 4096, 4096, torch.int16, torch.int16, Q2_6, 24,
         False),
        ("vgg16.fc2 wide", BATCH, 4096, 1000, torch.int16, torch.int16, Q2_14, 0, True),
        ("im2col vgg16.conv8 int8xint8", BATCH * 28 * 28, 4608, 512, torch.int8,
         torch.int8, Q2_6, 9, False),
    ]
    for i, (name, m, k, n, xd, wd, fmt, shift, wide) in enumerate(q_gemms):
        x = _raws(torch, (m, k), xd, dev, 110 + i)
        w = _raws(torch, (k, n), wd, dev, 120 + i)
        b = _raws(torch, (n,), xd, dev, 130 + i)
        blk = dse.default_block_for(m, n, k, H100)
        kw = dict(fmt=fmt, block=blk, relu=not wide, shift=shift, bias_shift=3, wide=wide)
        got = matmul_q16_cuda(x, w, b, **kw)
        pkw = dict(shift=shift, bias_shift=3, raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                   out_dtype=torch.int32 if wide else fmt.storage_dtype, relu=not wide,
                   wide=wide)
        want = matmul_q16_plain(x, w, b, **pkw)
        torch.cuda.synchronize()
        book.check("matmul_q16", f"{name} ({m},{k})@({k},{n}) block={blk.bm}x{blk.bn}",
                   got, want, exact=True)
        if name == "vgg16.fc0 Q2.14":
            book.timing(
                "matmul_q16", f"{name} ({m},{k})@({k},{n}) int16 block={blk.bm}x{blk.bn}x{blk.bk}",
                kernel_fn=lambda: matmul_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: matmul_q16_plain(x, w, b, **pkw),
                library_fn=None,
                library="none: no PyTorch call multiplies int16 matrices on CUDA",
                nbytes_=nbytes(x, w, b) + m * n * 2, ops=2 * m * n * k,
                peak=PEAK_INT8 / 4)
        if name.endswith("int8xint8"):
            # torch._int_mm (int8 x int8 -> int32) fits this shape (m > 16,
            # k and n multiples of 8): timed beside the kernel, never used by it
            book.timing(
                "matmul_q16", f"{name} ({m},{k})@({k},{n}) block={blk.bm}x{blk.bn}x{blk.bk}",
                kernel_fn=lambda: matmul_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: matmul_q16_plain(x, w, b, **pkw),
                library_fn=lambda: torch._int_mm(x, w),
                library="torch._int_mm (no epilogue)",
                nbytes_=nbytes(x, w, b) + m * n, ops=2 * m * n * k, peak=PEAK_INT8,
                record=False)
        del x, w, got, want


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

MIXED = {
    "lenet": ("conv0", "fc0", "fc2"),
    "alexnet": ("conv0", "conv3", "fc1"),
    "vgg16": ("conv0", "conv5", "fc1"),
}


def _to(tree, dev):
    from repro_torch.core.quantization import QTensor

    def leaf(v):
        return QTensor(v.raw.to(dev), v.fmt) if isinstance(v, QTensor) else v.to(dev)

    return {g: [{k: leaf(v) for k, v in layer.items()} for layer in tree[g]]
            for g in ("convs", "fcs")}


def clip_probe(eng, fn):
    """Runs ``fn`` with the engine's ``conv2d`` / ``linear`` wrapped and
    returns (its result, per grid-resident layer the share of output raws
    at the bounds of the layer's rung)."""
    from repro_torch.core.quantization import QTensor

    shares = []
    for meth in ("conv2d", "linear"):
        def probe(*a, _orig=getattr(eng, meth), **kw):
            out = _orig(*a, **kw)
            if isinstance(out, QTensor):
                r, f = out.raw, out.fmt
                shares.append(float(((r == f.raw_max) | (r == f.raw_min)).float().mean()))
            return out

        setattr(eng, meth, probe)
    try:
        return fn(), shares
    finally:
        del eng.conv2d, eng.linear


def random_net(torch, dev, spec, x):
    """He-scale weights and random biases from the seed, each hidden layer
    fitted onto the activation grid on ``x``."""
    from repro_torch.core.template import default_template
    from repro_torch.models import cnn

    params = cnn.init_cnn(torch.Generator().manual_seed(SEED), spec, scale=INIT_SCALE,
                          device=dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    for layer in params["convs"] + params["fcs"]:
        layer["b"] = (BIAS_STD * torch.randn(layer["b"].shape, generator=gen)).to(dev)
    return cnn.fit_cnn_activations(default_template("torch"), spec, params, x,
                                   limit=FIT_LIMIT)


def phase_main_path(torch, dev):
    """Returns per-(net, numerics) state for the timing phase."""
    from repro_torch.core.quantization import int8_rung
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.models import cnn

    runs = []
    _build.reset_launches()
    for net in ("lenet", "alexnet", "vgg16"):
        spec = cnn.CNN_ZOO[net]
        x = (torch.rand((BATCH, spec.input_hw, spec.input_hw, spec.input_ch),
                        device=dev, generator=_gen(dev, SEED + 1)) * 2 - 1)
        params = random_net(torch, dev, spec, x)
        nc, nf = len(spec.convs), len(spec.fcs) + 1

        # float: the CUDA kernels against the plain torch backend, on the card
        tpl = default_template("cuda")
        before = dict(_build.launches)
        plan = cnn.plan_cnn(tpl, spec, tuple(x.shape))
        y = cnn.cnn_forward(tpl, spec, params, x, plan=plan)
        torch.cuda.synchronize()
        assert _build.launches["conv2d"] - before["conv2d"] == nc
        assert _build.launches["matmul_fp"] - before["matmul_fp"] == nf
        y_ref = cnn.cnn_forward(default_template("torch"), spec, params, x)
        assert y.shape == (BATCH, spec.n_classes) and bool(torch.isfinite(y).all())
        err = float((y - y_ref).abs().max())
        torch.testing.assert_close(y, y_ref, atol=E2E_TOL, rtol=E2E_TOL)
        with tpl.engine.plan_cache.scope() as warm:
            cnn.cnn_forward(tpl, spec, params, x)
        assert warm["misses"] == 0
        emit({"phase": "forward", "net": net, "numerics": "float", "batch": BATCH,
              "plan": plan.describe(), "max_abs_err_vs_torch_backend": err,
              "tol": E2E_TOL, "logit_absmax": float(y_ref.abs().max())})
        runs.append((net, "float", tpl, spec, params, x, None))
        y_float = y_ref

        # grid-resident Q2.14 and the forced mix, held to the CPU engine
        tq = default_template("q16")
        pol = cnn.calibrate_cnn_policy(tq, spec, params, x)
        low = int8_rung(pol.fmt)
        mixed = dataclasses.replace(pol, name="mixed", layer_fmts=tuple(
            sorted((layer, low) for layer in MIXED[net])))
        tcpu = default_template("q16", device="cpu")
        for numerics, policy in (("grid " + pol.fmt.name, pol), ("mixed", mixed)):
            qp = cnn.quantize_cnn_params(tq, spec, params, policy)
            tq.engine.counters.clear()
            before = dict(_build.launches)
            y = cnn.cnn_forward(tq, spec, qp, x, policy=policy)
            torch.cuda.synchronize()
            c = tq.engine.counters
            law = {"quantize_calls": c["quantize_calls"],
                   "dequantize_calls": c["dequantize_calls"]}
            assert law == {"quantize_calls": 1, "dequantize_calls": 1}, dict(c)
            assert _build.launches["conv2d_q16"] - before["conv2d_q16"] == nc
            assert _build.launches["matmul_q16"] - before["matmul_q16"] == nf
            with tq.engine.plan_cache.scope() as warm:
                y2 = cnn.cnn_forward(tq, spec, qp, x, policy=policy)
            assert warm["misses"] == 0 and torch.equal(y, y2)
            t0 = time.perf_counter()
            y_cpu, clipped = clip_probe(tcpu.engine, lambda: cnn.cnn_forward(
                tcpu, spec, _to(qp, "cpu"), x.cpu(), policy=policy))
            cpu_s = time.perf_counter() - t0
            assert len(clipped) == nc + nf - 1, clipped
            if max(clipped) > MAX_CLIPPED_SHARE:
                raise AssertionError(f"{net} {numerics}: grid-resident layers clip "
                                     f"{clipped} of their raws")
            if not torch.equal(y.cpu(), y_cpu):
                raise AssertionError(
                    f"{net} {numerics}: logits differ from the plain q16 path "
                    f"(max {float((y.cpu() - y_cpu).abs().max())})")
            emit({"phase": "forward", "net": net, "numerics": numerics, "batch": BATCH,
                  "policy": {"fmt": policy.fmt.name,
                             "layer_fmts": {k: v.name for k, v in policy.layer_fmts}},
                  "bit_identical_to_plain_q16_path": True, "plain_path_cpu_s": cpu_s,
                  "clipped_share_by_layer": clipped,
                  "argmax_agreement_vs_float": float(
                      (y.argmax(-1) == y_float.argmax(-1)).float().mean()),
                  "max_abs_diff_vs_float": float((y - y_float).abs().max()),
                  "island_law": law,
                  "int8_weights": sum(int(qp[g][i]["w"].raw.dtype == torch.int8)
                                      for g in ("convs", "fcs")
                                      for i in range(len(qp[g])))})
            runs.append((net, numerics, tq, spec, qp, x, policy))
    launches = dict(_build.launches)
    emit({"phase": "main_path_launches", **launches})
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return runs, launches


def phase_timing(torch, runs):
    from repro_torch.models import cnn

    emit({"phase": "clocks_before_timing", "nvidia_smi": smi_clocks()})
    for net, numerics, tpl, spec, params, x, policy in runs:
        fwd = (lambda: cnn.cnn_forward(tpl, spec, params, x, policy=policy))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fwd, target_ms=300.0)
        peak = torch.cuda.max_memory_allocated()
        # peak_mem_bytes counts every tensor alive (all nets' weights and
        # inputs); forward_peak_bytes only what one forward adds on top
        emit({"phase": "forward_time", "net": net, "numerics": numerics, "batch": BATCH,
              "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
              "peak_mem_bytes": peak, "forward_peak_bytes": peak - resident})
    emit({"phase": "clocks_after_timing", "nvidia_smi": smi_clocks()})


def phase_profile(torch, runs):
    """Device time by kernel over three VGG16 forwards of each numerics
    (torch.profiler's CUDA events), and the device's busy share of the
    window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import cnn

    for net, numerics, tpl, spec, params, x, policy in runs:
        if net != "vgg16":
            continue
        fwd = (lambda: cnn.cnn_forward(tpl, spec, params, x, policy=policy))
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fwd()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                name = ev.name.split("(")[0][:90]
                us, n = by_name.get(name, (0.0, 0))
                by_name[name] = (us + ev.time_range.elapsed_us(), n + 1)
        busy = sum(us for us, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        emit({"phase": "profile", "net": net, "numerics": numerics, "forwards": 3,
              "wall_ms": wall_us / 1e3,
              "device_busy_ms": busy / 1e3 if by_name else "not measured",
              "device_busy_share": busy / wall_us if by_name else "not measured",
              "top_kernels": [{"name": k, "ms": us / 1e3, "calls": n}
                              for k, (us, n) in top]})


KERNEL_META = {
    "matmul_fp": ("src/repro_torch/kernels/csrc/matmul_fp.cu",
                  "src/repro/kernels/matmul_fp.py:76"),
    "matmul_q16": ("src/repro_torch/kernels/csrc/matmul_q16.cu",
                   "src/repro/kernels/matmul_q16.py:71"),
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:329"),
    "conv2d_q16": ("src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:437"),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; the port's kernels "
              "need an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_card(torch, dev)
    book = KernelBook()
    phase_kernels(torch, dev, book)
    torch.cuda.empty_cache()
    runs, launches = phase_main_path(torch, dev)
    phase_timing(torch, runs)
    phase_profile(torch, runs)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = book.rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "shape": row["shape"], "checks": row["checks"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
