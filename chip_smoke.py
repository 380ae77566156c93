#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the run exits
non-zero without its result line):

1. the card: name, count, ``nvidia-smi`` name and power limit, versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
2. each kernel held against its plain version on the same inputs at the
   main paths' shapes (floats at a stated tolerance, integers bit for bit),
   with its time, the plain version's, one PyTorch call's where there is
   one, and the least time the card could take (its bound).  The float
   GEMM is checked at every distinct float GEMM shape of both main paths on
   the route its plan names (wgmma, splitk; tile for the im2col route),
   bit for bit repeatable, and timed on gate / up (beside its route "tile"
   on the same call, the design that served it before), fc0 and the tied
   head;
3. the CNN path: ``plan_cnn`` -> ``cnn_forward`` for LeNet, AlexNet and
   VGG16 at full width, batch 8, random weights and biases from a seed
   (each hidden layer fitted onto the activation grid), in float,
   grid-resident Q2.14 and a forced int8/int16 mix, with every kernel's
   launch count set to 0 just before and read just after.  Float logits
   are held to the plain ``torch`` backend on the card; the fixed-point
   logits to the same engine on the CPU (the kernels' plain versions), bit
   for bit, and that run shows how few of each layer's raws are clipped;
4. the time, images/s and peak memory of one forward of each, and the
   device time by kernel of VGG16's forwards (``torch.profiler``);
5. the serving path: ``launch/serve.py:generate`` on qwen2-0.5b at full
   width and depth (bf16, random weights from the seed), 4 prompts of 4096
   tokens then 16 greedy tokens, in float on the ``cuda`` backend and
   grid-resident after ``calibrate_policy``, each with the launch counts set
   to 0 just before and read just after (the float GEMM's per route: every
   prefill GEMM on wgmma, every m = 4 GEMM on splitk, none on the q16
   GEMM).  Each stream is replayed teacher-forced through the same kernels
   and through the plain ``torch`` backend (float), and the logits are held
   to stated tolerances; the
   grid-resident replay shows each layer's share of raws at the grid's
   bounds and the island counts.  Then prefill tokens/s, decode ms/step,
   peak memory, device time by kernel (``torch.profiler``), and one run of
   ``serve.main`` at the reference's reduced CLI size.

``--gemm-route-study`` adds the float GEMM's design measurements, off by
default: route "tile" timed beside fc0 and the tied head, and the
``wgmma_threshold`` lines (gate / up's n and k at m from 17 to 256 and at
the prefill's m, each wgmma tile against the tile route), which set the
planner's bound between routes W and L.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds no ``src/repro_torch``, it exits with code 2 and
prints no result.
"""
from __future__ import annotations

import argparse
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
#: ``--gemm-route-study``: time the float GEMM's design alternatives too
ROUTE_STUDY = False
GEMM_TOL_BF16 = 2e-2
CONV_TOL = 2e-3
#: end-to-end float logits, cuda kernels vs the torch backend on the card
E2E_TOL = 2e-3
#: H100 SXM dense peaks (NVIDIA data sheet, 700 W)
HBM_BW = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
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
#: flash attention against its plain version: the reference's 2e-3 in f32
#: (tests/test_kernels.py); bf16 outputs to one bf16 step
FA_TOL = 2e-3
FA_TOL_BF16 = 2 ** -7
#: the serving main path: qwen2-0.5b, 4 prompts of 4096 tokens, 16 generated
QWEN_ARCH = "qwen2-0.5b"
QWEN_PROMPTS = 4
QWEN_PROMPT_LEN = 4096
QWEN_GEN = 16
#: random QKV biases and norm scales, N(0, 0.1²), so both carry values
QWEN_PARAM_STD = 0.1
#: teacher-forced logits against the plain torch backend (float) on the same
#: stream: max |Δ| / max |logit|, and the least argmax agreement; wherever
#: the plain path's top-2 margin exceeds 2·max |Δ| the argmax must agree
FLOAT_REL_TOL = 0.05
FLOAT_ARGMAX = 0.75
Q16_REL_TOL = 0.25
Q16_ARGMAX = 0.5


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
        warnings = [line.strip() for line in log.splitlines() if "arning" in line]
        regs[name] = {"kernels": len(used), "max_registers": max(used, default=None),
                      "spill_lines": spills[:4], "warnings": warnings[:4]}
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
    representative main-path shape.  The float GEMM keeps one record per
    route (``matmul_fp.<route>``)."""

    def __init__(self):
        self.rows = {}

    def check(self, kernel, case, got, want, *, exact, tol=None):
        """``kernel``: a kernel's name, or ``matmul_fp.<route>``."""
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
               nbytes_, ops, peak, record=True, tile_fn=None):
        """Time one call of the kernel, its plain version and the library
        call on the same inputs; ``record`` makes it the kernel's row in the
        ``kernels`` line, else it is printed as an extra case.  ``tile_fn``:
        the float GEMM's route "tile" on the same call (the block-tiled
        CUDA-core kernel that served every float GEMM before the routes)."""
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
        if tile_fn is not None:
            row["route_tile_ms"] = time_ms(tile_fn)
        if record:
            self.rows[kernel].update(row)
        emit({"phase": "kernel_time" if record else "kernel_time_extra",
              "kernel": kernel, **row})


def _plan(blk) -> str:
    """A float GEMM plan in a case name: route, tile and slices."""
    out = f"route={blk.route} block={blk.bm}x{blk.bn}x{blk.bk}"
    return out + (f" splits={blk.splits}" if blk.splits > 1 else "")


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
    from repro_torch.core.template import default_template
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import (conv2d_cuda, conv2d_plain, conv2d_q16_cuda,
                                            conv2d_q16_plain)
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
    from repro_torch.models import cnn

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

    # -- float GEMM: every FC shape of the CNN path, on the plan it runs ----
    fcs = {}
    for net in ("lenet", "alexnet", "vgg16"):
        spec = cnn.CNN_ZOO[net]
        plan = cnn.plan_cnn(default_template("cuda"), spec,
                            (BATCH, spec.input_hw, spec.input_hw, spec.input_ch))
        for j, gp in enumerate(plan.fcs):
            fcs.setdefault((gp.m, gp.k, gp.n), (f"{net}.fc{j}", gp.block))
    for i, ((m, k, n), (name, blk)) in enumerate(fcs.items()):
        x = _randn(torch, (m, k), dev, 40 + i)
        w = _randn(torch, (k, n), dev, 50 + i, k ** -0.5)
        b = _randn(torch, (n,), dev, 60 + i, 0.1)
        assert blk.route == "splitk", (name, blk)
        got = matmul_fp_cuda(x, w, b, block=blk, relu=True)
        again = matmul_fp_cuda(x, w, b, block=blk, relu=True)
        want = matmul_fp_plain(x, w, b, relu=True)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: route {blk.route} not repeatable"
        book.check(f"matmul_fp.{blk.route}", f"{name} ({m},{k})@({k},{n}) {_plan(blk)}",
                   got, want, exact=False, tol=GEMM_TOL)
        if name == "vgg16.fc0":
            tile = dse.default_block_for(m, n, k, H100)
            book.timing(
                "matmul_fp.splitk", f"{name} ({m},{k})@({k},{n}) f32 {_plan(blk)}",
                kernel_fn=lambda: matmul_fp_cuda(x, w, b, block=blk, relu=True),
                plain_fn=lambda: matmul_fp_plain(x, w, b, relu=True),
                library_fn=lambda: torch.relu(torch.addmm(b, x, w)),
                library="torch.relu(torch.addmm(b, x, w)) (cuBLAS, TF32 off)",
                nbytes_=nbytes(x, w, b) + m * n * 4, ops=2 * m * n * k, peak=PEAK_F32,
                tile_fn=(lambda: matmul_fp_cuda(x, w, b, block=tile, relu=True))
                if ROUTE_STUDY else None)
        del x, w
    # the forced im2col route: im2col + the float GEMM kernel, route "tile"
    x = _randn(torch, (BATCH, 28, 28, 512), dev, 70)
    w = _randn(torch, (3, 3, 512, 512), dev, 71, 4608 ** -0.5)
    blk = dse.default_fp_block_for(BATCH * 28 * 28, 512, 4608, H100, dtype_bytes=4)
    assert blk.route == "tile", blk
    got = ops.conv2d(x, w, padding=1, relu=True, route="im2col", block=blk)
    want = conv2d_plain(x, w, padding=1, relu=True)
    torch.cuda.synchronize()
    book.check("matmul_fp.tile", f"im2col route vgg16.conv8 {_plan(blk)}", got, want,
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
        # every FC layer (batch 8) streams its weights on the split-k route
        assert _build.launches["matmul_fp.splitk"] - before["matmul_fp.splitk"] == nf
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
            assert _build.launches["matmul_fp"] == before["matmul_fp"]
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
    emit({"phase": "main_path_launches", "path": "cnn", **launches})
    for name in ("matmul_fp", "matmul_q16", "conv2d", "conv2d_q16"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the CNN path")
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
    from repro_torch.models import cnn

    for net, numerics, tpl, spec, params, x, policy in runs:
        if net != "vgg16":
            continue
        fwd = (lambda: cnn.cnn_forward(tpl, spec, params, x, policy=policy))
        fwd()
        torch.cuda.synchronize()
        emit({"phase": "profile", "net": net, "numerics": numerics, "forwards": 3,
              **profile_window(torch, lambda: [fwd() for _ in range(3)],
                               groups=("conv", "splitk", "gemm_kernel"))})


# ---------------------------------------------------------------------------
# phase 2, serving kernels: flash attention and the tied head's GEMM
# ---------------------------------------------------------------------------


def causal_pairs(sq: int, sk: int, q_offset: int) -> int:
    """(row, col) pairs with col <= q_offset + row, col < sk."""
    return sum(min(sk, q_offset + r + 1) for r in range(sq))


def phase_kernels_serving(torch, dev, book: KernelBook):
    import torch.nn.functional as F

    from repro_torch.core import dse
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain, plan_for
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain

    fa_cases = [
        # name, b, hq, hkv, sq, sk, d, causal, q_offset, dtype, block
        ("MHA", 1, 4, 4, 64, 64, 32, True, 0, torch.float32, 32),
        ("GQA", 2, 8, 2, 64, 64, 32, True, 0, torch.float32, 32),
        ("MQA", 1, 4, 1, 128, 128, 64, True, 0, torch.float32, 32),
        ("non-causal", 2, 4, 4, 64, 64, 32, False, 0, torch.float32, 32),
        ("ragged Sq=96", 1, 2, 2, 96, 96, 32, True, 0, torch.float32, 32),
        ("q_offset=48", 1, 2, 2, 16, 64, 32, True, 48, torch.float32, 16),
        ("bf16 GQA", 2, 16, 2, 300, 300, 64, True, 0, torch.bfloat16, 256),
        ("qwen2-0.5b prefill", QWEN_PROMPTS, 16, 2, QWEN_PROMPT_LEN, QWEN_PROMPT_LEN, 64,
         True, 0, torch.float32, 1024),
    ]
    for i, (name, b, hq, hkv, sq, sk, d, causal, q_offset, dtype, blk) in enumerate(fa_cases):
        # the model's layout: (B, S, H, D) memory, viewed as (B, H, S, D)
        q = _randn(torch, (b, sq, hq, d), dev, 140 + i, 0.5).to(dtype).transpose(1, 2)
        k = _randn(torch, (b, sk, hkv, d), dev, 150 + i, 0.5).to(dtype).transpose(1, 2)
        v = _randn(torch, (b, sk, hkv, d), dev, 160 + i, 0.5).to(dtype).transpose(1, 2)
        kw = dict(causal=causal, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw)
        want = flash_attention_plain(q, k, v, bk=blk, **kw)
        torch.cuda.synchronize()
        tol = FA_TOL if dtype == torch.float32 else FA_TOL_BF16
        book.check("flash_attention", f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} "
                   f"{str(dtype)[6:]}", got, want, exact=False, tol=tol)
        if name.startswith("qwen2"):
            g = hq // hkv
            qc = q.contiguous()  # the library call gets dense, expanded heads
            ke = k.repeat_interleave(g, dim=1).contiguous()
            ve = v.repeat_interleave(g, dim=1).contiguous()
            out_bytes = nbytes(q)
            book.timing(
                "flash_attention",
                f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} f32 causal",
                kernel_fn=lambda: ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw),
                plain_fn=lambda: flash_attention_plain(q, k, v, bk=blk, **kw),
                library_fn=lambda: F.scaled_dot_product_attention(qc, ke, ve, is_causal=True),
                library="F.scaled_dot_product_attention (f32, kv heads expanded, is_causal)",
                nbytes_=nbytes(q, k, v) + out_bytes,
                ops=4 * d * b * hq * causal_pairs(sq, sk, q_offset), peak=PEAK_F32)
            del qc, ke, ve
        del q, k, v, got, want

    # the tied LM head reads the (vocab, d) table in place (transposed B)
    vocab, dm = 151936, 896
    for dtype, tol in ((torch.float32, GEMM_TOL), (torch.bfloat16, FA_TOL_BF16)):
        x = _randn(torch, (QWEN_PROMPTS, dm), dev, 170).to(dtype)
        table = _randn(torch, (vocab, dm), dev, 171, dm ** -0.5).to(dtype)
        blk = plan_for(x, table.T)
        assert blk.route == "splitk", blk
        got = matmul_fp_cuda(x, table.T, block=blk)
        again = matmul_fp_cuda(x, table.T, block=blk)
        want = matmul_fp_plain(x, table.T)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "tied head: route splitk not repeatable"
        book.check("matmul_fp.splitk", f"tied head ({QWEN_PROMPTS},{dm})@embed.T({dm},"
                   f"{vocab}) {str(dtype)[6:]} {_plan(blk)}", got, want, exact=False,
                   tol=tol)
        if dtype == torch.bfloat16:
            tile = dse.default_block_for(QWEN_PROMPTS, vocab, dm, H100)
            book.timing(
                "matmul_fp.splitk", f"tied head ({QWEN_PROMPTS},{dm})@embed.T bf16 "
                f"{_plan(blk)}", record=False,
                kernel_fn=lambda: matmul_fp_cuda(x, table.T, block=blk),
                plain_fn=lambda: matmul_fp_plain(x, table.T),
                library_fn=lambda: torch.matmul(x, table.T),
                library="torch.matmul(x, embed.T) (cuBLAS, bf16)",
                nbytes_=nbytes(x, table) + QWEN_PROMPTS * vocab * 2,
                ops=2 * QWEN_PROMPTS * vocab * dm, peak=PEAK_BF16,
                tile_fn=(lambda: matmul_fp_cuda(x, table.T, block=tile))
                if ROUTE_STUDY else None)
        del x, table, got, again, want

    # every distinct GEMM of a qwen2 layer, at prefill (m = 4 x 4096) and at
    # decode (m = 4), on the planner's route: wgmma and splitk
    m_prefill = QWEN_PROMPTS * QWEN_PROMPT_LEN
    layer = [("q", 1024, dm), ("k/v", 128, dm), ("o", dm, 1024), ("gate/up", 4864, dm),
             ("down", dm, 4864)]
    for j, (name, n, k) in enumerate(layer):
        w = _randn(torch, (k, n), dev, 180 + j, k ** -0.5).to(torch.bfloat16)
        b = _randn(torch, (n,), dev, 190 + j, 0.1)
        for m, route in ((m_prefill, "wgmma"), (QWEN_PROMPTS, "splitk")):
            x = _randn(torch, (m, k), dev, 200 + j).to(torch.bfloat16)
            blk = plan_for(x, w)
            assert blk.route == route, (name, m, blk)
            got = matmul_fp_cuda(x, w, b, block=blk)
            again = matmul_fp_cuda(x, w, b, block=blk)
            want = matmul_fp_plain(x, w, b)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"qwen2 {name} m={m}: route {route} not repeatable"
            book.check(f"matmul_fp.{route}", f"qwen2 {name} ({m},{k})@({k},{n}) bf16 "
                       f"{_plan(blk)}", got, want, exact=False, tol=GEMM_TOL_BF16)
            if name == "gate/up":
                tile = dse.default_block_for(m, n, k, H100)
                book.timing(
                    f"matmul_fp.{route}",
                    f"qwen2 gate/up ({m},{k})@({k},{n}) bf16 {_plan(blk)}",
                    record=route == "wgmma",
                    kernel_fn=lambda: matmul_fp_cuda(x, w, block=blk),
                    plain_fn=lambda: matmul_fp_plain(x, w),
                    library_fn=lambda: torch.matmul(x, w),
                    library="torch.matmul (cuBLAS, bf16)", nbytes_=nbytes(x, w) + m * n * 2,
                    ops=2 * m * n * k, peak=PEAK_BF16,
                    tile_fn=(lambda: matmul_fp_cuda(x, w, block=tile))
                    if route == "wgmma" or ROUTE_STUDY else None)
            del x, got, again, want
        del w, b

    # the prefill's widest GEMM in int16 (the q16 kernel, unchanged)
    m, k, n = m_prefill, dm, 4864
    blk = dse.default_block_for(m, n, k, H100)
    xq = _raws(torch, (m, k), torch.int16, dev, 174)
    wq = _raws(torch, (k, n), torch.int16, dev, 175)
    qkw = dict(block=blk, shift=20, bias_shift=0)
    pkw = dict(shift=20, bias_shift=0, raw_min=-32768, raw_max=32767, out_dtype=torch.int16)
    got = matmul_q16_cuda(xq, wq, **qkw)
    want = matmul_q16_plain(xq, wq, **pkw)
    torch.cuda.synchronize()
    book.check("matmul_q16", f"qwen2 gate/up ({m},{k})@({k},{n}) int16", got, want,
               exact=True)
    book.timing(
        "matmul_q16", f"qwen2 gate/up ({m},{k})@({k},{n}) int16 block={blk.bm}x{blk.bn}x{blk.bk}",
        record=False, kernel_fn=lambda: matmul_q16_cuda(xq, wq, **qkw),
        plain_fn=lambda: matmul_q16_plain(xq, wq, **pkw), library_fn=None,
        library="none: no PyTorch call multiplies int16 matrices on CUDA",
        nbytes_=nbytes(xq, wq) + m * n * 2, ops=2 * m * n * k, peak=PEAK_INT8 / 4)
    del xq, wq, got, want


def phase_wgmma_threshold(torch, dev):
    """``--gemm-route-study``: where route W starts to beat route L on bf16,
    on gate / up's n and k at small m (the planner sends m <= 16 to split-k
    and every larger m to W), and at the full prefill m the two compiled
    wgmma tiles side by side."""
    from repro_torch.core import dse
    from repro_torch.core.tiling import H100, MatmulBlock
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, plan_for

    n, k = 4864, 896
    w = _randn(torch, (k, n), dev, 210, k ** -0.5).to(torch.bfloat16)
    for m in (17, 32, 64, 128, 256, QWEN_PROMPTS * QWEN_PROMPT_LEN):
        x = _randn(torch, (m, k), dev, 211).to(torch.bfloat16)
        wg, wg256 = (MatmulBlock(128, bn, 64, route="wgmma") for bn in (128, 256))
        tile = dse.default_block_for(m, n, k, H100)
        emit({"phase": "wgmma_threshold", "m": m, "n": n, "k": k,
              "wgmma_128x128_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=wg)),
              "wgmma_128x256_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=wg256)),
              "tile_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=tile)),
              "tile": _plan(tile), "planned": _plan(plan_for(x, w))})
        del x
    del w


# ---------------------------------------------------------------------------
# phase 5: the serving path (qwen2-0.5b)
# ---------------------------------------------------------------------------


def qwen_params(torch, dev, cfg):
    """Random weights from the seed in the config's bf16, drawn on the card,
    with N(0, 0.1²) QKV biases and norm scales (both are zero at init)."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(gen, cfg)
    for blk in params["blocks"]:
        leaves = [blk["attn"][n]["b"] for n in ("wq", "wk", "wv")]
        leaves += [blk[n]["scale"] for n in ("norm", "ffn_norm")]
        for t in leaves:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * QWEN_PARAM_STD)
    return params


def teacher_forced(torch, tpl, cfg, params, prompts, stream, policy=None, islands=None):
    """Per-step logits (B, gen, V) in f32 of the prefill and the decode steps
    fed ``stream`` (the greedy tokens of a ``generate`` run).  ``islands``, a
    list, receives each step's (quantize, dequantize) counts."""
    from repro_torch.models import transformer as T

    c = tpl.engine.counters

    def step(fn):
        q0, d0 = c["quantize_calls"], c["dequantize_calls"]
        res = fn()
        if islands is not None:
            islands.append((c["quantize_calls"] - q0, c["dequantize_calls"] - d0))
        return res

    s, gen = prompts.shape[1], stream.shape[1]
    logits, cache = step(lambda: T.prefill(tpl, cfg, params, prompts, cache_len=s + gen,
                                           policy=policy))
    out = [logits.float()]
    for i in range(gen - 1):
        logits, cache = step(lambda: T.decode_step(tpl, cfg, params, stream[:, i:i + 1],
                                                   s + i, cache, policy=policy))
        out.append(logits.float())
    return torch.stack(out, dim=1)


def compare_logits(torch, got, want, *, rel_tol, argmax_min, what):
    """``got`` against the plain path's ``want`` on the same stream."""
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = got.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * diff
    res = {"max_abs_diff": diff, "logit_absmax": scale, "rel_diff": diff / scale,
           "rel_tol": rel_tol, "argmax_agreement": float(agree.float().mean()),
           "argmax_min": argmax_min, "decisive_positions": int(decisive.sum()),
           "decisive_agreement": float(agree[decisive].float().mean())
           if bool(decisive.any()) else None}
    if not (bool(torch.isfinite(got).all()) and diff / scale <= rel_tol
            and res["argmax_agreement"] >= argmax_min and bool(agree[decisive].all())):
        raise AssertionError(f"{what}: logits off the plain path: {res}")
    return res


class ClipProbe:
    """While installed, records per layer the largest share of raws at the
    grid's bounds over every QTensor an engine's ``quant`` / ``matmul``
    returns (``head`` outside the layers), over prefill and decode alike."""

    def __init__(self, eng, T, n_layers: int):
        self.eng, self.T, self.n_layers = eng, T, n_layers
        self.layer, self.shares = "head", {}

    def __enter__(self):
        from repro_torch.core.quantization import QTensor

        def watch(orig):
            def fn(*a, **kw):
                out = orig(*a, **kw)
                if isinstance(out, QTensor):
                    r, f = out.raw, out.fmt
                    share = float(((r == f.raw_max) | (r == f.raw_min)).float().mean())
                    self.shares[self.layer] = max(self.shares.get(self.layer, 0.0), share)
                return out
            return fn

        self.eng.quant = watch(self.eng.quant)
        self.eng.matmul = watch(self.eng.matmul)
        self._run_layer = self.T._run_layer
        count = iter(range(10 ** 6))

        def run_layer(*a, **kw):
            self.layer = f"layer{next(count) % self.n_layers}"
            try:
                return self._run_layer(*a, **kw)
            finally:
                self.layer = "head"

        self.T._run_layer = run_layer
        return self

    def __exit__(self, *exc):
        del self.eng.quant, self.eng.matmul
        self.T._run_layer = self._run_layer


def phase_serving(torch, dev):
    """The serving main path, float and grid-resident; returns the runs for
    the timing phase and the launches of each main-path window."""
    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN_ARCH)
    params = qwen_params(torch, dev, cfg)
    prompts = synthetic_batch(SEED, 0, QWEN_PROMPTS, QWEN_PROMPT_LEN, cfg.vocab, device=dev)
    tq = default_template("q16")
    t0 = time.perf_counter()
    cal = synthetic_batch(SEED + 1, 7, 2, QWEN_PROMPT_LEN, cfg.vocab, device=dev)
    policy = T.calibrate_policy(tq, cfg, params, cal)
    qp = T.quantize_params(tq, cfg, params, policy)
    torch.cuda.synchronize()
    emit({"phase": "serving_setup", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": f"{cfg.n_heads} padded to {cfg.eff_heads}",
          "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "prompts": QWEN_PROMPTS, "prompt_len": QWEN_PROMPT_LEN, "gen": QWEN_GEN,
          "calibrated_fmt": policy.fmt.name, "calibrate_and_quantize_s":
          time.perf_counter() - t0,
          "int16_weight_fmts": sorted({v.fmt.name for v in _qleaves(qp)})})
    tf = default_template("cuda")
    tplain = default_template("torch")
    per_prefill = {"flash_attention": cfg.n_layers,
                   "matmul_fp": 7 * cfg.n_layers + 1}
    runs, windows = [], {}
    for numerics, tpl, pol in (("float", tf, None), ("grid " + policy.fmt.name, tq, policy)):
        kernel = "matmul_fp" if pol is None else "matmul_q16"
        _build.reset_launches()
        stream = generate(cfg, params, prompts, gen=QWEN_GEN, tpl=tpl, policy=pol)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        windows[numerics] = launches
        emit({"phase": "serving_launches", "numerics": numerics, **launches})
        want = {"flash_attention": cfg.n_layers,
                kernel: QWEN_GEN * per_prefill["matmul_fp"]}
        if pol is None:
            # the prefill's 7 GEMMs a layer (m = 4 x 4096, bf16) on the tensor
            # cores; its head (m = 4) and every decode GEMM stream on split-k
            want.update({"matmul_fp.wgmma": 7 * cfg.n_layers,
                         "matmul_fp.splitk": want[kernel] - 7 * cfg.n_layers,
                         "matmul_fp.tile": 0, "matmul_q16": 0})
        else:  # the grid-resident path never reaches the float GEMM
            want["matmul_fp"] = 0
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{numerics}: {name} launched {launches[name]} times, "
                                     f"want {n} (flash once per layer per prefill, never "
                                     f"in decode; float GEMMs by route)")
        assert stream.shape == (QWEN_PROMPTS, QWEN_GEN)
        # replay the stream teacher-forced through the same kernels (and, on
        # the grid, count islands and clipped raws), then through the plain path
        tree = params if pol is None else qp
        eng = tpl.engine
        islands = []
        with ClipProbe(eng, T, cfg.n_layers) as probe:
            got = teacher_forced(torch, tpl, cfg, tree, prompts, stream, pol, islands)
        if not torch.equal(got.argmax(-1), stream):
            raise AssertionError(f"{numerics}: the teacher-forced replay does not "
                                 f"reproduce generate's greedy tokens")
        extra = {}
        if pol is not None:
            law_p = T.q16_island_counts(cfg, mode="prefill")
            law_d = T.q16_island_counts(cfg, mode="decode")
            law = [(law_p["quantize"], law_p["dequantize"])]
            law += [(law_d["quantize"], law_d["dequantize"])] * (QWEN_GEN - 1)
            if islands != law:
                raise AssertionError(f"island counts per step {islands} != "
                                     f"q16_island_counts {law}")
            seen = {"prefill": islands[0], "each decode step": sorted(set(islands[1:]))}
            worst = max(probe.shares.values())
            if worst > MAX_CLIPPED_SHARE:
                raise AssertionError(f"{numerics}: raws at the grid's bounds: "
                                     f"{probe.shares}")
            extra = {"island_counts": seen, "island_law_prefill": law_p,
                     "island_law_decode": law_d, "clipped_share_by_layer": probe.shares}
        plain = teacher_forced(torch, tplain, cfg, params, prompts, stream)
        res = compare_logits(
            torch, got, plain, what=numerics,
            rel_tol=FLOAT_REL_TOL if pol is None else Q16_REL_TOL,
            argmax_min=FLOAT_ARGMAX if pol is None else Q16_ARGMAX)
        emit({"phase": "serving_check", "numerics": numerics,
              "vs": "torch backend, float, same stream", **res, **extra,
              "sample_tokens": stream[0, :8].tolist()})
        del got, plain
        runs.append((numerics, tpl, pol))
    return cfg, params, prompts, runs, windows


def _qleaves(tree):
    from repro_torch.core.quantization import QTensor

    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _qleaves(v)


def profile_window(torch, fn, *, groups=("wgmma_kernel", "splitk", "gemm_kernel",
                                         "flash_attention_kernel"),
                   host_ops: bool = False) -> dict:
    """``fn`` once under ``torch.profiler``: its wall time, the device's
    busy time and share of it, device time by group (kernels whose name
    holds the group's name; "other" is everything else, the PS-plane ops)
    and the top kernels; with ``host_ops`` also the host ops with the most
    self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.split("(")[0][:90]
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    by_group = dict.fromkeys((*groups, "other"), 0.0)
    for name, (us, _) in by_name.items():
        by_group[next((g for g in groups if g in name), "other")] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if by_name else "not measured",
           "device_busy_share": busy_ms / wall_ms if by_name else "not measured",
           "device_ms_by_group": by_group,
           "device_launches": sum(n for _, n in by_name.values()),
           "top_kernels": [{"name": k, "ms": us / 1e3, "calls": n} for k, (us, n) in top]}
    if host_ops:
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        out["top_host_ops"] = [{"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                                "calls": e.count} for e in avg]
    return out


def phase_serving_timing(torch, cfg, params, prompts, runs):
    """Prefill tokens/s, decode ms/step and peak memory (CUDA events after
    warm-up), then the device time by kernel of one prefill and of four
    decode steps (``torch.profiler``)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    s = prompts.shape[1]
    emit({"phase": "clocks_before_serving_timing", "nvidia_smi": smi_clocks()})
    for numerics, tpl, pol in runs:
        tree = params if pol is None else T.quantize_params(tpl, cfg, params, pol)
        clen = s + QWEN_GEN
        prefill = (lambda: T.prefill(tpl, cfg, tree, prompts, cache_len=clen, policy=pol))
        prefill_ms = time_ms(prefill, target_ms=1.0)
        _, cache = prefill()
        tok = prompts[:, -1:]

        def decode(n=QWEN_GEN - 1):
            c = cache
            for i in range(n):
                _, c = T.decode_step(tpl, cfg, tree, tok, s + i, c, policy=pol)

        decode_ms = time_ms(decode, target_ms=1.0) / (QWEN_GEN - 1)
        del cache
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        generate(cfg, params, prompts, gen=QWEN_GEN, tpl=tpl, policy=pol)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "serving_time", "numerics": numerics, "prompts": QWEN_PROMPTS,
              "prompt_len": s, "gen": QWEN_GEN, "prefill_ms": prefill_ms,
              "prefill_tokens_per_s": QWEN_PROMPTS * s / prefill_ms * 1e3,
              "decode_ms_per_step": decode_ms,
              "decode_tokens_per_s": QWEN_PROMPTS / decode_ms * 1e3,
              "generate_s_host_clock": gen_s, "peak_mem_bytes": peak,
              "resident_bytes_before": resident})

        _, cache = prefill()
        torch.cuda.synchronize()
        emit({"phase": "serving_profile", "numerics": numerics, "window": "one prefill",
              **profile_window(torch, prefill)})

        def decode4():
            c = cache
            for i in range(4):
                _, c = T.decode_step(tpl, cfg, tree, tok, s + i, c, policy=pol)

        emit({"phase": "serving_profile", "numerics": numerics, "window": "4 decode steps",
              **profile_window(torch, decode4, host_ops=True)})
        del cache
    emit({"phase": "clocks_after_serving_timing", "nvidia_smi": smi_clocks()})


def phase_serve_cli(torch):
    """``serve.main`` at the reference's reduced CLI size, on the card."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    out = serve.main(["--prompts", "2", "--prompt-len", "8", "--gen", "3"])
    assert out.shape == (2, 3) and out.device.type == "cuda"
    emit({"phase": "serve_cli", "argv": "--prompts 2 --prompt-len 8 --gen 3",
          "tokens": out.tolist(), "seconds": time.perf_counter() - t0})


#: the ``kernels`` line: one row per kernel, and for the float GEMM one per
#: route of the main paths (record name -> kernel, GEMM route, source, TPU
#: kernel); its route "tile" serves no main-path call and is checked above.
#: A row's launches are its wrapper's calls, one launch of the kernel each;
#: route "splitk" adds its reduction pass's launches as ``reduce_launches``
KERNEL_META = {
    "matmul_fp.wgmma": ("matmul_fp", "wgmma", "src/repro_torch/kernels/csrc/gemm_wgmma.cuh",
                        "src/repro/kernels/matmul_fp.py:76"),
    "matmul_fp.splitk": ("matmul_fp", "splitk",
                         "src/repro_torch/kernels/csrc/gemm_splitk.cuh",
                         "src/repro/kernels/matmul_fp.py:76"),
    "matmul_q16": ("matmul_q16", "tile", "src/repro_torch/kernels/csrc/matmul_q16.cu",
                   "src/repro/kernels/matmul_q16.py:71"),
    "conv2d": ("conv2d", None, "src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:329"),
    "conv2d_q16": ("conv2d_q16", None, "src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:437"),
    "flash_attention": ("flash_attention", None,
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
}


def _build_kernels():
    from repro_torch.kernels import _build

    return [k for k in _build.KERNELS if "." not in k]


def main() -> int:
    global ROUTE_STUDY
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gemm-route-study", action="store_true",
                    help="also time the float GEMM's design alternatives (route "
                         "'tile' beside fc0 and the tied head, the W/L threshold sweep)")
    ROUTE_STUDY = ap.parse_args().gemm_route_study
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
    phase_kernels_serving(torch, dev, book)
    if ROUTE_STUDY:
        phase_wgmma_threshold(torch, dev)
    torch.cuda.empty_cache()
    runs, cnn_launches = phase_main_path(torch, dev)
    phase_timing(torch, runs)
    phase_profile(torch, runs)
    del runs
    torch.cuda.empty_cache()
    cfg, params, prompts, serving_runs, serving_windows = phase_serving(torch, dev)
    phase_serving_timing(torch, cfg, params, prompts, serving_runs)
    del params, serving_runs
    torch.cuda.empty_cache()
    phase_serve_cli(torch)

    windows = {"cnn": cnn_launches, **{f"qwen2 {k}": v for k, v in serving_windows.items()}}
    kernels = []
    for key, (name, gemm_route, source, replaces) in KERNEL_META.items():
        row = book.rows[key]
        by_path = {path: w[key] for path, w in windows.items() if w[key]}
        if not by_path:
            raise AssertionError(f"kernel {key} was not launched on any main path")
        kernels.append({
            "name": name, "route": "cuda", "gemm_route": gemm_route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "shape": row["shape"], "checks": row["checks"],
            **({"route_tile_ms": row["route_tile_ms"]} if "route_tile_ms" in row else {}),
        })
        if key == "matmul_fp.splitk":
            kernels[-1]["reduce_launches"] = sum(
                w["matmul_fp.splitk_reduce"] for w in windows.values())
    if {k["name"] for k in kernels} != set(_build_kernels()):
        raise AssertionError("the kernels line does not list every kernel")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
