"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the sources in this package only, into
``build/repro_torch_kernels/`` at the root of the checkout; a library's file
name carries a hash of its sources, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the port,
and this host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

__all__ = [
    "BUILD_DIR",
    "CSRC",
    "KERNELS",
    "SOURCES",
    "bind",
    "build_all",
    "build_log",
    "check",
    "launches",
    "library",
    "reset_launches",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/repro_torch_kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: library name -> its CUDA source in csrc/
SOURCES = {"matmul_fp": "matmul_fp.cu", "matmul_q16": "matmul_q16.cu",
           "conv2d": "conv2d.cu", "flash_attention": "flash_attention.cu"}
#: every kernel a wrapper launches, by the name its launch count goes under;
#: both GEMMs also count each call under its route's name
#: ("matmul_fp.<route>", ``core.tiling.FP_ROUTES``; "matmul_q16.<route>",
#: ``core.tiling.Q16_ROUTES``), and route "splitk"'s second launch, the
#: reduction pass of a call cut into several k slices, as
#: "<kernel>.splitk_reduce"; the q16 GEMM's route "wgmma" counts its
#: preparation launch as "matmul_q16.prep"; the float conv likewise counts
#: each call under its route ("conv2d.<route>", ``core.tiling.CONV_ROUTES``), and
#: route "tc"'s weight preparation and Cin-split reduction launches as
#: "conv2d.tc_prep" and "conv2d.tc_reduce"; the fixed-point conv the same way
#: ("conv2d_q16.<route>", "conv2d_q16.tc_prep", "conv2d_q16.tc_reduce");
#: flash attention counts each call
#: under its route ("flash_attention.simt" or ".wgmma", ``core.dse.plan_flash``),
#: and route "wgmma"'s preparation launch as "flash_attention.prep"; a float
#: GEMM that writes a row-parallel partial sum (f32, no epilogue) counts
#: under "matmul_fp.<route>.partial" too
KERNELS = ("matmul_fp", "matmul_fp.tile", "matmul_fp.splitk", "matmul_fp.splitk_reduce",
           "matmul_fp.wgmma", "matmul_fp.tile.partial", "matmul_fp.splitk.partial",
           "matmul_fp.wgmma.partial", "matmul_q16", "matmul_q16.tile", "matmul_q16.splitk",
           "matmul_q16.splitk_reduce", "matmul_q16.wgmma", "matmul_q16.prep", "conv2d",
           "conv2d.cudacore", "conv2d.tc", "conv2d.tc_prep", "conv2d.tc_reduce", "conv2d_q16",
           "conv2d_q16.cudacore", "conv2d_q16.tc", "conv2d_q16.tc_prep",
           "conv2d_q16.tc_reduce", "flash_attention", "flash_attention.simt",
           "flash_attention.wgmma", "flash_attention.wgmma.d128", "flash_attention.prep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel: each wrapper adds one where it launches its kernel
#: on the card, and nowhere else (never for a CPU tensor's plain version);
#: "flash_attention.wgmma.d128" counts the route wgmma's launches at head
#: dim 128 among "flash_attention.wgmma"'s
launches = dict.fromkeys(KERNELS, 0)

_libs: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "matmul_fp": {
        "matmul_fp_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _F, _F, _I, _P],
    },
    "matmul_q16": {
        "matmul_q16_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "matmul_q16_prep_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
        "matmul_q16_wgmma_launch": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "conv2d": {
        "conv2d_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _P],
        "conv2d_q16_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I,
                              _I, _I, _P],
        "conv2d_tc_prep_launch": [_P, _P, _I, _I, _I, _I, _P],
        "conv2d_tc_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
        "conv2d_q16_tc_prep_launch": [_P, _I, _P, _I, _I, _I, _I, _P],
        "conv2d_q16_tc_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P, _I, _I, _F, _I, _I, _I, _P],
        "flash_attention_prep_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _P, _I, _P],
        "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         _P, _I, _I, _F, _I, _I, _I, _P],
    },
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built on the machine with the card"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start_build(name: str) -> Optional[tuple]:
    """Start nvcc for one library unless it is built; returns (proc, tmp,
    out, log, t0) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    logf = open(log, "w")
    try:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    finally:
        logf.close()
    return proc, tmp, out, log, time.perf_counter()


def _finish_build(name: str, job) -> float:
    proc, tmp, out, log, t0 = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (rc {rc}):\n{log.read_text()[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0


def build_all() -> dict:
    """Build every library not yet built, one nvcc per source in parallel.
    Returns {name: seconds} for the libraries it built; if any build fails,
    raises once every nvcc has ended."""
    jobs = {name: _start_build(name) for name in SOURCES}
    done, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            done[name] = _finish_build(name, job)
        except RuntimeError as err:
            failed.append(str(err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of one library's build."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    lib = bind(ctypes.CDLL(str(_lib_path(name))), name)
    _libs[name] = lib
    return lib


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare argtypes / restype of one library's C entry points."""
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned anything but 0."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: launch failed with code {rc} ({msg})")
