"""Flash attention (online softmax, GQA): CUDA kernel wrappers + plain version.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas`` (kernel
``_fa_kernel``) together with the kv broadcast of
``repro/kernels/ops.py:flash_attention``.  Two routes, which the planner
(:func:`~repro_torch.core.dse.plan_flash`) picks from the head dim:
"wgmma", the tensor cores in split-precision bf16 of
``csrc/flash_wgmma.cuh`` for head dims 64 and 128 (a preparation launch that
writes q, k and v as dense bf16 planes, then the attention), and "simt",
the CUDA-core kernel of ``csrc/flash_attention.cu`` for 16 and 32.  Each
source says what bounds it on an H100 and what its design does about that;
both read kv head ``q_head // G`` in place.  A head dim, dtype or alignment
that no route takes raises; no call moves to the other route.  Each launch
hands the plan's kv tile and shared memory to its C entry point, which
refuses a plan that differs from the kernel it compiled.

Both routes compute the reference kernel's function: an f32 running max,
denominator and accumulator over kv blocks, masked scores at -1e30, fully
masked kv blocks skipped, p rounded to v's dtype before p·v, and
``acc / max(l, 1e-30)`` written in q's dtype.  q / k / v may be strided
views (the model passes its (B, S, H, D) activations transposed); the head
dim must be contiguous, and for route "wgmma" every row 16-byte aligned.

``flash_attention_cuda`` launches a kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors, and only for those.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dse import FlashPlan, plan_flash
from repro_torch.core.tiling import H100

from . import _build
from ._common import on_cpu, ptr, stream_of

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launch", "launch_wgmma",
           "planes", "prep"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def _check(q, k, v, q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q (B, Hq, Sq, D) and k / v (B, Hkv, "
                         f"Sk, D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(Hq must be a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes f32 or bf16 q / k / v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def _strides(*tensors) -> list:
    """The element strides of each tensor's first three axes (0 on an axis
    of size 1, whose stride no element uses)."""
    return [0 if n == 1 else st for t in tensors
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          bk: int = 256) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype: the online softmax over kv blocks of ``bk`` columns in f32, each
    kv head shared by its group of q heads through a reshape (no copy)."""
    _check(q, k, v, q_offset)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    bk = min(bk, sk)
    for c0 in range(0, sk, bk):
        if causal and c0 > q_offset + sq - 1:
            break  # every later block lies above the diagonal
        kb = k[:, :, None, c0:c0 + bk].to(torch.float32)
        vb = v[:, :, None, c0:c0 + bk]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            cols = c0 + torch.arange(kb.shape[-2], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(torch.float32),
                                         vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(b, hq, sq, d)


def launch(lib, q, k, v, out, *, plan: FlashPlan, causal: bool, q_offset: int,
           device: int, stream) -> None:
    """One call of route "simt"'s C entry point on checked operands (any
    strides with a contiguous head dim; ``out`` shaped like q)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), b, hq, hkv, sq, sk, d, _DTYPES[q.dtype],
        (ctypes.c_longlong * 12)(*strides), int(causal), q_offset,
        1.0 / d ** 0.5, plan.bk, plan.smem, device, stream,
    )
    _build.check(lib, rc, "flash_attention.simt")


def planes(q, k) -> tuple:
    """Route "wgmma"'s dense bf16 planes, empty: q's (P, B·Hq·Sq, D) and
    k's and v's (P, B·Hkv·Sk, D), with P = 2 (hi, lo) for f32, 1 for bf16."""
    p = 2 if q.dtype == torch.float32 else 1
    b, hq, sq, d = q.shape
    rows_kv = b * k.shape[1] * k.shape[2]
    return tuple(torch.empty((p, rows, d), dtype=torch.bfloat16, device=q.device)
                 for rows in (b * hq * sq, rows_kv, rows_kv))


def prep(lib, q, k, v, qp, kp, vp, *, device: int, stream) -> None:
    """Route "wgmma"'s preparation launch: q, k, v (strided, 16-byte aligned
    rows) -> the planes of :func:`planes`, hi = bf16_rn(x) and for f32 lo =
    bf16_rn(x - hi)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rc = lib.flash_attention_prep_launch(
        ptr(q), ptr(k), ptr(v), ptr(qp), ptr(kp), ptr(vp), b, hq, hkv, sq, sk, d,
        _DTYPES[q.dtype], (ctypes.c_longlong * 9)(*_strides(q, k, v)), device, stream)
    _build.check(lib, rc, "flash_attention.prep")


def launch_wgmma(lib, qp, kp, vp, out, *, plan: FlashPlan, kv_shape, causal: bool,
                 q_offset: int, device: int, stream) -> None:
    """One call of route "wgmma" on prepared planes; ``out`` (B, Hq, Sq, D) in
    the operands' dtype, ``kv_shape`` k's (B, Hkv, Sk, D)."""
    b, hq, sq, d = out.shape
    rc = lib.flash_attention_wgmma_launch(
        ptr(qp), ptr(kp), ptr(vp), ptr(out), b, hq, kv_shape[1], sq, kv_shape[2], d,
        _DTYPES[out.dtype], (ctypes.c_longlong * 3)(*_strides(out)), int(causal), q_offset,
        1.0 / d ** 0.5, plan.bk, plan.smem, device, stream)
    _build.check(lib, rc, "flash_attention.wgmma")


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        rows = [st * t.element_size() for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1]
        if t.data_ptr() % 16 or any(r % 16 for r in rows):
            raise ValueError(f"{name}: route wgmma reads 16-byte aligned rows; got base "
                             f"{t.data_ptr() % 16} bytes off and row strides {rows} bytes")


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         bk: int = 256) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype and in q's memory layout, on the route the planner picks from the
    head dim.  ``bk`` sets the plain version's kv block; the kernels tile by
    their own blocks (a fully masked block adds exactly nothing, so the
    result is the same function)."""
    _check(q, k, v, q_offset)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, bk=bk)
    plan = plan_flash(q.shape[-1], q.element_size(), H100)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim for the CUDA kernel")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    dev, stream = q.device.index, stream_of(q)
    if plan.route == "wgmma":
        _check_aligned(q=q, k=k, v=v)
        qp, kp, vp = planes(q, k)
        prep(lib, q, k, v, qp, kp, vp, device=dev, stream=stream)
        _build.launches["flash_attention.prep"] += 1
        launch_wgmma(lib, qp, kp, vp, out, plan=plan, kv_shape=k.shape, causal=causal,
                     q_offset=q_offset, device=dev, stream=stream)
    else:
        launch(lib, q, k, v, out, plan=plan, causal=causal, q_offset=q_offset, device=dev,
               stream=stream)
    _build.launches["flash_attention"] += 1
    _build.launches[f"flash_attention.{plan.route}"] += 1
    if plan.route == "wgmma" and q.shape[-1] == 128:
        _build.launches["flash_attention.wgmma.d128"] += 1
    return out
