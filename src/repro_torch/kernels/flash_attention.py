"""Flash attention (online softmax, GQA): CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas`` (kernel
``_fa_kernel``) together with the kv broadcast of
``repro/kernels/ops.py:flash_attention``.  The kernel is
``csrc/flash_attention.cu``, which says what bounds it on an H100 and what
its design does about that; it reads kv head ``q_head // G`` in place.

Both versions compute the reference kernel's function: an f32 running max,
denominator and accumulator over kv blocks, masked scores at -1e30, fully
masked kv blocks skipped, p rounded to v's dtype before p·v, and
``acc / max(l, 1e-30)`` written in q's dtype.  q / k / v may be strided
views (the model passes its (B, S, H, D) activations transposed); the head
dim must be contiguous.

``flash_attention_cuda`` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors, and only for those.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import on_cpu, ptr, stream_of

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launch", "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
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


def launch(lib, q, k, v, out, *, causal: bool, q_offset: int, device: int,
           stream) -> None:
    """One call of the C entry point on checked operands (any strides with a
    contiguous head dim; ``out`` shaped like q)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), b, hq, hkv, sq, sk, d, _DTYPES[q.dtype],
        (ctypes.c_longlong * 12)(*strides), int(causal), q_offset,
        1.0 / d ** 0.5, device, stream,
    )
    _build.check(lib, rc, "flash_attention")


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         bk: int = 256) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype and in q's memory layout.  ``bk`` sets the plain version's kv
    block; the kernel tiles by its own 64 x 64 blocks (a fully masked block
    adds exactly nothing, so the result is the same function)."""
    _check(q, k, v, q_offset)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, bk=bk)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel is compiled for head dims "
                         f"{HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim for the CUDA kernel")
    out = torch.empty_like(q)
    launch(_build.library("flash_attention"), q, k, v, out, causal=causal,
           q_offset=q_offset, device=q.device.index, stream=stream_of(q))
    _build.launches["flash_attention"] += 1
    return out
