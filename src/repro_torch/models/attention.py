"""Attention: GQA / MHA, causal and cross, KV-cache prefill and decode, in
the port.

The port's copy of ``repro.models.attention``.  Projections go through the
template's compute unit; the score / value math has two routes:

* dense — full (B, H, S, T) scores in f32; used while the key length stays
  below :data:`CHUNKED_THRESHOLD`, and by every decode step.
* chunked — online softmax over kv blocks, for key lengths from
  :data:`CHUNKED_THRESHOLD` on.  On the ``cuda`` and ``q16`` backends it is
  the hand-written flash-attention kernel (``kernels.ops.flash_attention``;
  its plain version for CPU tensors), on ``torch`` a plain online softmax
  over (q chunk, kv chunk) pairs, the analogue of the reference's XLA-plane
  ``_sdpa_chunked``.  Both take q / k / v in f32 and return q's dtype, as
  the reference's route does; both skip the kv chunks that lie wholly above
  the diagonal, which adds exactly nothing to the online softmax (the
  reference's folded causal schedule, ``_sdpa_folded``, skips them too).

Cache layout per layer: {"k", "v": (B, Hkv, C, D), "pos"}, a ring buffer
(slot = pos % C): with "pos" (C,) int32 every batch row shares one position
vector (``prefill`` / ``generate``); the slot-indexed layout of the serve
scheduler gives each row its own, "pos" (B, C), so rows decode at
independent positions.  Decode positions live on the device: the write
slot, the position write and the mask come from the ``t`` tensor, never
from a host integer, so a CUDA graph can capture the step.
Sliding windows and non-causal chunked attention belong to families that
are not ported yet (ROADMAP queue 1 item 6) and raise.

Sharding seams (``parallel.sharding.constrain``): each projection's output
passes a seam before it is split into heads.  Under a mesh, a column shard
of wq / wk / wv (``qkv`` over "model") yields a column shard of q / k / v,
which the seam gathers where the rules replicate the heads
(``DECODE_RULES``), so attention and the cache see whole heads; without a
mesh every seam is a no-op.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import NumericsPolicy, QTensor
from repro_torch.core.template import Template
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import constrain

from .layers import apply_rope, dense, init_dense

__all__ = [
    "init_attention",
    "attention_axes",
    "attention",
    "attention_islands",
    "decode_attention",
    "decode_positions",
    "init_layer_cache",
    "CHUNKED_THRESHOLD",
]

_NEG = -1e30
#: use the chunked route when the key length reaches this
CHUNKED_THRESHOLD = 4096
_BQ, _BK = 1024, 1024

_NOT_PORTED = "not ported yet (ROADMAP queue 1 item 6: the other model families)"


def init_attention(gen: torch.Generator, cfg, *, d_model=None, n_heads=None, n_kv=None,
                   head_dim=None, bias=None, dtype=torch.float32, lead: tuple = ()):
    d = d_model or cfg.d_model
    h = n_heads or cfg.eff_heads
    kv = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    bias = cfg.qkv_bias if bias is None else bias
    return {
        "wq": init_dense(gen, d, h * hd, bias=bias, dtype=dtype, lead=lead),
        "wk": init_dense(gen, d, kv * hd, bias=bias, dtype=dtype, lead=lead),
        "wv": init_dense(gen, d, kv * hd, bias=bias, dtype=dtype, lead=lead),
        "wo": init_dense(gen, h * hd, d, dtype=dtype, scale=(h * hd) ** -0.5, lead=lead),
    }


def attention_axes(cfg, bias=None) -> dict:
    """Logical axes of :func:`init_attention`'s tree."""
    bias = cfg.qkv_bias if bias is None else bias
    ax = {
        "wq": {"w": ("embed", "qkv")},
        "wk": {"w": ("embed", "qkv")},
        "wv": {"w": ("embed", "qkv")},
        "wo": {"w": ("qkv", "embed")},
    }
    if bias:
        for k in ("wq", "wk", "wv"):
            ax[k]["b"] = ("qkv",)
    return ax


def _proj(tpl: Template, p, x, heads: str):
    """A q / k / v projection through its seam: a column shard is gathered
    where the rules replicate ``heads``."""
    return constrain(dense(tpl, p, x), "batch", None, heads)


def init_layer_cache(batch: int, n_kv: int, cache_len: int, head_dim: int, dtype,
                     per_slot: bool = False, device="cpu") -> dict:
    """Zero k / v ring cache.  ``per_slot`` gives each batch row its own
    position vector, (B, C) instead of the shared (C,), so rows can decode at
    independent positions (continuous batching)."""
    pos_shape = (batch, cache_len) if per_slot else (cache_len,)
    return {
        "k": torch.zeros((batch, n_kv, cache_len, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, n_kv, cache_len, head_dim), dtype=dtype, device=device),
        "pos": torch.full(pos_shape, -1, dtype=torch.int32, device=device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


# ---------------------------------------------------------------------------
# score / value math
# ---------------------------------------------------------------------------


def _sdpa_dense(q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,D); k / v: (B,T,Hkv,D); mask: (B,1,S,T) or None -> (B,S,H,D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / (d ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _online_softmax_chunked(q, k, v, *, q_offset: int, bq: int, bk: int):
    """The torch backend's chunked route: causal online softmax over (q chunk,
    kv chunk) pairs in f32.  q: (B,S,H,D); k / v: (B,T,Hkv,D) f32."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / (d ** 0.5)
    kg = k.permute(0, 2, 1, 3)[:, :, None]  # (B,Hkv,1,T,D)
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, bq):
        qc = q[:, q0:q0 + bq].reshape(b, -1, hkv, g, d).permute(0, 2, 3, 1, 4)
        n = qc.shape[3]
        rows = q_offset + q0 + torch.arange(n, device=q.device)[:, None]
        m = torch.full((b, hkv, g, n), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, n, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, t, bk):
            if k0 > q_offset + q0 + n - 1:
                break  # this and every later kv chunk lies above the diagonal
            srt = torch.matmul(qc, kg[:, :, :, k0:k0 + bk].transpose(-1, -2)) * scale
            cols = k0 + torch.arange(srt.shape[-1], device=q.device)[None, :]
            srt = torch.where(rows >= cols, srt, _NEG)
            m_new = torch.maximum(m, srt.amax(-1))
            p = torch.exp(srt - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vg[:, :, :, k0:k0 + bk])
            m = m_new
        res = acc / torch.clamp(l[..., None], min=1e-30)  # (B,Hkv,G,n,D)
        out[:, q0:q0 + n] = res.permute(0, 3, 1, 2, 4).reshape(b, n, h, d)
    return out


def _sdpa_chunked(tpl: Template, q, k, v, *, causal: bool, window: int,
                  q_offset: int) -> torch.Tensor:
    """Chunked attention over (_BQ, _BK) blocks, memory O(_BQ·_BK) per head.
    q: (B,S,H,D); k / v: (B,T,Hkv,D); rows are global positions q_offset+i,
    cols 0..T-1.  The cuda / q16 backends run the flash-attention kernel,
    torch a plain online softmax; both in f32, returning q's dtype."""
    if window:
        raise NotImplementedError(f"sliding-window chunked attention is {_NOT_PORTED}")
    if not causal:
        raise NotImplementedError(f"non-causal chunked attention is {_NOT_PORTED}")
    q = constrain(q, "batch", None, "act_heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    if tpl.config.backend == "torch":
        out = _online_softmax_chunked(qf, kf, vf, q_offset=q_offset, bq=_BQ, bk=_BK)
    else:
        out = kops.flash_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                                   vf.transpose(1, 2), causal=True, q_offset=q_offset,
                                   bq=_BQ, bk=_BK).transpose(1, 2)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# full-sequence attention (prefill / forward)
# ---------------------------------------------------------------------------


def attention(
    tpl: Template,
    p,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    kv_source: Optional[torch.Tensor] = None,
    n_heads: Optional[int] = None,
    n_kv: Optional[int] = None,
    head_dim: Optional[int] = None,
    use_rope: Optional[bool] = None,
    cache_len: int = 0,
    policy: Optional[NumericsPolicy] = None,
):
    """Full-sequence attention.  x: (B, S, d).  Returns (out, cache_or_None):
    with ``cache_len > 0`` (prefill) also the filled ring cache.

    Under a quantized ``policy`` (QTensor weights) the four projections run
    grid-resident off one quantized input; q / k / v cross to float only
    for the RoPE / softmax island, the returned cache holds the raws (v
    straight off the GEMM grid, k requantized after RoPE), and the wo output
    dequantizes once into the residual stream.
    """
    h = n_heads or cfg.eff_heads
    kvh = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    rope = cfg.use_rope if use_rope is None else use_rope
    q16 = policy is not None and policy.quantized and isinstance(p["wq"]["w"], QTensor)
    eng = tpl.engine

    if q16:
        xin = eng.quant(x, policy.fmt)
        src_in = xin if kv_source is None else eng.quant(kv_source, policy.fmt)
        q = _split_heads(eng.dequant(_proj(tpl, p["wq"], xin, "act_heads")), h)
        kq = _proj(tpl, p["wk"], src_in, "kv_heads")  # QTensor, stays on the grid
        vq = _proj(tpl, p["wv"], src_in, "kv_heads")
        k = _split_heads(eng.dequant(kq), kvh)
        v = _split_heads(eng.dequant(vq), kvh)
    else:
        q = _split_heads(_proj(tpl, p["wq"], x, "act_heads"), h)
        src = x if kv_source is None else kv_source
        k = _split_heads(_proj(tpl, p["wk"], src, "kv_heads"), kvh)
        v = _split_heads(_proj(tpl, p["wv"], src, "kv_heads"), kvh)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "act_heads", None)
    if rope and kv_source is None:
        k = apply_rope(k, positions, cfg.rope_theta)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    sq, st = q.shape[1], k.shape[1]
    is_causal = causal and kv_source is None
    if st >= CHUNKED_THRESHOLD:
        out = _sdpa_chunked(tpl, q, k, v, causal=is_causal, window=window, q_offset=0)
    else:
        mask = None
        if is_causal:
            rows = torch.arange(sq, device=x.device)[:, None]
            cols = torch.arange(st, device=x.device)[None, :]
            m = rows >= cols
            if window:
                m &= (rows - cols) < window
            mask = m[None, None].expand(x.shape[0], 1, sq, st)
        out = _sdpa_dense(q, k, v, mask)

    out = constrain(out, "batch", None, "act_heads", None)
    out = out.reshape(x.shape[0], x.shape[1], h * hd)
    if q16:
        out = eng.dequant(dense(tpl, p["wo"], eng.quant(out, policy.fmt)))
    else:
        out = dense(tpl, p["wo"], out)

    cache = None
    if cache_len:
        # self-attention caches query positions; cross-attention the static
        # context positions 0..T-1
        fill_pos = positions if kv_source is None else torch.arange(st, device=x.device)
        if q16:
            # raw cache: v straight off the GEMM grid (never roped); k
            # re-enters the grid after the RoPE island
            k_c = (eng.quant(k, policy.fmt).raw if rope and kv_source is None
                   else kq.reshape(*k.shape).raw)
            v_c = vq.reshape(*v.shape).raw
        else:
            k_c, v_c = k, v
        cache = _fill_cache(k_c, v_c, fill_pos, cache_len if kv_source is None else st)
    return out, cache


def _fill_cache(k, v, positions, cache_len: int) -> dict:
    """Pack rotated k / v (B,S,Hkv,D) into a ring cache of ``cache_len``
    slots (slot = pos % cache_len), keeping the last ``cache_len``
    positions; positions are contiguous 0..S-1 (prefill)."""
    b, s, hkv, d = k.shape
    kt = k.transpose(1, 2)  # (B,Hkv,S,D)
    vt = v.transpose(1, 2)
    pos = (positions if positions.ndim == 1 else positions[0]).to(torch.int32)
    pos = pos.expand(s)
    if s < cache_len:
        pad = cache_len - s
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
        return {"k": kt, "v": vt, "pos": pos}
    kt = kt[:, :, s - cache_len:]
    vt = vt[:, :, s - cache_len:]
    pos = pos[s - cache_len:]
    shift = s % cache_len
    return {"k": torch.roll(kt, shift, dims=2).contiguous(),
            "v": torch.roll(vt, shift, dims=2).contiguous(),
            "pos": torch.roll(pos, shift).contiguous()}


def attention_islands(cfg, *, mode: str, cached: bool = False) -> dict:
    """Designated float islands of one quantized attention sublayer, as
    (quantize, dequantize) call counts.

    decode: quantize {x, attn-out, +k after RoPE}; dequantize {q, +k for
    RoPE, cache k, cache v, wo-out}.  prefill / forward: quantize {x,
    attn-out, +k for the cache when RoPE rotated it}; dequantize {q, k, v,
    wo-out}.
    """
    rope = cfg.use_rope
    if mode == "decode":
        return {"quantize": 2 + int(rope), "dequantize": 5 if rope else 4}
    return {"quantize": 2 + int(rope and cached), "dequantize": 4}


# ---------------------------------------------------------------------------
# decode (ring cache; one token, or a chunk per slot)
# ---------------------------------------------------------------------------


def decode_positions(t, device) -> torch.Tensor:
    """The decode position(s) ``t`` as an int64 tensor on ``device``: an int
    becomes a 0-d tensor (filled on the device, no host copy), a tensor keeps
    its shape, 0-d or (B,)."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.int64)
    return torch.full((), int(t), dtype=torch.int64, device=device)


def decode_attention(
    tpl: Template,
    p,
    x: torch.Tensor,
    cache: dict,
    *,
    cfg,
    t,
    window: int = 0,
    cross: bool = False,
    n_heads: Optional[int] = None,
    n_kv: Optional[int] = None,
    head_dim: Optional[int] = None,
    use_rope: Optional[bool] = None,
    policy: Optional[NumericsPolicy] = None,
    n_valid: Optional[torch.Tensor] = None,
    inplace: bool = False,
):
    """One decode step.  x: (B, 1, d); t: the position, an int or a 0-d
    tensor shared by every row, or, with a slot-indexed cache (pos: (B, C)),
    a (B,) tensor of per-row positions (a 0-d ``t`` then applies to every
    row).

    Self-attention writes the new kv at slot t % C and masks by stored
    positions; cross-attention reads its static cache.  The slot-indexed
    path also takes a block x: (B, S, d), row b covering positions t[b] ..
    t[b]+S-1 (chunked prefill): t[b] < 0 turns lane b off (its cache row is
    left byte for byte as it was, its output is garbage), and ``n_valid``
    (B,) limits the writes to the first n_valid[b] of the S tokens (a ragged
    last chunk; None: all S are real).  Writes gather the incumbent entries,
    select per the write mask and scatter back, so gated lanes keep their
    bytes.

    Returns (out, new_cache).  By default the cache passed in is left as it
    was (the rings are copied); ``inplace=True`` writes into its tensors and
    returns them, for a caller that gives the cache up (a captured step).

    Under a quantized ``policy`` the projections are grid-resident and the
    ring cache holds raws: the new v row is written straight off the GEMM
    grid, k re-enters the grid after the RoPE island, and the cached keys /
    values dequantize once into the softmax island.
    """
    h = n_heads or cfg.eff_heads
    kvh = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    rope = (cfg.use_rope if use_rope is None else use_rope) and not cross
    q16 = policy is not None and policy.quantized and isinstance(p["wq"]["w"], QTensor)
    eng = tpl.engine

    b, s = x.shape[0], x.shape[1]
    per_slot = (not cross) and cache["pos"].ndim == 2
    tpos = decode_positions(t, x.device)
    steps = torch.arange(s, device=x.device)
    if per_slot:
        tpos = tpos.reshape(-1).expand(b)  # a shared t applies to every row
        q_positions = tpos[:, None] + steps[None, :]  # (B, S)
    else:
        if s != 1:
            raise ValueError(f"decode_attention on a shared-position cache takes one "
                             f"token per row, got {s}")
        tpos = tpos.reshape(())
        q_positions = tpos.reshape(1)  # (1,)
    xin = eng.quant(x, policy.fmt) if q16 else x
    q = _proj(tpl, p["wq"], xin, "act_heads")
    q = _split_heads(eng.dequant(q) if q16 else q, h)
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)

    mask = None
    if cross:
        k, v = cache["k"], cache["v"]  # (B,Hkv,T,D) static
        valid = cache["pos"] >= 0
        new_cache = cache
    else:
        c = cache["k"].shape[2]
        kq = _proj(tpl, p["wk"], xin, "kv_heads")
        vq = _proj(tpl, p["wv"], xin, "kv_heads")
        if q16:
            # v never leaves the grid; k crosses only for the RoPE island
            v_new = vq.reshape(b, s, kvh, hd).raw
            if rope:
                k_new = apply_rope(_split_heads(eng.dequant(kq), kvh), q_positions,
                                   cfg.rope_theta)
                k_new = eng.quant(k_new, policy.fmt).raw
            else:
                k_new = kq.reshape(b, s, kvh, hd).raw
        else:
            k_new = _split_heads(kq, kvh)
            v_new = _split_heads(vq, kvh)
            if rope:
                k_new = apply_rope(k_new, q_positions, cfg.rope_theta)
        k, v, pos = ((cache[n] if inplace else cache[n].clone()) for n in ("k", "v", "pos"))
        if per_slot:
            # each row writes its own ring slots (qpos % C, distinct within a
            # row as S <= C): gather the incumbents, select, scatter back
            nv = (torch.full((b,), s, dtype=torch.int64, device=x.device) if n_valid is None
                  else torch.as_tensor(n_valid, device=x.device).reshape(-1).expand(b))
            write = (tpos >= 0)[:, None] & (steps[None, :] < nv[:, None])  # (B, S)
            slots = torch.remainder(q_positions, c)  # (B, S), non-negative
            rows = torch.arange(b, device=x.device)[:, None]
            wm = write[:, :, None, None]
            k[rows, :, slots] = torch.where(wm, k_new.to(k.dtype), k[rows, :, slots])
            v[rows, :, slots] = torch.where(wm, v_new.to(v.dtype), v[rows, :, slots])
            pos[rows, slots] = torch.where(write, q_positions.to(pos.dtype), pos[rows, slots])
            # causal block mask against the whole ring: (B, S, C)
            valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_positions[:, :, None])
            if window:
                valid &= pos[:, None, :] > q_positions[:, :, None] - window
            mask = valid[:, None]  # (B, 1, S, C)
        else:
            slot = torch.remainder(tpos, c).reshape(1)
            k.index_copy_(2, slot, k_new.transpose(1, 2).to(k.dtype))
            v.index_copy_(2, slot, v_new.transpose(1, 2).to(v.dtype))
            pos.index_copy_(0, slot, q_positions.to(pos.dtype))
            valid = (pos >= 0) & (pos <= tpos)
            if window:
                valid &= pos > tpos - window
        new_cache = {"k": k, "v": v, "pos": pos}

    if q16:
        # the raw ring cache crosses into the softmax island here
        k = eng.dequant(k, policy.fmt)
        v = eng.dequant(v, policy.fmt)
    if mask is None:
        if valid.ndim == 1:
            valid = valid[None]
        mask = valid[:, None, None, :].expand(b, 1, s, k.shape[2])
    out = _sdpa_dense(q, k.transpose(1, 2), v.transpose(1, 2), mask)
    out = out.reshape(b, s, h * hd)
    if q16:
        out = eng.dequant(dense(tpl, p["wo"], eng.quant(out, policy.fmt)))
    else:
        out = dense(tpl, p["wo"], out)
    return out, new_cache
