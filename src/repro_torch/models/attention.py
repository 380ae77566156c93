"""Attention: GQA / MHA, causal and cross, KV-cache prefill and decode, in
the port.

The port's copy of ``repro.models.attention``.  Projections go through the
template's compute unit; the score / value math has two routes:

* dense — full (B, H, S, T) scores in f32; used while the key length stays
  below :data:`CHUNKED_THRESHOLD`, and by every decode step.
* chunked — online softmax over kv blocks, for key lengths from
  :data:`CHUNKED_THRESHOLD` on, the analogue of the reference's XLA-plane
  ``_sdpa_chunked``.  On the ``cuda`` and ``q16`` backends a call with no
  window at a head dim the flash-attention kernel is compiled for (the
  spec's ``flash_head_dims`` and ``flash_wgmma_head_dims``) runs that
  kernel (``kernels.ops.flash_attention``; its plain version for CPU
  tensors), causal or not.  A sliding window, a head dim the kernel is not
  compiled for (recurrentgemma's 256) and the ``torch`` backend take a
  plain online softmax over (q chunk, kv chunk) pairs.  Both take q / k / v
  in f32 and return q's dtype, as the reference's route does; both skip
  the kv chunks that add exactly nothing to the online softmax: those
  wholly above the diagonal and, under a window, those wholly left of it
  (the reference's folded causal schedule, ``_sdpa_folded``, skips the
  first kind too).

Cache layout per layer: {"k", "v": (B, Hkv, C, D), "pos"}, a ring buffer
(slot = pos % C): with "pos" (C,) int32 every batch row shares one position
vector (``prefill`` / ``generate``); the slot-indexed layout of the serve
scheduler gives each row its own, "pos" (B, C), so rows decode at
independent positions.  Decode positions live on the device: the write
slot, the position write and the mask come from the ``t`` tensor, never
from a host integer, so a CUDA graph can capture the step.  A
sliding-window layer's ring holds ``min(window, cache_len)`` slots;
cross-attention reads a static cache of the context's keys and values,
filled once by the prefill.

Sharding seams (``parallel.sharding``): each projection's output passes a
seam as it is split into heads.  Under a mesh, a column shard of wq / wk /
wv (``qkv`` over "model") yields a column shard of q / k / v.  Where the
rules replicate the heads (``DECODE_RULES``) the seam gathers it, so
attention and the cache see whole heads.  Where they shard the heads
(``TRAIN_RULES``) a rank keeps its whole heads, and attends over the whole
sequence (a sequence-parallel input is gathered once, before the
projections); kv heads the drop rule keeps whole (fewer kv heads than
ranks, so a column shard would hold half a head) are gathered whole, and
each rank pairs its q heads with the kv heads their GQA groups read.  The
output projection is then row-parallel: its output is a partial sum that
the caller's seam reduce-scatters onto the sequence.  Without a mesh every
seam is a no-op.

Under ``SERVE_RULES`` (heads over "model", the ring's sequence over
"model": ``seq_kv``) a rank holds slots [r·C/M, (r+1)·C/M) of every decode
ring, all kv heads of each (the ring is the long axis; GQA's few kv heads
need not divide the axis).  The prefill computes its heads' k / v over
every position, gathers the heads and fills only the rank's slots; a
decode step gathers q and the new k / v over their heads (they are small
at decode), writes each position on the rank that owns its slot
(``sharding.ring_owner``), attends over the rank's slots and merges the
ranks' partial softmaxes (``sharding.softmax_combine``).  wo then takes
its layout from the rules: a row-parallel cut of the whole output, whose
partial sum the caller's seam reduces, or the whole output.  The ring's
shard rides on the cache tensors as a shard mark on the slot dim (pos's
too); a ring without one is whole.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import NumericsPolicy, QTensor
from repro_torch.core.template import Template
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

from .layers import apply_rope, dense, init_dense, split_einsum

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


def init_attention(gen: torch.Generator, cfg, *, d_model=None, n_heads=None, n_kv=None,
                   head_dim=None, bias=None, dtype=torch.float32, lead: tuple = (),
                   shardings=None):
    d = d_model or cfg.d_model
    h = n_heads or cfg.eff_heads
    kv = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    bias = cfg.qkv_bias if bias is None else bias

    def one(name, d_in, d_out, **kw):
        return init_dense(gen, d_in, d_out, dtype=dtype, lead=lead,
                          shardings=sh.subtree(shardings, name), **kw)

    return {
        "wq": one("wq", d, h * hd, bias=bias),
        "wk": one("wk", d, kv * hd, bias=bias),
        "wv": one("wv", d, kv * hd, bias=bias),
        "wo": one("wo", h * hd, d, scale=(h * hd) ** -0.5),
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


def _pair_kv(q, k, v, n_heads: int):
    """k / v for this rank's q heads: where q holds a shard of the heads
    (marked) and k / v hold every kv head (the drop rule kept them whole),
    the kv heads that this rank's GQA groups read (q head i reads kv head
    i // (H / Hkv)); otherwise k / v as they are."""
    qh = [mk for mk in sh.shard_marks(q) if mk[0] == -2]
    if not qh or any(mk[0] == -2 for mk in sh.shard_marks(k)):
        return k, v
    hl, hkv = q.shape[2], k.shape[2]
    g = n_heads // hkv
    first = sh.axis_coord(sh.active_mesh(), qh[0][1]) * hl
    lo, hi = first // g, (first + hl - 1) // g + 1
    per = hl // (hi - lo) if hl % (hi - lo) == 0 else 0
    if not per or any((first + j) // g - lo != j // per for j in range(hl)):
        raise ValueError(f"q heads {first}..{first + hl - 1} of a rank do not pair with "
                         f"kv heads {lo}..{hi - 1} as whole GQA groups of {g}")
    return k[:, :, lo:hi], v[:, :, lo:hi]


# ---------------------------------------------------------------------------
# score / value math
# ---------------------------------------------------------------------------


def _sdpa_dense(q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,D); k / v: (B,T,Hkv,D); mask: (B,1,S,T) or None -> (B,S,H,D).
    A decode step's call (S = 1) on a rank of a data split contracts the
    logical batch's rows (``layers.split_einsum``): its rows get one
    device's bits."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    einsum = split_einsum if s == 1 else torch.einsum
    scores = einsum("bshgd,bthd->bhgst", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / (d ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _sdpa_ring_shard(q, k, v, mask, axes) -> torch.Tensor:
    """:func:`_sdpa_dense` over a ring whose slots shard over ``axes``: the
    scores and PV of this rank's slots (T of them) as a partial softmax (row
    max, denominator, unnormalised accumulator in f32; a row whose slots
    are all masked gives max -1e30, denominator 0), merged over the ranks
    by ``sharding.softmax_combine``.  q: (B,S,H,D) whole; k / v:
    (B,T,Hkv,D); mask: (B,1,S,T) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    einsum = split_einsum if s == 1 else torch.einsum
    scores = einsum("bshgd,bthd->bhgst", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / (d ** 0.5)
    live = mask[:, :, None]  # (B,1,1,S,T)
    scores = torch.where(live, scores, _NEG)
    m = scores.amax(-1)  # (B,Hkv,G,S)
    p = torch.where(live, torch.exp(scores - m[..., None]), 0.0)
    acc = einsum("bhgst,bthd->bhgsd", p, v.to(torch.float32))
    out = sh.softmax_combine(m, p.sum(-1), acc, axes)  # (B,Hkv,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _online_softmax_chunked(q, k, v, *, causal: bool, window: int, q_offset: int,
                            bq: int, bk: int):
    """The plain chunked route: online softmax over (q chunk, kv chunk) pairs
    in f32, causal (under a ``window``: key ``c`` visible from row ``r`` when
    ``r - window < c <= r``) or not.  q: (B,S,H,D); k / v: (B,T,Hkv,D) f32.
    A kv chunk wholly above the diagonal or wholly left of the window is
    skipped: it adds exactly nothing to the online softmax."""
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
        first, last = q_offset + q0, q_offset + q0 + n - 1  # this chunk's rows
        rows = first + torch.arange(n, device=q.device)[:, None]
        m = torch.full((b, hkv, g, n), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, n, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, t, bk):
            if causal and k0 > last:
                break  # this and every later kv chunk lies above the diagonal
            if causal and window and k0 + bk - 1 <= first - window:
                continue  # wholly left of every row's window
            srt = torch.matmul(qc, kg[:, :, :, k0:k0 + bk].transpose(-1, -2)) * scale
            if causal:
                cols = k0 + torch.arange(srt.shape[-1], device=q.device)[None, :]
                valid = rows >= cols
                if window:
                    valid &= (rows - cols) < window
                srt = torch.where(valid, srt, _NEG)
            m_new = torch.maximum(m, srt.amax(-1))
            p = torch.exp(srt - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vg[:, :, :, k0:k0 + bk])
            m = m_new
        res = acc / torch.clamp(l[..., None], min=1e-30)  # (B,Hkv,G,n,D)
        out[:, q0:q0 + n] = res.permute(0, 3, 1, 2, 4).reshape(b, n, h, d)
    return out


def _flash_route(tpl: Template, window: int, head_dim: int) -> bool:
    """Whether a chunked call runs the flash-attention kernel: the cuda and
    q16 backends, no window, a head dim the kernel is compiled for."""
    hw = tpl.config.hw
    dims = (*getattr(hw, "flash_head_dims", ()), *getattr(hw, "flash_wgmma_head_dims", ()))
    return tpl.config.backend != "torch" and not window and head_dim in dims


def _sdpa_chunked(tpl: Template, q, k, v, *, causal: bool, window: int,
                  q_offset: int) -> torch.Tensor:
    """Chunked attention over (_BQ, _BK) blocks, memory O(_BQ·_BK) per head.
    q: (B,S,H,D); k / v: (B,T,Hkv,D); rows are global positions q_offset+i,
    cols 0..T-1.  The flash-attention kernel where :func:`_flash_route`
    says so, else the plain online softmax; both in f32, returning q's
    dtype."""
    q = constrain(q, "batch", None, "act_heads", None)  # k / v passed theirs in attention
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    t = k.shape[1]
    if _flash_route(tpl, window, q.shape[-1]):
        # a non-causal call takes kv blocks that divide the key length (the
        # reference kernel's rule); the kernel masks its own ragged tile
        bk = _BK if causal or t % min(_BK, t) == 0 else t
        out = kops.flash_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                                   vf.transpose(1, 2), causal=causal, q_offset=q_offset,
                                   bq=_BQ, bk=bk).transpose(1, 2)
    else:
        out = _online_softmax_chunked(qf, kf, vf, causal=causal, window=window,
                                      q_offset=q_offset, bq=_BQ, bk=_BK)
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

    # the whole sequence (and context) on every rank: a sequence-parallel
    # input is gathered once, for the three projections
    x = constrain(x, "batch", "seq", "act_embed")
    if kv_source is not None:
        kv_source = constrain(kv_source, "batch", "ctx", "act_embed")
    if q16:
        xin = eng.quant(x, policy.fmt)
        src_in = xin if kv_source is None else eng.quant(kv_source, policy.fmt)
        q = _split_heads(eng.dequant(_proj(tpl, p["wq"], xin, "act_heads")), h)
        kq = _proj(tpl, p["wk"], src_in, "kv_heads")  # QTensor, stays on the grid
        vq = _proj(tpl, p["wv"], src_in, "kv_heads")
        k = _split_heads(eng.dequant(kq), kvh)
        v = _split_heads(eng.dequant(vq), kvh)
    else:
        q = sh.split_last(dense(tpl, p["wq"], x), h, "batch", None, "act_heads", None)
        src = x if kv_source is None else kv_source
        k = sh.split_last(dense(tpl, p["wk"], src), kvh, "batch", None, "kv_heads", None)
        v = sh.split_last(dense(tpl, p["wv"], src), kvh, "batch", None, "kv_heads", None)
    if rope:
        q = sh.carry_marks(q, apply_rope(q, positions, cfg.rope_theta))
    q = constrain(q, "batch", None, "act_heads", None)
    if rope and kv_source is None:
        k = sh.carry_marks(k, apply_rope(k, positions, cfg.rope_theta))
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    ka, va = _pair_kv(q, k, v, h)

    sq, st = q.shape[1], k.shape[1]
    is_causal = causal and kv_source is None
    if st >= CHUNKED_THRESHOLD:
        out = _sdpa_chunked(tpl, q, ka, va, causal=is_causal, window=window, q_offset=0)
    else:
        mask = None
        if is_causal:
            rows = torch.arange(sq, device=x.device)[:, None]
            cols = torch.arange(st, device=x.device)[None, :]
            m = rows >= cols
            if window:
                m &= (rows - cols) < window
            mask = m[None, None].expand(x.shape[0], 1, sq, st)
        out = _sdpa_dense(q, ka, va, mask)

    out = constrain(sh.carry_marks(q, out), "batch", None, "act_heads", None)
    out = sh.merge_last(out)
    if q16:
        out = eng.dequant(dense(tpl, p["wo"], eng.quant(out, policy.fmt)))
    else:
        out = dense(tpl, p["wo"], out)

    cache = None
    if cache_len:
        # self-attention caches query positions; cross-attention the static
        # context positions 0..T-1
        fill_pos = positions if kv_source is None else torch.arange(st, device=x.device)
        if not q16:  # the cache holds every kv head: a rank's heads are gathered
            k, v = (sh.replicated(t, dims=(-2,)) for t in (k, v))
        ring = _ring_axes(cache_len) if kv_source is None and not q16 else None
        if ring is not None:  # only this rank's slots of the ring are filled
            return out, _fill_ring_shard(k, v, fill_pos, cache_len, ring)
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


def _ring_axes(c: int):
    """The mesh axes the active rules shard a ``c``-slot ring's sequence
    over (``seq_kv``), or None: off a mesh, under rules that keep it whole,
    or where the drop rule does (``c`` does not divide)."""
    mesh = sh.active_mesh()
    if mesh is None or sh.active_rules() is None:
        return None
    spec = tuple(sh.logical_to_spec(("seq_kv",), dim_sizes=(c,)))
    axes = spec[0] if spec else None
    return axes if axes is not None and sh.axis_size(mesh, axes) > 1 else None


def _ring_shard(k):
    """(axes, logical slot count) of a k ring whose slot dim holds this
    rank's shard (its mark), or None for a whole ring."""
    mk = [m for m in sh.shard_marks(k) if m[0] == -2]
    if not mk:
        return None
    if sh.active_mesh() is None:
        raise ValueError("a sequence-sharded KV ring (its slot dim marked) is read under "
                         "the mesh that cut it (use_mesh)")
    return mk[0][1], mk[0][2]


def _fill_ring_shard(k, v, positions, cache_len: int, axes) -> dict:
    """:func:`_fill_cache`'s ring, only this rank's slots of it (``axes``
    shard the slots): slot j holds the last position p < S with p % C == j,
    or nothing (zeros, pos -1).  k / v (B,S,Hkv,D) whole over the heads;
    the ring (B,Hkv,C/M,D) and pos (C/M,) carry the slot dim's mark."""
    lo, hi = sh.local_rows(cache_len, sh.active_mesh(), axes)
    s = k.shape[1]
    dev = k.device
    slots = torch.arange(lo, hi, device=dev)
    last = slots + cache_len * torch.div(s - 1 - slots, cache_len, rounding_mode="floor")
    valid = last >= 0
    idx = torch.clamp(last, min=0)
    pos = (positions if positions.ndim == 1 else positions[0]).to(torch.int32).expand(s)
    keep = valid[None, None, :, None]
    kt = torch.where(keep, k.transpose(1, 2)[:, :, idx], 0).contiguous()
    vt = torch.where(keep, v.transpose(1, 2)[:, :, idx], 0).contiguous()
    pr = torch.where(valid, pos[idx], -1).contiguous()
    return {"k": sh.mark_shard(kt, ((-2, axes, cache_len),)),
            "v": sh.mark_shard(vt, ((-2, axes, cache_len),)),
            "pos": sh.mark_shard(pr, ((-1, axes, cache_len),))}


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


def _write_owned(k, v, pos, k_new, v_new, q_positions, tpos, steps, n_valid, *,
                 per_slot: bool, c: int, axes) -> None:
    """Write the new entries into this rank's slots [lo, lo + T) of a
    ``c``-slot ring whose slots shard over ``axes``, in place: a position
    goes to slot pos % c on the rank that owns it (``sharding.ring_owner``)
    and nowhere else.  Per slot (k /
    v (B,Hkv,T,D), pos (B,T)) each row gathers the incumbents and scatters
    back as :func:`decode_attention` does; a token this rank does not write
    (another rank's slot, an inactive lane, a pad token) is pointed at the
    row's first written slot with that slot's new value, or at slot 0 with
    its incumbent, so duplicate indices always carry equal values.  Shared
    (pos (T,), one token): the one slot if this rank owns it."""
    mesh = sh.active_mesh()
    me = sh.axis_coord(mesh, axes)
    t_loc = k.shape[2]
    lo = me * t_loc
    b, s = k_new.shape[:2]
    dev = k.device
    if not per_slot:
        slot = torch.remainder(tpos, c).reshape(1)
        own = sh.ring_owner(slot, c, mesh, axes) == me
        li = torch.where(own, slot - lo, 0)
        for ring, new in ((k, k_new), (v, v_new)):
            new = new.transpose(1, 2).to(ring.dtype)
            ring.index_copy_(2, li, torch.where(own, new, ring.index_select(2, li)))
        pos.index_copy_(0, li, torch.where(own, q_positions.to(pos.dtype),
                                           pos.index_select(0, li)))
        return
    nv = (torch.full((b,), s, dtype=torch.int64, device=dev) if n_valid is None
          else torch.as_tensor(n_valid, device=dev).reshape(-1).expand(b))
    slot = torch.remainder(q_positions, c)  # (B, S)
    local = slot - lo
    write = ((tpos >= 0)[:, None] & (steps[None, :] < nv[:, None])
             & (sh.ring_owner(slot, c, mesh, axes) == me))
    first = torch.argmax(write.to(torch.int8), dim=1)  # (B,): 0 when none
    has = write.any(dim=1)
    rows1 = torch.arange(b, device=dev)
    anchor = torch.where(has, local[rows1, first], 0)  # (B,)
    li = torch.where(write, local, anchor[:, None])
    rows = rows1[:, None]
    wm = write[:, :, None, None]
    for ring, new in ((k, k_new), (v, v_new)):
        new = new.to(ring.dtype)
        fill = torch.where(has[:, None, None], new[rows1, first], ring[rows1, :, anchor])
        ring[rows, :, li] = torch.where(wm, new, fill[:, None])
    pfill = torch.where(has, q_positions[rows1, first].to(pos.dtype), pos[rows1, anchor])
    pos[rows, li] = torch.where(write, q_positions.to(pos.dtype), pfill[:, None])


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
    # every head of q on every rank: a column shard (heads over "model") is
    # gathered, small at decode
    q = _split_heads(eng.dequant(q) if q16 else sh.replicated(q, dims=(-1,)), h)
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)

    mask = None
    if cross:
        k, v = cache["k"], cache["v"]  # (B,Hkv,T,D) static
        valid = cache["pos"] >= 0
        new_cache, ring = cache, None
    else:
        ring = _ring_shard(cache["k"])
        if ring is not None and q16:
            raise ValueError("a sequence-sharded KV ring takes float decode; the "
                             "fixed-point path runs column-parallel rules")
        c = cache["k"].shape[2] if ring is None else ring[1]
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
            k_new = _split_heads(sh.replicated(kq, dims=(-1,)), kvh)
            v_new = _split_heads(sh.replicated(vq, dims=(-1,)), kvh)
            if rope:
                k_new = apply_rope(k_new, q_positions, cfg.rope_theta)
        k, v, pos = ((cache[n] if inplace else sh.carry_marks(cache[n], cache[n].clone()))
                     for n in ("k", "v", "pos"))
        if ring is not None:
            _write_owned(k, v, pos, k_new, v_new, q_positions, tpos, steps, n_valid,
                         per_slot=per_slot, c=c, axes=ring[0])
        elif per_slot:
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
        else:
            slot = torch.remainder(tpos, c).reshape(1)
            k.index_copy_(2, slot, k_new.transpose(1, 2).to(k.dtype))
            v.index_copy_(2, slot, v_new.transpose(1, 2).to(v.dtype))
            pos.index_copy_(0, slot, q_positions.to(pos.dtype))
        if per_slot:
            # causal block mask against the (rank's) ring: (B, S, C)
            valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_positions[:, :, None])
            if window:
                valid &= pos[:, None, :] > q_positions[:, :, None] - window
            mask = valid[:, None]  # (B, 1, S, C)
        else:
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
    if ring is not None:
        out = _sdpa_ring_shard(q, k.transpose(1, 2), v.transpose(1, 2), mask, ring[0])
    else:
        out = _sdpa_dense(q, k.transpose(1, 2), v.transpose(1, 2), mask)
    out = out.reshape(b, s, h * hd)
    if q16:
        out = eng.dequant(dense(tpl, p["wo"], eng.quant(out, policy.fmt)))
    else:
        out = dense(tpl, p["wo"], out)
    return out, new_cache
