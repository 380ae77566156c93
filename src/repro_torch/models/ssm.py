"""Mamba2 SSD (state-space duality) block, the attention-free sequence mixer,
in the port.

The port's copy of ``repro.models.ssm``.  The block's projections go
through the template's compute unit (``dense``); the SSD scan is not
GEMM-shaped and runs as plain tensor ops in f32 (the "PS plane"):

* :func:`ssd_chunked` — prefill / forward: the chunked SSD algorithm (Dao &
  Gu, arXiv:2405.21060, Listing 1), a Python loop over chunks (the
  reference's ``lax.scan``) carrying the inter-chunk state, one (Q x Q)
  intra-chunk matrix a head at a time;
* :func:`ssm_decode_step` — serving: the O(1) recurrent update
  ``h = exp(dt*A) h + dt * (B ⊗ x)``, ``y = C·h + D x``.  With ``inplace``
  it writes the new state and conv history into the cache tensors it was
  given, so a captured decode step advances them on every replay.

Layouts (B batch, S seq, H ssm heads, P head dim, G B/C groups, N state):
x (B,S,H,P), B / C (B,S,G,N), dt (B,S,H).

Under tensor-parallel training (``TRAIN_RULES``: "ssm_inner" over "model")
``in_proj`` is column-parallel and ``out_proj`` row-parallel.  The in
projection's output concatenates [z | x | B | C | dt] along the one
sharded axis, so a column shard cuts across those boundaries: the block
gathers it whole (and the sequence, which the scan reads end to end), runs
the conv, the scan and the gated RMSNorm (which normalizes over the whole
``d_inner``) replicated on the whole row with ``conv_w`` / ``conv_b`` /
``norm_scale`` gathered, and its row-parallel ``out_proj`` leaves the
partial sum the caller's seam reduce-scatters onto the sequence.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

from .layers import causal_conv, dense, init_dense, rms_norm, split_einsum

__all__ = [
    "init_ssm",
    "ssm_axes",
    "ssm_block",
    "ssm_decode_step",
    "init_ssm_cache",
    "ssd_chunked",
    "ssd_reference",
]


def _conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def _in_proj_dim(cfg) -> int:
    # z (d_inner) | xBC (conv_dim) | dt (nheads)
    return 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads


def init_ssm(gen: torch.Generator, cfg, dtype=torch.float32, *, lead: tuple = ()):
    h, dev = cfg.ssm_nheads, gen.device

    def per_head(v):
        return v.to(device=dev).expand(*lead, h).clone()

    return {
        "in_proj": init_dense(gen, cfg.d_model, _in_proj_dim(cfg), dtype=dtype, lead=lead),
        "conv_w": (torch.randn((*lead, cfg.ssm_conv, _conv_dim(cfg)), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, _conv_dim(cfg)), dtype=dtype, device=dev),
        # A in (-inf, 0): A = -exp(A_log), initialized in [-e, -1]
        "A_log": per_head(torch.log(torch.linspace(1.0, math.e, h))),
        "D": per_head(torch.ones(h)),
        "dt_bias": per_head(torch.log(torch.expm1(torch.full((h,), 0.01)))),
        "norm_scale": torch.zeros((*lead, cfg.d_inner), dtype=dtype, device=dev),
        "out_proj": init_dense(gen, cfg.d_inner, cfg.d_model, dtype=dtype,
                               scale=cfg.d_inner ** -0.5, lead=lead),
    }


def ssm_axes(cfg) -> dict:
    """Logical axes: the inner dim is the tensor-parallel axis."""
    return {
        "in_proj": {"w": ("embed", "ssm_inner")},
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_scale": ("ssm_inner",),
        "out_proj": {"w": ("ssm_inner", "embed")},
    }


def _split_in_proj(cfg, zxbcdt):
    di = cfg.d_inner
    cd = _conv_dim(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _split_xbc(cfg, xbc):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _expand_groups(m: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), each group repeated H/G times."""
    rep = h // m.shape[2]
    return torch.repeat_interleave(m, rep, dim=2) if rep > 1 else m


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD.  x: (B,S,H,P), dt: (B,S,H), A: (H,) negative, Bm / Cm:
    (B,S,H,N) (groups expanded).  Returns y: (B,S,H,P) in x's dtype [, the
    final state (B,H,P,N) f32].  A ragged last chunk is padded with dt = 0,
    which leaves the state as it was (decay exp(0) = 1, no input)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    s_orig = s
    if s % q:
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    f32 = torch.float32
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device) if init_state is None
             else init_state.to(f32))
    ys = []
    for c0 in range(0, s, q):
        xq = x[:, c0:c0 + q].to(f32)
        dtq = dt[:, c0:c0 + q].to(f32)
        bq = Bm[:, c0:c0 + q].to(f32)
        cq = Cm[:, c0:c0 + q].to(f32)
        cs = torch.cumsum(dtq * A[None, None, :], dim=1)  # (B,Q,H), within the chunk
        # intra-chunk: L[q1, q2] = exp(cs[q1] - cs[q2]) for q1 >= q2
        L = torch.where(tri, torch.exp(cs[:, :, None, :] - cs[:, None, :, :]), 0.0)
        xdt = xq * dtq[..., None]  # (B,Q,H,P) the discretized input
        scores = torch.einsum("bqhn,bkhn->bqkh", cq, bq)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores * L, xdt)
        # the carried state's contribution to every position of the chunk
        y_off = torch.einsum("bqhn,bhpn->bqhp", cq, state) * torch.exp(cs)[..., None]
        decay = torch.exp(cs[:, -1:, :] - cs)  # (B,Q,H) to the chunk's end
        state = (state * torch.exp(cs[:, -1, :])[:, :, None, None]
                 + torch.einsum("bkhn,bkhp->bhpn", bq * decay[..., None], xdt))
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)[:, :s_orig].to(x.dtype)
    return (y, state) if return_state else y


def ssd_reference(x, dt, A, Bm, Cm):
    """Sequential recurrence oracle (tests): an O(S) loop over time."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f32 = torch.float32
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t].to(f32) * A[None, :])  # (B,H)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, t].to(f32), x[:, t].to(f32),
                           Bm[:, t].to(f32))
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), state


def init_ssm_cache(cfg, batch: int, dtype, device="cpu") -> dict:
    return {
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dtype=dtype,
                            device=device),
    }


def ssm_block(tpl: Template, cfg, p, u, *, init_cache: Optional[dict] = None,
              return_cache: bool = False):
    """The whole Mamba2 block (forward / prefill).  u: (B,S,d_model)."""
    u = constrain(u, "batch", "seq", "act_embed")  # the scan reads every position
    zxbcdt = constrain(dense(tpl, p["in_proj"], u), "batch", None, None)  # the whole row
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    p = {**p, **sh.gather_params({k: p[k] for k in ("conv_w", "conv_b", "norm_scale")})}
    conv_state = None if init_cache is None else init_cache["conv"]
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, Bm, Cm = _split_xbc(cfg, F.silu(xbc))
    b, s, _ = x.shape
    h, pd, g, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    x = x.reshape(b, s, h, pd)
    Bm = _expand_groups(Bm.reshape(b, s, g, n), h)
    Cm = _expand_groups(Cm.reshape(b, s, g, n), h)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    init_state = None if init_cache is None else init_cache["state"]
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, init_state=init_state,
                                 return_state=True)
    y = y + x * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, cfg.d_inner)
    # gated RMSNorm (Mamba2): normalize y gated by silu(z)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    o = dense(tpl, p["out_proj"], y)
    if return_cache:
        return o, {"state": final_state, "conv": new_conv}
    return o


def ssm_decode_step(tpl: Template, cfg, p, u, cache: dict, *, inplace: bool = False):
    """One-token recurrent update.  u: (B,1,d_model) -> ((B,1,d_model), the
    cache).  ``inplace`` writes the new state and conv history into the
    tensors of ``cache`` and returns it; else ``cache`` is left as it was."""
    z, xbc, dt = _split_in_proj(cfg, dense(tpl, p["in_proj"], u))
    # conv step: append to the history, apply the taps at the last position
    hist = cache["conv"]  # (B, W-1, C)
    width = p["conv_w"].shape[0]
    window = torch.cat([hist.to(xbc.dtype), xbc], dim=1)  # (B,W,C)
    yconv = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(xbc.dtype))
    xbc1 = F.silu(yconv + p["conv_b"][None, :])[:, None, :]
    new_conv = window[:, 1:, :] if width > 1 else hist

    x, Bm, Cm = _split_xbc(cfg, xbc1)
    b = x.shape[0]
    h, pd, g, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    x = x.reshape(b, h, pd)
    Bm = _expand_groups(Bm.reshape(b, 1, g, n), h)[:, 0]
    Cm = _expand_groups(Cm.reshape(b, 1, g, n), h)[:, 0]
    dt = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])

    da = torch.exp(dt * A[None, :])  # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, x.to(torch.float32), Bm.to(torch.float32))
    state = cache["state"] * da[..., None, None] + upd
    y = split_einsum("bhpn,bhn->bhp", state, Cm.to(torch.float32)).to(x.dtype)
    y = y + x * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(b, 1, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    o = dense(tpl, p["out_proj"], y)
    if inplace:
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)
        return o, cache
    return o, {"state": state, "conv": new_conv}
