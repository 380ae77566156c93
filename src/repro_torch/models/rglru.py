"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427), in the port.

The port's copy of ``repro.models.rglru``.  The block's GEMMs (in / out
projections, gate matrices) go through the template's compute unit; the
element-wise linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(c * log_lambda * r_t),   c = 8,
    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x)

is not GEMM-shaped and runs as plain tensor ops in f32 (the "PS plane"):
:func:`_lru_scan` is a log-depth doubling scan for forward / prefill (12
steps at S = 4096, where a per-token loop would be 4096 launches a layer on
the card), :func:`rglru_decode_step` the O(1) update, which with
``inplace`` writes the new state and conv history into the cache tensors it
was given, so a captured decode step advances them on every replay.

Under tensor-parallel training (``TRAIN_RULES``: "rec" over "model") a
rank holds its columns of the recurrent width: ``in_x`` / ``in_y`` are
column-parallel (on the whole sequence, gathered once), the conv, ``lam``
and the scan run on its channels, the gate matrices ("rec_in", "rec") read
their input gathered whole over the channels, and ``out`` is row-parallel:
its partial sum is reduce-scattered onto the sequence by the caller's seam.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

from .layers import causal_conv, dense, gelu, init_dense

__all__ = [
    "init_rglru",
    "rglru_axes",
    "rglru_block",
    "rglru_decode_step",
    "init_rglru_cache",
    "rglru_reference",
]

_C = 8.0  # the RG-LRU's temperature constant


def _d_rec(cfg) -> int:
    return getattr(cfg, "d_rec", 0) or cfg.d_model


def init_rglru(gen: torch.Generator, cfg, dtype=torch.float32, *, lead: tuple = ()):
    d, dr, dev = cfg.d_model, _d_rec(cfg), gen.device
    # lambda such that a = sigmoid(lam)^(c*r) in (0, 1), a^c ~ U(0.9, 0.999) at init
    u = torch.rand((*lead, dr), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    root = u ** (1.0 / _C)
    return {
        "in_x": init_dense(gen, d, dr, dtype=dtype, lead=lead),
        "in_y": init_dense(gen, d, dr, dtype=dtype, lead=lead),
        "conv_w": (torch.randn((*lead, cfg.ssm_conv, dr), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, dr), dtype=dtype, device=dev),
        "gate_a": init_dense(gen, dr, dr, bias=True, dtype=dtype, lead=lead),
        "gate_x": init_dense(gen, dr, dr, bias=True, dtype=dtype, lead=lead),
        "lam": torch.log(root) - torch.log1p(-root),
        "out": init_dense(gen, dr, d, dtype=dtype, scale=dr ** -0.5, lead=lead),
    }


def rglru_axes(cfg) -> dict:
    return {
        "in_x": {"w": ("embed", "rec")},
        "in_y": {"w": ("embed", "rec")},
        "conv_w": (None, "rec"),
        "conv_b": ("rec",),
        "gate_a": {"w": ("rec_in", "rec"), "b": ("rec",)},
        "gate_x": {"w": ("rec_in", "rec"), "b": ("rec",)},
        "lam": ("rec",),
        "out": {"w": ("rec", "embed")},
    }


def _gates(tpl, p, x):
    """r_t, i_t and the log-decay log_a at each position.  x: (B,S,dr).  The
    gate matmuls are GEMMs on the template's compute unit; their weights
    are ("rec_in", "rec"), so a channel shard of x is gathered whole once,
    for both."""
    xw = constrain(x, "batch", None, "rec_in")
    r = torch.sigmoid(dense(tpl, p["gate_a"], xw))
    i = torch.sigmoid(dense(tpl, p["gate_x"], xw))
    log_lam = F.logsigmoid(p["lam"].to(torch.float32))  # log a_base < 0
    log_a = _C * log_lam[None, None, :] * r.to(torch.float32)  # (B,S,dr) <= 0
    return r, i, log_a


def _lru_scan(log_a: torch.Tensor, gated_x: torch.Tensor,
              init_h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (seq) by a Hillis–Steele doubling
    scan on the pair (a, b): ceil(log2 S) steps, each combining position i
    with position i - 2^j ((a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)).
    log_a, gated_x: (B,S,D) f32 (gated_x = sqrt(1-a^2) * i * x); init_h:
    (B,D), the carried state, folded into the first step's additive term."""
    a = torch.exp(log_a)
    b = gated_x
    if init_h is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * init_h.to(b.dtype)[:, None], b[:, 1:]], dim=1)
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_reference(log_a, gated_x, init_h=None):
    """Sequential loop oracle (tests)."""
    b, s, d = log_a.shape
    h = (torch.zeros((b, d), dtype=torch.float32, device=log_a.device) if init_h is None
         else init_h)
    out = []
    for t in range(s):
        h = torch.exp(log_a[:, t]) * h + gated_x[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def init_rglru_cache(cfg, batch: int, dtype, device="cpu") -> dict:
    dr = _d_rec(cfg)
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, dr), dtype=dtype, device=device),
    }


def _normalized_input(log_a, i, x):
    """sqrt(1 - a^2) * i * x in f32: the input normalizer keeps the state's
    variance bounded."""
    sq = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return sq * (i.to(torch.float32) * x.to(torch.float32))


def rglru_block(tpl: Template, cfg, p, u, *, init_cache: Optional[dict] = None,
                return_cache: bool = False):
    """The whole recurrent block (forward / prefill).  u: (B,S,d_model)."""
    u = constrain(u, "batch", "seq", "act_embed")  # the scan reads every position
    x = dense(tpl, p["in_x"], u)
    y = dense(tpl, p["in_y"], u)
    y = sh.carry_marks(y, gelu(y))
    conv_state = None if init_cache is None else init_cache["conv"]
    xc, new_conv = causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    x = constrain(sh.carry_marks(x, xc), "batch", None, "rec")
    _, i, log_a = _gates(tpl, p, x)
    init_h = None if init_cache is None else init_cache["h"]
    h = _lru_scan(log_a, _normalized_input(log_a, i, x), init_h).to(x.dtype)
    o = dense(tpl, p["out"], sh.carry_marks(y, h * y))
    if return_cache:
        return o, {"h": h[:, -1].to(torch.float32), "conv": new_conv}
    return o


def rglru_decode_step(tpl: Template, cfg, p, u, cache: dict, *, inplace: bool = False):
    """One-token update.  u: (B,1,d_model) -> ((B,1,d_model), the cache).
    ``inplace`` writes the new state and conv history into the tensors of
    ``cache`` and returns it; else ``cache`` is left as it was."""
    x = dense(tpl, p["in_x"], u)
    y = gelu(dense(tpl, p["in_y"], u))
    hist = cache["conv"]
    width = p["conv_w"].shape[0]
    window = torch.cat([hist.to(x.dtype), x], dim=1)  # (B,W,dr)
    xc = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype)) + p["conv_b"][None, :]
    new_conv = window[:, 1:, :] if width > 1 else hist
    xc = xc[:, None, :]
    _, i, log_a = _gates(tpl, p, xc)
    gated = _normalized_input(log_a, i, xc)
    h = torch.exp(log_a[:, 0]) * cache["h"] + gated[:, 0]  # (B,dr)
    o = dense(tpl, p["out"], h.to(x.dtype)[:, None, :] * y)
    if inplace:
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        return o, cache
    return o, {"h": h, "conv": new_conv}
