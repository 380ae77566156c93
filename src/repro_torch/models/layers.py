"""Shared neural-net layers (functional, dictionary params), in the port.

The port's copy of ``repro.models.layers``.  Every GEMM goes through the
template's compute unit; norms, RoPE and the activations run as plain
tensor ops (the "PS plane"), with the reference's casts: ``rms_norm`` and
``layer_norm`` compute in f32 and return the input's dtype, RoPE angles are
f32.  Initializers draw from a ``torch.Generator`` on its own device, so a
CUDA generator builds a full-width model on the card directly.

The MLP's hidden activation passes the reference's sharding seam
(``constrain(h, "batch", None, "mlp")``): on a rank holding column shards
of gate / up it is a column shard itself (its shard mark carried through
the elementwise product).  Under column-parallel decode the down
projection's GEMM gathers it, since its weight holds the contraction
whole; under tensor-parallel training (``TRAIN_RULES``) the down weight is
row-parallel, so the GEMM's output is a partial sum that the caller's seam
reduce-scatters onto the sequence.  A sequence-parallel input is gathered
whole once, before gate / up.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import NumericsPolicy, QTensor
from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import carry_marks, constrain

__all__ = [
    "init_dense",
    "init_normal",
    "dense",
    "mlp_islands",
    "rms_norm",
    "layer_norm",
    "norm",
    "init_norm",
    "apply_rope",
    "init_mlp",
    "mlp",
    "mlp_axes",
    "sinusoidal_positions",
    "causal_conv",
    "gelu",
    "cross_entropy_loss",
]


def init_normal(gen: torch.Generator, shape: tuple, scale: float, dtype, *,
                lead: tuple = (), sharding=None) -> torch.Tensor:
    """(*lead, *shape) drawn N(0, scale²) in f32 and rounded once to
    ``dtype``, one stacked layer (a ``shape`` draw) at a time, so no more
    than one layer is ever held in f32.  ``sharding`` (the leaf's
    :class:`~repro_torch.parallel.sharding.NamedSharding`, its stacked dims
    whole) cuts each layer to this rank's shard as it is drawn: the rank
    never holds the whole leaf, and its shard equals the unsharded draw
    cut (the draws are the same)."""
    spec = tuple(sharding.spec) if sharding is not None else ()
    if any(a is not None for a in spec[:len(lead)]):
        raise ValueError(f"init_normal: stacked dims are drawn whole, got {spec}")
    inner = None if sharding is None else sh.NamedSharding(
        sharding.mesh, sh.PartitionSpec(*spec[len(lead):]))
    # the shard's shape and marks (marks count dims from the end)
    like = torch.empty(shape, device="meta")
    like = like if inner is None else sh.shard_tree(like, inner)
    out = torch.empty((*lead, *like.shape), dtype=dtype, device=gen.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        w = torch.randn(shape, generator=gen, device=gen.device)
        if inner is not None:
            w = sh.shard_tree(w, inner)  # a contiguous copy of the shard
        out[idx] = w.mul_(scale).to(dtype)
    return sh.mark_shard(out, sh.shard_marks(like))


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None, lead: tuple = (),
               shardings=None):
    """{"w": (*lead, d_in, d_out) N(0, scale²) [, "b": zeros]}; ``lead``
    stacks independent layers (the stacked ``blocks`` layout);
    ``shardings`` (the subtree's, see :func:`init_normal`) cuts "w" as it
    is drawn and "b" once made."""
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": init_normal(gen, (d_in, d_out), scale, dtype, lead=lead,
                          sharding=sh.subtree(shardings, "w"))}
    if bias:
        b = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
        p["b"] = b if shardings is None else sh.shard_tree(b, sh.subtree(shardings, "b"))
    return p


def dense(tpl: Template, p, x, *, relu: bool = False):
    """Linear layer with the bias (and optional ReLU) fused into the kernel."""
    return tpl.linear(x, p["w"], p.get("b"), relu=relu)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def norm(cfg, p, x):
    """The config's norm over the last dim; a row shard stays marked (a
    sequence-parallel residual stream normalizes in place)."""
    if cfg.norm == "layernorm":
        return carry_marks(x, layer_norm(x, p["scale"], p["bias"]))
    return carry_marks(x, rms_norm(x, p["scale"]))


def init_norm(cfg, dtype=torch.float32, *, device="cpu", lead: tuple = ()):
    shape = (*lead, cfg.d_model)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, d_model: Optional[int] = None,
             d_ff: Optional[int] = None, dtype=torch.float32, *, lead: tuple = (),
             shardings=None):
    d = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff

    def one(name, d_in, d_out, scale=None):
        return init_dense(gen, d_in, d_out, dtype=dtype, scale=scale, lead=lead,
                          shardings=sh.subtree(shardings, name))

    p = {"gate": one("gate", d, ff)} if cfg.act == "swiglu" else {}
    p["up"] = one("up", d, ff)
    p["down"] = one("down", ff, d, ff ** -0.5)
    return p


def mlp_axes(cfg) -> dict:
    """Logical axes of :func:`init_mlp`'s tree."""
    if cfg.act == "swiglu":
        return {
            "gate": {"w": ("embed", "mlp")},
            "up": {"w": ("embed", "mlp")},
            "down": {"w": ("mlp", "embed")},
        }
    return {"up": {"w": ("embed", "mlp")}, "down": {"w": ("mlp", "embed")}}


def gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(tpl: Template, cfg, p, x, policy: Optional[NumericsPolicy] = None):
    """FFN.  Under a quantized policy (QTensor weights) the projections run
    grid-resident: the post-norm input is quantized once and shared by
    gate / up, and only the nonlinearity (silu / gelu, a float island)
    crosses back to float; the down projection consumes the requantized
    activation directly."""
    # the whole sequence for the column-parallel gate / up (one all-gather
    # of a sequence-parallel input, shared by both)
    x = constrain(x, "batch", "seq", "act_embed")
    if policy is not None and policy.quantized and isinstance(p["up"]["w"], QTensor):
        eng = tpl.engine
        xq = eng.quant(x, policy.fmt)
        u = eng.dequant(dense(tpl, p["up"], xq))
        if cfg.act == "swiglu":
            h = carry_marks(u, F.silu(eng.dequant(dense(tpl, p["gate"], xq))) * u)
        else:
            h = carry_marks(u, gelu(u))
        h = constrain(h, "batch", None, "mlp")
        return eng.dequant(dense(tpl, p["down"], eng.quant(h, policy.fmt)))
    u = dense(tpl, p["up"], x)
    if cfg.act == "swiglu":
        h = carry_marks(u, F.silu(dense(tpl, p["gate"], x)) * u)
    else:
        h = carry_marks(u, gelu(u))
    h = constrain(h, "batch", None, "mlp")
    return dense(tpl, p["down"], h)


def mlp_islands(cfg) -> dict:
    """Designated float islands of one quantized FFN: (quantize, dequantize)
    call counts.  swiglu: quant {x, silu*up product}, dequant {gate, up,
    down}; gelu: quant {x, gelu out}, dequant {up, down}."""
    if cfg.act == "swiglu":
        return {"quantize": 2, "dequantize": 3}
    return {"quantize": 2, "dequantize": 2}


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (..., V), upcast to f32 before the logsumexp; labels: (...)
    int.  The mean negative log-likelihood, over ``mask`` (f32, 1 = counted)
    when given: sum(nll * mask) / max(sum(mask), 1).  ``count`` replaces
    sum(mask) in the denominator (a data-parallel rank's share of a global
    mean: the whole batch's count)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum() if count is None else count, min=1)
    return nll.mean()


def _padded_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (rows first) in a new tensor of ``n`` rows, its rows first and
    zeros after, its dims in ``x``'s memory order: the layout an ``n``-row
    ``x`` has."""
    order = sorted(range(x.ndim), key=lambda d: (-x.stride(d), d))
    buf = x.new_zeros([n if d == 0 else x.shape[d] for d in order])
    buf = buf.permute(*[order.index(d) for d in range(x.ndim)])
    buf[:x.shape[0]].copy_(x)
    return buf


def split_einsum(eq: str, *operands) -> torch.Tensor:
    """``torch.einsum`` with a data split's rows: on a rank of a data-split
    step (``sharding.batch_split``) the operands' rows (dim 0) are padded
    with zero rows to the logical batch, laid out as the unsplit step lays
    them out, and the result is cut back to the rank's rows.  A batched
    contraction's library kernel, and with it the order of its sums, follows
    the row count; padded, the rank makes the call one device makes, and
    each of its rows gets the bits it gets there (a batched call computes
    each batch entry alike wherever it sits).  Without a split it is
    ``torch.einsum``."""
    f = sh.active_batch_split() if sh.active_mesh() is not None else 1
    if f == 1:
        return torch.einsum(eq, *operands)
    b = operands[0].shape[0]
    return torch.einsum(eq, *(_padded_rows(o, b * f) for o in operands))[:b]


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv over time (the recurrent blocks' short conv).
    x: (B,S,C), w: (W,C), b: (C,); ``state``: the W-1 inputs before x (zeros
    when None).  Returns (y, new_state), the state the last W-1 inputs."""
    width = w.shape[0]
    if state is None:
        hist = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)  # (B, S+W-1, C)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):, :].clone() if width > 1 else hist
    return y + b[None, None, :], new_state
