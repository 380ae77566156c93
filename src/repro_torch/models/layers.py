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
the elementwise product), which the down projection's GEMM gathers, since
its weight holds the contraction whole.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import NumericsPolicy, QTensor
from repro_torch.core.template import Template
from repro_torch.parallel.sharding import carry_marks, constrain

__all__ = [
    "init_dense",
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
]


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None, lead: tuple = ()):
    """{"w": (*lead, d_in, d_out) N(0, scale²) [, "b": zeros]}; ``lead``
    stacks independent layers (the stacked ``blocks`` layout)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
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
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


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
             d_ff: Optional[int] = None, dtype=torch.float32, *, lead: tuple = ()):
    d = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "gate": init_dense(gen, d, ff, dtype=dtype, lead=lead),
            "up": init_dense(gen, d, ff, dtype=dtype, lead=lead),
            "down": init_dense(gen, ff, d, dtype=dtype, scale=ff ** -0.5, lead=lead),
        }
    return {
        "up": init_dense(gen, d, ff, dtype=dtype, lead=lead),
        "down": init_dense(gen, ff, d, dtype=dtype, scale=ff ** -0.5, lead=lead),
    }


def mlp_axes(cfg) -> dict:
    """Logical axes of :func:`init_mlp`'s tree."""
    if cfg.act == "swiglu":
        return {
            "gate": {"w": ("embed", "mlp")},
            "up": {"w": ("embed", "mlp")},
            "down": {"w": ("mlp", "embed")},
        }
    return {"up": {"w": ("embed", "mlp")}, "down": {"w": ("mlp", "embed")}}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(tpl: Template, cfg, p, x, policy: Optional[NumericsPolicy] = None):
    """FFN.  Under a quantized policy (QTensor weights) the projections run
    grid-resident: the post-norm input is quantized once and shared by
    gate / up, and only the nonlinearity (silu / gelu, a float island)
    crosses back to float; the down projection consumes the requantized
    activation directly."""
    if policy is not None and policy.quantized and isinstance(p["up"]["w"], QTensor):
        eng = tpl.engine
        xq = eng.quant(x, policy.fmt)
        u = eng.dequant(dense(tpl, p["up"], xq))
        if cfg.act == "swiglu":
            h = carry_marks(u, F.silu(eng.dequant(dense(tpl, p["gate"], xq))) * u)
        else:
            h = carry_marks(u, _gelu(u))
        h = constrain(h, "batch", None, "mlp")
        return eng.dequant(dense(tpl, p["down"], eng.quant(h, policy.fmt)))
    u = dense(tpl, p["up"], x)
    if cfg.act == "swiglu":
        h = carry_marks(u, F.silu(dense(tpl, p["gate"], x)) * u)
    else:
        h = carry_marks(u, _gelu(u))
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
