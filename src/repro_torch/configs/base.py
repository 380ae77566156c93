"""Architecture configuration schema + registry, in the port.

The port's copy of ``repro.configs.base``: every architecture is a frozen
:class:`ArchConfig` (the same fields and defaults, so a config prints the
same in both packages); :func:`reduced` derives the small variant of the
same family that the CPU tests run.  The registry holds every config the
reference registers; the input shapes of the dry-run matrix live in
:data:`SHAPES`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "register", "get_config", "all_configs",
           "reduced", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # pad q-heads to this count (0 = no padding); wq / wo are sized by it
    n_heads_padded: int = 0

    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 1e4
    use_rope: bool = True
    abs_pos: bool = False  # add sinusoidal absolute positions at the embedding

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 512

    # hybrid recurrent width (0 => d_model)
    d_rec: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid: repeating block pattern + local-attention window
    pattern: tuple = ()
    window: int = 0

    # encoder-decoder: n_layers = decoder layers
    n_encoder_layers: int = 0
    n_frames: int = 1500

    # VLM: every Nth layer is a gated cross-attention layer
    cross_attn_period: int = 0
    n_image_tokens: int = 1600

    dtype: str = "bfloat16"
    remat: bool = True
    train_accum: int = 1
    remat_policy: str = ""
    notes: str = ""
    rule_overrides: tuple = ()
    serve_rule_overrides: tuple = ()

    @property
    def eff_heads(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def attends_full(self) -> bool:
        """True when sequence mixing is quadratic full attention everywhere."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.window:
            return False
        return True

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn = qkv + self.n_heads * self.head_dim * d
        if self.act == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts  # + router
        per_layer = attn + mlp
        total = self.n_layers * per_layer
        if self.family == "ssm":
            di, ds, g, nh = self.d_inner, self.ssm_state, self.ssm_ngroups, self.ssm_nheads
            in_proj = d * (2 * di + 2 * g * ds + nh)
            out_proj = di * d
            total = self.n_layers * (in_proj + out_proj + self.ssm_conv * (di + 2 * g * ds))
        if self.family == "hybrid" and self.pattern:
            # rec layers replace attn with linear-recurrent block of ~3*d*d
            n_rec = sum(1 for i in range(self.n_layers) if self.pattern[i % len(self.pattern)] == "rec")
            n_att = self.n_layers - n_rec
            rec = 3 * d * d
            total = n_att * (attn + mlp) + n_rec * (rec + mlp)
        if self.family == "encdec":
            enc = self.n_encoder_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)  # self + cross
            total = enc + dec
        if self.family == "vlm" and self.cross_attn_period:
            n_cross = self.n_layers // self.cross_attn_period
            total = (self.n_layers - n_cross) * (attn + mlp) + n_cross * (attn + mlp + attn)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return total + embed

    def n_params_active(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn = qkv + self.n_heads * self.head_dim * d
        mlp_active = self.top_k * 3 * d * ff + d * self.n_experts
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp_active) + embed


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence per step
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (populates the registry)

    return _REGISTRY[name]()


def all_configs() -> dict[str, ArchConfig]:
    from repro_torch import configs as _c  # noqa: F401

    return {k: v() for k, v in _REGISTRY.items()}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether a dry-run cell runs (DESIGN.md §5 skip rules)."""
    if shape.name == "long_500k" and cfg.attends_full:
        return False, "full quadratic attention: 512k decode skipped per spec"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family variant for CPU tests (the reference's rule)."""
    period = len(cfg.pattern) if cfg.pattern else 1
    n_layers = max(2, period) if cfg.family != "vlm" else max(2, cfg.cross_attn_period)
    if cfg.family == "vlm":
        n_layers = cfg.cross_attn_period
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, 2 * kv)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        n_heads_padded=0,
        train_accum=1,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.family != "moe" else 32,
        vocab=128,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else cfg.ssm_headdim,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_frames=8 if cfg.n_encoder_layers else cfg.n_frames,
        window=16 if cfg.window else 0,
        n_image_tokens=8 if cfg.family == "vlm" else cfg.n_image_tokens,
        dtype="float32",
        remat=False,
    )
