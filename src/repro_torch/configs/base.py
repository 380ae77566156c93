"""Architecture configuration schema + registry, in the port.

The port's copy of ``repro.configs.base``: every architecture is a frozen
:class:`ArchConfig` (the same fields and defaults, so a config prints the
same in both packages); :func:`reduced` derives the small variant of the
same family that the CPU tests run.  The registry holds the families the
port runs; others arrive with their families (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ArchConfig", "register", "get_config", "all_configs", "reduced"]


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
    def attends_full(self) -> bool:
        """True when sequence mixing is quadratic full attention everywhere."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.window:
            return False
        return True


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not ported yet (ported: {sorted(_REGISTRY)}; "
                       f"the other families are ROADMAP queue 1 item 6)")
    return _REGISTRY[name]()


def all_configs() -> dict[str, ArchConfig]:
    from repro_torch import configs as _c  # noqa: F401

    return {k: v() for k, v in _REGISTRY.items()}


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
