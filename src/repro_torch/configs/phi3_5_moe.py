"""phi3.5-moe-42b-a6.6b — MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import ArchConfig, register


@register
def phi3_5_moe() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        train_accum=2,
        serve_rule_overrides=(("embed", "data"),),
        n_experts=16,
        top_k=2,
        norm="layernorm",
        notes="16e top-2; 16 experts divide the 16-way model axis exactly",
    )
