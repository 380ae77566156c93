"""recurrentgemma-9b — hybrid RG-LRU + local attention, pattern 2:1
(two recurrent blocks then one 2048-window attention block).
[arXiv:2402.19427]"""
from .base import ArchConfig, register


@register
def recurrentgemma_9b() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,          # MQA on the attention blocks
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        train_accum=4,
        pattern=("rec", "rec", "attn"),
        window=2048,
        act="swiglu",
        tie_embeddings=True,
        notes="sub-quadratic (RG-LRU + windowed attn) => long_500k runs",
    )
