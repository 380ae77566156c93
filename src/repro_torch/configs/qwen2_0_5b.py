"""qwen2-0.5b — dense GQA, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""
from .base import ArchConfig, register


@register
def qwen2_0_5b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        n_heads_padded=16,
        tie_embeddings=True,
        rope_theta=1e6,
        notes="GQA kv=2; tied embeddings; full attention",
    )
