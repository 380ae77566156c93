"""qwen2.5-32b — dense GQA, QKV bias.  [hf:Qwen/Qwen2.5-32B; hf]"""
from .base import ArchConfig, register


@register
def qwen2_5_32b() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab=152064,
        qkv_bias=True,
        n_heads_padded=48,   # 40 heads -> 3/shard on 16-way TP (§Perf)
        train_accum=2,
        remat_policy="attn_out",  # skip attention recompute in bwd (§Perf iter 7)
        serve_rule_overrides=(("embed", "data"),),
        rope_theta=1e6,
        notes="GQA kv=8; QKV bias; full attention (long_500k skipped)",
    )
