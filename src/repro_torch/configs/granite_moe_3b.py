"""granite-moe-3b-a800m — MoE 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from .base import ArchConfig, register


@register
def granite_moe_3b() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,              # per-expert FFN width
        vocab=49155,
        n_heads_padded=32,   # 24 heads -> 2/shard (§Perf)
        train_accum=4,
        n_experts=40,
        top_k=8,
        tie_embeddings=True,
        notes="40e top-8; 40 does not divide 16-way model, so EP shards the "
              "capacity dim instead (a batch dim of every expert GEMM: all "
              "expert compute is reduction-free; see §Perf cell B)",
        rule_overrides=(("experts", None), ("expert_cap", "model")),
        # serving: shard the (model-replicated under capacity-EP) expert
        # weights over the per-expert FFN dim + ZeRO the rest
        serve_rule_overrides=(("expert_mlp", "model"), ("expert_cap", None),
                              ("embed", "data")),
    )
