"""mamba2-1.3b — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from .base import ArchConfig, register


@register
def mamba2_1_3b() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,             # attention-free
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab=50280,
        train_accum=2,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
        use_rope=False,
        notes="SSD chunked scan; O(1) decode state => long_500k runs",
    )
