"""internlm2-1.8b — dense GQA.  [arXiv:2403.17297; hf]"""
from .base import ArchConfig, register


@register
def internlm2_1_8b() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92544,
        rope_theta=1e6,
        notes="GQA kv=8; full attention (long_500k skipped)",
    )
