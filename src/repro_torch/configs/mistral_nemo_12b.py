"""mistral-nemo-12b — dense GQA, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from .base import ArchConfig, register


@register
def mistral_nemo_12b() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        train_accum=2,
        vocab=131072,
        rope_theta=1e6,
        notes="GQA kv=8; attention dim 4096 != d_model; full attention",
    )
