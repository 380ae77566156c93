"""whisper-medium — encoder-decoder audio backbone; conv/mel frontend is a
STUB per the assignment (input_specs supplies precomputed frame embeddings,
1500 frames = 30 s window after the 2x conv stride).  [arXiv:2212.04356]"""
from .base import ArchConfig, register


@register
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,           # decoder layers
        n_encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,         # MHA
        head_dim=64,
        d_ff=4096,
        vocab=51865,
        norm="layernorm",
        act="gelu",
        use_rope=False,
        abs_pos=True,
        n_frames=1500,
        train_accum=2,
        notes="enc-dec; sinusoidal positions; cross-attn every decoder layer",
    )
