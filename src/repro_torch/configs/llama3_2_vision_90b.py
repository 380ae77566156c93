"""llama-3.2-vision-90b — VLM text backbone with gated cross-attention image
layers every 5th layer; vision frontend is a STUB per the assignment
(input_specs supplies 1600 precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-90B-Vision]"""
from .base import ArchConfig, register


@register
def llama3_2_vision_90b() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        rope_theta=5e5,
        train_accum=4,  # microbatch 64: 2 seqs/chip on the 512-chip mesh (1/chip degenerates GSPMD reshape merges)
        serve_rule_overrides=(("embed", "data"),),  # 180 GB of weights cannot replicate over data
        cross_attn_period=5,
        n_image_tokens=1600,
        notes="100L = 80 self + 20 gated cross-attn; full attention",
    )
