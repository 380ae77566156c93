"""Numerics, tiling, design-space exploration, the engine and the template."""
from .dse import ConvTileChoice, default_block_for, default_conv_tile_for
from .engine import ConvPlan, Engine, GemmPlan, PlanRegistry, plan_cache_for, reset_plan_caches
from .quantization import (
    Q1_7,
    Q2_6,
    Q2_14,
    NumericsPolicy,
    QFormat,
    QTensor,
    calibrate_format,
    dequantize,
    fake_quant,
    fake_quant_fmt,
    int8_rung,
    quantize,
    qtensor_matmul_ref,
    requantize_i32,
    shift_saturate_i32,
)
from .template import Template, TemplateConfig, default_template
from .tiling import H100, TPU_V5E, GpuSpec, MatmulBlock, TpuSpec
