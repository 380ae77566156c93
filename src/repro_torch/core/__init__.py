"""Numerics, tiling, design-space exploration (device and FPGA planes, and
the per-layer precision DSE), the FPGA model, the engine and the template."""
from .dse import (
    ConvTileChoice,
    DseResult,
    choose_precision,
    default_block_for,
    default_conv_tile_for,
    explore_board,
)
from .engine import (
    ConvPlan,
    Engine,
    GemmPlan,
    PlanRegistry,
    PrecisionChoice,
    plan_cache_for,
    reset_plan_caches,
)
from .fpga_model import (
    BOARDS,
    Board,
    LayerSpec,
    NetworkReport,
    TemplateInstance,
    evaluate_network,
)
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
    qmatmul_real,
    qmatmul_ref,
    quantize,
    qtensor_matmul_ref,
    requantize_i32,
    requantize_i32_to_i16,
    shift_saturate_i32,
)
from .template import Template, TemplateConfig, default_template
from .tiling import H100, TPU_V5E, ConvTiling, FCTiling, GpuSpec, MatmulBlock, TpuSpec
