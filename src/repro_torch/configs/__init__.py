"""Architecture registry: importing this package registers every config, the
reference's ten (``--arch <id>``)."""
from .base import (
    ArchConfig,
    SHAPES,
    ShapeSpec,
    all_configs,
    get_config,
    reduced,
    register,
    shape_applicable,
)

from . import (  # noqa: F401  (importing registers each config)
    qwen2_5_32b,
    internlm2_1_8b,
    mistral_nemo_12b,
    qwen2_0_5b,
    whisper_medium,
    granite_moe_3b,
    phi3_5_moe,
    recurrentgemma_9b,
    mamba2_1_3b,
    llama3_2_vision_90b,
)

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "all_configs", "get_config", "reduced",
           "register", "shape_applicable"]
