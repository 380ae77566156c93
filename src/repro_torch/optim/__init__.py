"""The port's optimizer: AdamW, learning-rate schedules, int8 gradient
compression (the port's copy of ``repro.optim``)."""
from .adamw import AdamW, OptState, adamw_init, adamw_update
from .schedules import constant, cosine_warmup, linear_warmup
from .compress import compress_int8, decompress_int8, compressed_grad_reduce

__all__ = [
    "AdamW",
    "OptState",
    "adamw_init",
    "adamw_update",
    "constant",
    "cosine_warmup",
    "linear_warmup",
    "compress_int8",
    "decompress_int8",
    "compressed_grad_reduce",
]
