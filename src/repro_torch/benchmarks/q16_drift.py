"""The port's copy of the reference's ``benchmarks/q16_drift.py``, an alias:
the q16 end-to-end drift rows and their gates are emitted by
:mod:`repro_torch.benchmarks.precision_drift`, whose names it re-exports.

    PYTHONPATH=src python -m repro_torch.benchmarks.q16_drift --device cpu
"""
from __future__ import annotations

from repro_torch.benchmarks.precision_drift import (  # noqa: F401
    _agreement,
    lenet_activation_bytes,
    lenet_activation_elements,
    lenet_precision_sweep,
    lenet_row,
    main,
    train_lenet_qat,
    transformer_decode_bytes,
    transformer_decode_bytes_mixed,
    transformer_precision_sweep,
    transformer_row,
)

if __name__ == "__main__":
    main()
