"""Device timing and the least-time bound, shared by the benchmark scripts and
``chip_smoke.py``.

:func:`time_ms` times a callable on the card with CUDA events;
:func:`bound` is the least time the card could take for a piece of work:
the larger of its bytes over the HBM rate and its operations over the
peak rate of their type (``core/tiling.py:H100``).
"""
from __future__ import annotations

import math

from repro_torch.core.tiling import H100


def time_ms(fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over repeated calls, by CUDA events, after
    a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    reps = max(3, min(50, math.ceil(target_ms / est)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int, peak: float, hbm_bw: float = H100.hbm_bw
          ) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): ``nbytes`` moved at ``hbm_bw`` against
    ``ops`` done at ``peak`` per second, whichever takes longer."""
    t_bytes = nbytes / hbm_bw * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
