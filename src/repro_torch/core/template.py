"""The paper's single templated compute unit, in the port.

Every GEMM-bearing layer calls :meth:`Template.matmul` / ``linear`` /
``conv2d``, which the :class:`~repro_torch.core.engine.Engine` dispatches to
one of three backends:

  * ``"cuda"``  — the hand-written CUDA kernels (``kernels/csrc``), planned
                  against the H100 spec; the analog of the reference's
                  ``pallas`` and the port's default.
  * ``"q16"``   — the paper's 16-bit fixed point (and the int8 rung) on the
                  fixed-point kernels.
  * ``"torch"`` — plain tensor ops, the analog of ``xla``; used only when a
                  caller names it.

``TemplateConfig.device`` says where the template runs (default
``"cuda"``).  Asking for CUDA on a host without a card raises; the port
never drops to the CPU by itself.  The reference's ``interpret`` flag has
no counterpart: a CUDA kernel has no interpret mode, and the plain version
behind each wrapper runs exactly when its operands lie on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, Optional

import torch

from .quantization import Q2_14, QFormat
from .tiling import H100, MatmulBlock, Spec

__all__ = ["Template", "TemplateConfig", "default_template"]

Backend = Literal["torch", "cuda", "q16"]
_BACKENDS = ("torch", "cuda", "q16")


@dataclasses.dataclass(frozen=True)
class TemplateConfig:
    """Hardware-specification half of the template."""

    backend: Backend = "cuda"
    block: Optional[MatmulBlock] = None  # None => the DSE picks per shape
    qformat: QFormat = Q2_14
    hw: Spec = H100
    device: str = "cuda"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} (want one of "
                             f"{_BACKENDS})")
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TemplateConfig(device={self.device!r}) asks for a CUDA card, but "
                f"torch.cuda.is_available() is False on this host; pass "
                f"device='cpu' to run the plain versions on the CPU"
            )


@dataclasses.dataclass(frozen=True)
class Template:
    config: TemplateConfig = dataclasses.field(default_factory=TemplateConfig)

    @functools.cached_property
    def engine(self):
        """The execution engine for this config (shares the plan registry)."""
        from .engine import Engine

        return Engine(self.config)

    def quant(self, x, fmt: Optional[QFormat] = None):
        """Float -> QTensor on the activation grid (counted island exit)."""
        return self.engine.quant(x, fmt)

    def dequant(self, q, fmt: Optional[QFormat] = None, dtype=torch.float32):
        """QTensor / raw -> float (counted island entry)."""
        return self.engine.dequant(q, fmt, dtype)

    def matmul(self, x, w, **kw):
        """``x @ w`` where x: (..., k), w: (k, n); leading dims flatten into M."""
        return self.engine.matmul(x, w, **kw)

    def linear(self, x, w, b=None, **kw):
        return self.engine.linear(x, w, b, **kw)

    def conv2d(self, x, w, stride: int = 1, padding=0, **kw):
        """NHWC conv: x (N, H, W, Cin), w (K, K, Cin, Cout) -> (N, Ho, Wo, Cout)."""
        return self.engine.conv2d(x, w, stride=stride, padding=padding, **kw)


def default_template(backend: Backend = "cuda", **kw) -> Template:
    return Template(TemplateConfig(backend=backend, **kw))
