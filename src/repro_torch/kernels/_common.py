"""Argument checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["on_cpu", "ptr", "require_contiguous", "stream_of"]


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on the CPU (the wrapper then runs
    the plain version); False when all lie on one CUDA device (it launches
    the kernel).  Anything else raises: there is no silent move or fallback."""
    ts = [t for t in tensors if t is not None]
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require_contiguous(**tensors: Optional[torch.Tensor]) -> None:
    """The kernel reads dense row-major memory: raise on a strided view."""
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
