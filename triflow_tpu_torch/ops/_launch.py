"""What every kernel wrapper shares: launch counters, input checks and the
stream to launch on."""

from __future__ import annotations

import torch

#: every launch counter, by kernel entry name
COUNTERS = {}


class Counter:
    """Plain count of one kernel entry's launches, added to by its wrapper
    right where it launches."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def add(self):
        self.count += 1


def reset_counters():
    for counter in COUNTERS.values():
        counter.count = 0


def counts() -> dict:
    return {name: c.count for name, c in COUNTERS.items()}


def check_cuda(tensors, dtype, what: str):
    """Raise unless every tensor is a contiguous tensor of ``dtype``
    (float32 or float64) on the current CUDA device, where the kernel
    launches."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} is not float32 or float64")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: tensor on {t.device}, the kernel "
                             "takes CUDA tensors")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what}: tensor on {t.device}, but the current "
                             f"device is cuda:{torch.cuda.current_device()}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: tensor of {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")


def check_shapes(what: str, **named):
    """Raise unless each ``name=(tensor, shape)`` tensor has that shape."""
    for name, (t, shape) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def suffix(dtype) -> str:
    """The C entry suffix of an element type."""
    return {torch.float32: "f32", torch.float64: "f64"}[dtype]


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
