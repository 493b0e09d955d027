"""What every kernel wrapper shares: launch counters, input checks, the
short launch paths' shape cache and the stream to launch on."""

from __future__ import annotations

import functools

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


def check_cuda(tensors, dtype, what: str, shape=None):
    """Raise unless every tensor is a contiguous tensor of ``dtype``
    (float32 or float64) on the current CUDA device, where the kernel
    launches (and, with ``shape``, of that shape).  Reads the current
    device once; builds a message only for a tensor that fails."""
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise TypeError(f"{what}: dtype {dtype} is not float32 or float64")
    dev = None
    for t in tensors:
        d = t.get_device()
        if d != dev:
            if dev is not None or d < 0 or d != torch.cuda.current_device():
                _refuse(t, dtype, what)
            dev = d
        if (t.dtype is not dtype or not t.is_contiguous()
                or shape is not None and t.shape != shape):
            _refuse(t, dtype, what, shape)


def _refuse(t, dtype, what, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, the kernel "
                         "takes CUDA tensors")
    dev = torch.cuda.current_device()
    if t.get_device() != dev:
        raise ValueError(f"{what}: tensor on {t.device}, but the current "
                         f"device is cuda:{dev}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: tensor of {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor is not contiguous")
    raise ValueError(f"{what}: a tensor has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")


def check_shapes(what: str, **named):
    """Raise unless each ``name=(tensor, shape)`` tensor has that shape."""
    for name, (t, shape) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


#: the short launch paths' shape checks: (entry, shapes...) -> what the
#: entry's checks returned (its bound C entry and sizes), emptied when an
#: insert finds it full
_SHAPES = {}
MAX_SHAPES = 256


def shape_cache(key, make, *args):
    """``make(*args)`` (which checks the shapes, raises on a fault and binds
    the entry), run once per ``key`` and then read back.  A call that
    raises leaves nothing in the cache."""
    hit = _SHAPES.get(key)
    if hit is None:
        hit = make(*args)
        if len(_SHAPES) >= MAX_SHAPES:
            _SHAPES.clear()
        _SHAPES[key] = hit
    return hit


def suffix(dtype) -> str:
    """The C entry suffix of an element type."""
    return {torch.float32: "f32", torch.float64: "f64"}[dtype]


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s device, read once per process
    and device."""
    return _sms(t.get_device())
