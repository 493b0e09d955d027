"""Tracing and profiling helpers.

Counterpart of ``triflow_tpu.utils.profiling``: ``trace`` records a
``torch.profiler`` trace of what runs inside it (host calls and, on the
card, every kernel) and exports it as a Chrome trace into ``logdir``;
``step_breakdown`` splits the wall time of a few output steps into the
scheme's time (the simulation's own timer) and the rest, synchronising
the card where the reference blocks on its arrays.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace of the block, written to
    ``logdir/trace.json`` (open with chrome://tracing or Perfetto); the
    card's kernels are recorded where torch sees one.

    >>> with trace("/tmp/tb"):          # doctest: +SKIP
    ...     simulation.run()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(logdir / "trace.json"))


def step_breakdown(simulation, n=5):
    """Run n output steps and split wall time into the scheme's calls
    (``device_s``: the simulation's timer) and the rest (``host_s``).

    Returns dict(total_s, device_s, host_s, per_step_s)."""
    total = 0.0
    device = 0.0
    for _ in range(n):
        start = time.perf_counter()
        _t, fields = next(simulation)
        # wait for the new state: everything after this point was host time
        if any(isinstance(fields[k], torch.Tensor) and fields[k].is_cuda
               for k in fields.keys()):
            torch.cuda.synchronize()
        total += time.perf_counter() - start
        device += simulation._last_running
    return {
        "total_s": total,
        "device_s": device,
        "host_s": max(total - device, 0.0),
        "per_step_s": total / n,
    }
