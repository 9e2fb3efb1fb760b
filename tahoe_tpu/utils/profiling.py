"""Timing & profiling utilities.

The reference's tracing is gettimeofday around warmup+timed epochs with device
sync fences (BaseTahoeTest.h:567-577). Here: one timing path — host clock
around calls that end in ``block_until_ready`` on device-resident inputs —
and an optional profiler trace wrapper.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List


def call_times(fn: Callable, *args, warmup: int = 2,
               iters: int = 10) -> List[float]:
    """Seconds of each of ``iters`` calls of ``fn(*args)`` after ``warmup``
    untimed calls (the first compiles). Each call ends in
    ``block_until_ready``, so a time covers the device's work, not only the
    dispatch."""
    import jax

    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def time_call(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median seconds per call (see :func:`call_times`)."""
    import numpy as np

    return float(np.median(call_times(fn, *args, warmup=warmup, iters=iters)))


@contextlib.contextmanager
def xla_trace(logdir: str):
    """jax.profiler trace context (viewable in TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
