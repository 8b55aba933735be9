"""Profiling hooks: XProf/Perfetto traces + wall-clock timing.

The reference has zero instrumentation (SURVEY.md §5 — the closest artifact
is a ``stepcount`` in dead code, ``Octree.cs:589,733``).  Here:

- :func:`trace_profile` wraps ``jax.profiler.trace`` so a consumer can dump
  a device trace (view with XProf/Perfetto) around any region.
- :func:`timed` measures steady-state wall time of a jitted callable with
  compile excluded, ending the timed region in ``jax.block_until_ready``.
- per-kernel occupancy statistics come from the kernels themselves
  (``shoot_grid(..., with_stats=True)`` returns per-ray march iterations).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax

__all__ = ["trace_profile", "timed"]


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a device trace for the enclosed region into ``log_dir``."""
    with jax.profiler.trace(log_dir):
        yield


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> Tuple[float, object]:
    """(seconds_per_call, last_result) for a jitted callable.

    Queues ``iters`` calls then blocks once on the last result, so per-call
    dispatch latency overlaps and the figure reflects device throughput.
    """
    result = None
    for _ in range(warmup):
        result = fn(*args)
    jax.block_until_ready(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
    jax.block_until_ready(result)
    return (time.perf_counter() - t0) / iters, result
