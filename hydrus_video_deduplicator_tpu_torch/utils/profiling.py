"""Profiling and tracing utilities (counterpart of the JAX package's
``utils/profiling.py``, with the same signatures):

- :func:`trace_to` — capture a ``torch.profiler`` trace of a code block,
  host and, where a CUDA device is present, device activity, as a Chrome
  trace in ``log_dir`` (open it in Perfetto or ``chrome://tracing``).
- :func:`device_timer` — mean seconds a call of a device computation,
  waiting on the card with CUDA events instead of a host copy.
- :func:`device_busy_share` — the share of a trace's window in which a
  CUDA kernel ran (1 minus the device's idle share).
- :class:`Laps` and :func:`debug_timing` — stage 4's opt-in trace, switched
  on by the environment variable ``HVD_DEBUG_TIMING`` as in the JAX
  package: ``[chunk-timing]``, ``[prune-timing]``, ``[seg-timing]`` and
  ``[verify-timing]`` lines of host wall time in the JAX package's formats.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections.abc import Callable, Iterator

import torch

#: the file trace_to writes into its log_dir
TRACE_FILE = "trace.json"
#: any non-empty value switches stage 4's timing lines on
DEBUG_TIMING_ENV = "HVD_DEBUG_TIMING"


def debug_timing() -> bool:
    """Whether ``HVD_DEBUG_TIMING`` is set; read at each call, so a timed
    function reads it once each time it runs."""
    return bool(os.environ.get(DEBUG_TIMING_ENV))


class Laps:
    """Lap printer of one tag: ``laps(label)`` prints ``f"{tag} {label}:
    {seconds:.1f}s"`` on stdout, the host wall time since the previous lap
    (or since the printer was made). The label is a ``str.format`` pattern
    filled with ``counts``, so a lap builds no string when the timing is
    off. Made once per call of the timed function, it reads
    ``HVD_DEBUG_TIMING`` then; with the variable unset, a lap does nothing.
    """

    def __init__(self, tag: str):
        self.tag = tag
        self.on = debug_timing()
        self._t0 = time.perf_counter() if self.on else 0.0

    def __call__(self, label: str, *counts: int) -> None:
        if self.on:
            now = time.perf_counter()
            print(f"{self.tag} {label.format(*counts)}: {now - self._t0:.1f}s", flush=True)
            self._t0 = now


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json``. Yields the profiler, whose ``events()`` hold
    the trace's events once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_timer(step: Callable, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call of ``step(i)``.

    With CUDA present the iterations are timed with CUDA events on the
    current stream, so the time is the card's, not the enqueue's; without
    it (the CPU) it is wall time. Iterations should be chained by the
    caller if overlap must be excluded.
    """
    for i in range(warmup):
        step(i)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            step(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for i in range(iters):
        step(i)
    return (time.perf_counter() - t0) / iters


def device_busy_share(trace_file: str) -> tuple[float, float, int]:
    """(busy seconds, window seconds, kernel events) of a Chrome trace that
    trace_to wrote: the union of the CUDA kernels' intervals, and the span
    from the first event of the trace to the end of its last."""
    with open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if not events:
        return 0.0, 0.0, 0
    start = min(float(e["ts"]) for e in events)
    stop = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    kernels = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        for e in events
        if e.get("cat") == "kernel"
    )
    busy, end = 0.0, start
    for a, b in kernels:  # union of the intervals, in order of start
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, (stop - start) / 1e6, len(kernels)
