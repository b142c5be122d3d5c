"""Profiling and tracing utilities (counterpart of the JAX package's
``utils/profiling.py``, with the same signatures):

- :func:`trace_to` — capture a ``torch.profiler`` trace of a code block,
  host and, where a CUDA device is present, device activity, as a Chrome
  trace in ``log_dir`` (open it in Perfetto or ``chrome://tracing``).
- :func:`device_timer` — mean seconds a call of a device computation,
  waiting on the card with CUDA events instead of a host copy.
- :func:`device_busy_share` — the share of a trace's window in which a
  CUDA kernel ran (1 minus the device's idle share).
- the recorder: :func:`span` and :func:`count` mark stage 4's work where it
  happens; :func:`enable`, or the environment variable
  ``HVD_DEBUG_TIMING``, switches it on; :func:`records` returns the spans
  kept and :func:`clear` drops them.
- :class:`Laps` and :func:`debug_timing` — stage 4's opt-in trace, switched
  on by ``HVD_DEBUG_TIMING`` as in the JAX package: ``[chunk-timing]``,
  ``[prune-timing]``, ``[seg-timing]`` and ``[verify-timing]`` lines in the
  JAX package's formats, printed from the recorder's spans.

A span records its name, its start and end (``time.perf_counter_ns``), the
span it opened inside on the same thread, its thread, the outermost span
open on that thread when it opened (one ``find_pairs`` call; in the
orchestrator, one checkpoint chunk) and what :func:`count` added while it
was the innermost. On the main thread a span also opens a
``torch.profiler.record_function`` of its name, so that inside a profiler
run it lies on the timeline of the kernels and copies; spans on other
threads (the row prefetch) are kept by the recorder only. Records stay in
memory, at most ``MAX_RECORDS`` of them. Switched off, a span is one check
of a module flag and a shared null span, and a count one check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections.abc import Callable, Iterator

import torch

#: the file trace_to writes into its log_dir
TRACE_FILE = "trace.json"
#: any non-empty value switches stage 4's timing lines on
DEBUG_TIMING_ENV = "HVD_DEBUG_TIMING"


#: spans the recorder keeps; spans past it still time their lines
MAX_RECORDS = 1 << 18

_switch = False  # enable()
_env = False  # HVD_DEBUG_TIMING at its last read
_on = False  # _switch or _env: the one check a span makes
_records: list = []
_records_lock = threading.Lock()  # the cap's check and the append, across threads
_local = threading.local()
_ids = itertools.count(1)
_MAIN = threading.main_thread().ident


def _refresh() -> None:
    global _on
    _on = _switch or _env


def debug_timing() -> bool:
    """Whether ``HVD_DEBUG_TIMING`` is set; read at each call, so a timed
    function reads it once each time it runs. The recorder follows the
    variable from that read on: set, it records whatever :func:`enable`
    says."""
    global _env
    _env = bool(os.environ.get(DEBUG_TIMING_ENV))
    _refresh()
    return _env


def enable(on: bool = True) -> bool:
    """Switch the recorder on or off; returns whether the switch was on.
    ``HVD_DEBUG_TIMING`` keeps it on while set."""
    global _switch
    was, _switch = _switch, bool(on)
    _refresh()
    return was


def records() -> list:
    """The spans closed while the recorder was on (:class:`Span`), in the
    order they closed, at most ``MAX_RECORDS``."""
    return list(_records)


def clear() -> None:
    """Drop every record."""
    _records.clear()


class Span:
    """One span of work, a context manager (see the module's docstring).

    ``start`` and ``end`` are ``time.perf_counter_ns`` readings; ``parent``
    and ``call`` are span ids (``parent`` None at a thread's outermost
    span, whose ``call`` is its own ``id``); ``counts`` maps a count's name
    to its sum. Its direct children's nanoseconds are summed by name as
    they close (``child_seconds``), so a line printer needs no list of
    them."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start", "end", "counts",
                 "_children", "_up", "_annotation")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self._children: dict[str, int] = {}

    def __enter__(self) -> "Span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self._up = up
        self.parent = None if up is None else up.id
        self.call = self.id if up is None else up.call
        self.thread = threading.get_ident()
        self._annotation = None
        if self.thread == _MAIN:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._up is not None:
            siblings = self._up._children
            siblings[self.name] = siblings.get(self.name, 0) + self.end - self.start
        with _records_lock:
            if len(_records) < MAX_RECORDS:
                _records.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def child_seconds(self, *names: str) -> float:
        """Seconds of the direct children of these names, summed."""
        return sum(self._children.get(n, 0) for n in names) / 1e9


class _NullSpan:
    """What :func:`span` returns while the recorder is off: no time, no
    children, no counts."""

    seconds = 0.0
    counts: dict = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def child_seconds(self, *names: str) -> float:
        return 0.0


NULL_SPAN = _NullSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **counts: int) -> "Span | _NullSpan":
    """A span of ``name`` around the enclosed block, with ``counts`` as its
    first counts; while the recorder is off, the shared ``NULL_SPAN``."""
    if not _on:
        return NULL_SPAN
    return Span(name, counts)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread (nothing while the recorder is off or no span is open)."""
    if _on:
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


class Laps:
    """Line printer of one tag: ``laps(label)`` prints ``f"{tag} {label}:
    {seconds:.1f}s"`` on stdout, ``seconds`` being a span's where the caller
    passes it, else the host wall time since the previous lap (or since
    the printer was made). The label is a ``str.format`` pattern filled
    with ``counts``, so a lap builds no string when the timing is off.
    Made once per call of the timed function, it reads ``HVD_DEBUG_TIMING``
    then; with the variable unset, a lap does nothing.
    """

    def __init__(self, tag: str):
        self.tag = tag
        self.on = debug_timing()
        self._t0 = time.perf_counter_ns() if self.on else 0

    def __call__(self, label: str, *counts: int, seconds: float | None = None) -> None:
        if self.on:
            now = time.perf_counter_ns()
            if seconds is None:
                seconds = (now - self._t0) / 1e9
            print(f"{self.tag} {label.format(*counts)}: {seconds:.1f}s", flush=True)
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
