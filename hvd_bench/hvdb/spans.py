"""Host spans around the calls into the program's layers, and CUDA events
around its kernel wrappers, installed from the benchmark's side in a traced
run only and kept in memory.

The program is not edited: each target is an attribute of one of its
modules or classes, looked up where the program looks it up at call time,
replaced by a wrapper for the traced run and put back afterwards.

A target is written ``"package.module:name"`` or
``"package.module:Class.method"``. Each span also opens a
``torch.profiler.record_function`` of its label, so the device trace can
say which span the host was in during an idle gap. Only calls on the
thread that installed a span are recorded: a step's time is that thread's,
and a call on a helper thread (the orchestrator's row prefetch) overlaps it.
"""

from __future__ import annotations

import importlib
import threading
import time
from dataclasses import dataclass, field


def synchronize() -> None:
    """Wait for every visible CUDA device (a cell over several runs on all)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def resolve(target: str):
    """(owner, attribute name) of a ``"module:attr[.attr]"`` target."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, name = path.split(".")
    for part in parents:
        owner = getattr(owner, part)
    return owner, name


@dataclass
class Launch:
    start: object  # torch.cuda.Event
    end: object
    work: tuple  # (frame pairs, bytes), ints or device scalars until read

    def seconds(self) -> float:
        return self.start.elapsed_time(self.end) / 1e3


@dataclass
class Spans:
    """Each label's (start, end) host intervals and each kernel's launches."""

    calls: dict = field(default_factory=dict)  # label -> [(t0, t1)]
    launches: dict = field(default_factory=dict)  # kernel name -> [Launch]
    _restore: list = field(default_factory=list)

    def wrap(self, target: str, label: str, sync: bool = False) -> None:
        """Record each call of ``target`` under ``label``; with ``sync``,
        wait for the device at both edges, so the span holds the device
        work its calls enqueued."""
        import torch

        owner, name = resolve(target)
        real = getattr(owner, name)
        calls = self.calls.setdefault(label, [])
        synced = sync and torch.cuda.is_available()
        main = threading.get_ident()

        def spanned(*args, **kwargs):
            if threading.get_ident() != main:
                return real(*args, **kwargs)
            if synced:
                synchronize()
            with torch.profiler.record_function(label):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    if synced:
                        synchronize()
                    calls.append((t0, time.perf_counter()))

        setattr(owner, name, spanned)
        self._restore.append((owner, name, real))

    def wrap_kernel(self, target: str, name: str, work) -> None:
        """Time each call of the kernel wrapper ``target`` with CUDA events
        on the current stream, and keep ``work(args, out)``: (frame pairs,
        bytes) of the call, read once the window has closed."""
        import torch

        owner, attr = resolve(target)
        real = getattr(owner, attr)
        launches = self.launches.setdefault(name, [])

        def launched(*args):
            if args[0].device.type != "cuda":
                return real(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args)
            end.record()
            launches.append(Launch(start, end, work(args, out)))
            return out

        setattr(owner, attr, launched)
        self._restore.append((owner, attr, real))

    def restore(self) -> None:
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)
        self._restore.clear()

    def kernel_totals(self, name: str) -> tuple[int, float, int, int] | None:
        """(launches, device seconds, frame pairs, bytes) of a kernel, or
        None where it never launched."""
        calls = self.launches.get(name)
        if not calls:
            return None
        synchronize()
        seconds = sum(c.seconds() for c in calls)
        pairs = sum(int(c.work[0]) for c in calls)
        n_bytes = sum(int(c.work[1]) for c in calls)
        return len(calls), seconds, pairs, n_bytes

