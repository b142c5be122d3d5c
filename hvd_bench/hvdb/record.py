"""What a traced run hands the per-layer readers, and how a reader is found.

A reader is ``hvd_bench/layers/<metric>.py`` or, where no such file is
there, ``hvd_bench/layers/<layer>.py`` for the part of the metric's name
before its first dot: one reader serves every cell that reports its layer
(``route_s.search`` and ``route_s.sweep`` both read ``route_s.py``). It
declares the spans and kernel wrappers it reads (installed for the traced run only) and a
``read(rec)`` that returns the metric's value, or None where the run gave
it nothing to read:

- ``SPANS``: (label, target, sync) — a host span around each call of
  ``target`` (``"module:attr[.attr]"``) on the run's main thread, with
  ``sync`` waiting for the device at both edges; several targets may share
  a label;
- ``KERNELS``: (name, target, work) — CUDA events around each call of a
  kernel wrapper, and ``work(args, out)``, its (frame pairs, bytes).
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

from . import roofline, trace
from .spans import Spans

LAYERS = Path(__file__).resolve().parents[1] / "layers"


def load_reader(metric: str):
    """The reader module of ``metric``: ``<metric>.py``, else the file of
    the name's first part."""
    path = LAYERS / f"{metric}.py"
    if not path.is_file():
        path = LAYERS / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location("hvdb_layer_" + metric.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def install(readers, spans: Spans) -> None:
    """Every span and kernel wrapper the readers declare, each once."""
    seen = set()
    for reader in readers:
        for label, target, sync in getattr(reader, "SPANS", ()):
            if (label, target) not in seen:
                seen.add((label, target))
                spans.wrap(target, label, sync)
        for name, target, work in getattr(reader, "KERNELS", ()):
            if ("kernel", name) not in seen:
                seen.add(("kernel", name))
                spans.wrap_kernel(target, name, work)


@dataclass
class Record:
    steps: list  # (t0, t1) host intervals of the window's steps
    spans: Spans
    summary: dict | None  # trace.summarize of the window, where traced on a device

    def _inside(self, label: str) -> list:
        calls = self.spans.calls.get(label, [])
        return trace.intersect(trace.union(calls), trace.union(self.steps))

    def per_step(self, label: str) -> float | None:
        """Seconds a step spent inside ``label``'s calls, or None where it
        was never called in the window."""
        inside = self._inside(label)
        if not inside:
            return None
        return trace.length(inside) / len(self.steps)

    def self_seconds(self, children) -> float:
        """Seconds a step spent outside every one of ``children``' calls."""
        covered = trace.union(c for label in children for c in self._inside(label))
        return (trace.length(trace.union(self.steps)) - trace.length(covered)) / len(self.steps)

    def roofline(self, kernel: str) -> float | None:
        return roofline.share_percent(self.spans.kernel_totals(kernel))

    def idle_percent(self) -> float | None:
        s = self.summary
        if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
