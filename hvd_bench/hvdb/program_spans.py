"""The program's own spans and counts, for the per-layer readers of a
traced run: the port's recorder (``utils/profiling.span`` and ``count``).

Importing this module switches the recorder on. Readers are loaded in
traced runs only, after set-up, so an untimed run keeps it off. A checkout
of the program without the recorder gives nothing to read: every function
here then returns None, and a reader with it.

Only the spans of the thread that ran the steps (the main thread) count:
a span on a helper thread overlaps the step's own time.
"""

from __future__ import annotations

import threading

from hydrus_video_deduplicator_tpu_torch.utils import profiling

from . import trace

if hasattr(profiling, "enable"):
    profiling.enable(True)

STEP_THREAD = threading.main_thread().ident


def _records() -> list:
    records = getattr(profiling, "records", None)
    if records is None:
        return []
    return [r for r in records() if r.thread == STEP_THREAD]


def per_step(rec, name: str) -> float | None:
    """Seconds a step spent inside the spans ``name`` (the union of their
    intervals, clipped to the steps), or None where no such span ran in a
    step."""
    spans = [(r.start / 1e9, r.end / 1e9) for r in _records() if r.name == name]
    inside = trace.intersect(trace.union(spans), trace.union(rec.steps))
    if not inside:
        return None
    return trace.length(inside) / len(rec.steps)


def count_per_step(rec, name: str) -> float | None:
    """The count ``name`` a step, summed over the spans that closed inside
    a step, or None where no such count was made in a step."""
    steps = trace.union(rec.steps)
    found = [
        r.counts[name] for r in _records()
        if name in r.counts and any(a <= r.end / 1e9 <= b for a, b in steps)
    ]
    if not found:
        return None
    return sum(found) / len(rec.steps)
