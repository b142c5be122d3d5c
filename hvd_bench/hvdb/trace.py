"""The device's busy time, its top operations and its idle gaps, read from
a ``torch.profiler`` Chrome trace of the measured window.

The window is the union of the benchmark's step annotations (``STEP``),
not the trace's first and last events. A device's busy time is the union
of the intervals of every kernel, copy and memset it ran inside the
window; ``busy_s`` averages it over the devices the run used. An idle gap
inside a step (of the first device) is named by the innermost benchmark
span open on the host when it began.
"""

from __future__ import annotations

import bisect
import json

import numpy as np

STEP = "hvdb.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "user_annotation"
TOP = 10
#: a device operation's name is cut to this many characters
NAME_CHARS = 160


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def intersect(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def gaps(window, busy) -> list[tuple[float, float]]:
    """The parts of the merged ``window`` that the merged ``busy`` leaves."""
    out = []
    for w0, w1 in window:
        t = w0
        for a, b in busy:
            if b <= w0 or a >= w1:
                continue
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < w1:
            out.append((t, w1))
    return out


def summarize(events: list[dict], n_devices: int = 1) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of a trace's complete
    ("X") events, in seconds, over ``n_devices`` used devices; device_ops
    and idle_gaps are the TOP largest [name, seconds] by total."""
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = union(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in x if e.get("name") == STEP and e.get("cat") == HOST_CAT
    )
    device = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")[:NAME_CHARS],
         (e.get("args") or {}).get("device", 0))
        for e in x if e.get("cat") in DEVICE_CATS
    ]
    per_device = {
        d: intersect(union((a, b) for a, b, _, dd in device if dd == d), window)
        for d in sorted({d for *_, d in device})
    }
    busy = next(iter(per_device.values()), [])
    by_op: dict[str, float] = {}
    for a, b, name, _ in device:
        inside = length(intersect([(a, b)], window))
        if inside > 0:
            by_op[name] = by_op.get(name, 0.0) + inside
    host = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in x if e.get("cat") == HOST_CAT and e.get("name") != STEP
    ]
    starts = np.asarray([h[0] for h in host])
    ends = np.asarray([h[1] for h in host])
    edges = sorted({t for h in host for t in h[:2]})
    by_span: dict[str, float] = {}
    for a, b in gaps(window, busy):
        # cut the gap where a host span opens or closes, and give each part
        # to the innermost span open at its start
        cuts = [a] + edges[bisect.bisect_right(edges, a) : bisect.bisect_left(edges, b)] + [b]
        for c0, c1 in zip(cuts, cuts[1:]):
            name = "step, outside every layer span"
            if host:
                open_ = np.nonzero((starts <= c0) & (ends > c0))[0]
                if len(open_):
                    name = host[int(open_[np.argmax(starts[open_])])][2]
            by_span[name] = by_span.get(name, 0.0) + (c1 - c0)

    def top(d: dict) -> list:
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "busy_s": sum(map(length, per_device.values())) / max(n_devices, len(per_device)) / 1e6,
        "window_s": length(window) / 1e6,
        "device_ops": top(by_op),
        "idle_gaps": top(by_span),
    }


def summarize_file(path: str, n_devices: int = 1) -> dict:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"], n_devices)
