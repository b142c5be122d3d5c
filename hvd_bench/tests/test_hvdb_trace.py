"""The busy share, the idle gaps and the self time on a synthetic trace."""

import pytest
from hvdb import record, trace
from hvdb.spans import Spans


def x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_busy_share_counts_kernels_and_copies_inside_the_steps_only():
    events = [
        x(trace.STEP, 0, 100), x(trace.STEP, 200, 100),
        x("k", 10, 20, "kernel"), x("k", 25, 10, "kernel"),  # overlapping: 25 us
        x("copy", 250, 10, "gpu_memcpy"), x("set", 290, 20, "gpu_memset"),  # 10 + 10 inside
        x("k", 150, 20, "kernel"),  # between steps: not in the window
        x("layer", 40, 50), x("inner", 60, 10),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert dict(s["device_ops"]) == pytest.approx({"k": 30e-6, "copy": 10e-6, "set": 10e-6})
    gaps = dict(s["idle_gaps"])
    assert gaps["inner"] == pytest.approx(10e-6)
    assert gaps["layer"] == pytest.approx(40e-6)
    outside = (10 + 5 + 10 + 50 + 30) * 1e-6  # 0-10, 35-40, 90-100, 200-250, 260-290
    assert gaps["step, outside every layer span"] == pytest.approx(outside)
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_self_time_and_per_step_seconds():
    spans = Spans()
    spans.calls = {"a": [(1.0, 2.0), (1.5, 3.0), (9.0, 9.5)], "b": [(2.5, 4.0)], "c": []}
    rec = record.Record(steps=[(0.0, 5.0), (10.0, 12.0)], spans=spans, summary=None)
    assert rec.per_step("a") == pytest.approx(1.0)  # 1..3 inside the first step
    assert rec.per_step("c") is None
    assert rec.self_seconds(["a", "b", "c"]) == pytest.approx((7.0 - 3.0) / 2)
    assert rec.idle_percent() is None
    rec.summary = {"busy_s": 1.0, "window_s": 4.0}
    assert rec.idle_percent() == pytest.approx(75.0)


def test_roofline_share_is_the_bound_over_the_device_time():
    from hvdb import roofline

    p = roofline.peaks()
    pairs, n_bytes = 4 * 10**12, 10**9
    bound = max(n_bytes / p["hbm_bytes_per_s"], pairs / p["b1_frame_pairs_per_s"])
    assert roofline.share_percent((3, 2 * bound, pairs, n_bytes)) == pytest.approx(50.0)
    assert roofline.share_percent(None) is None


def test_busy_share_is_averaged_over_the_devices_used():
    def k(ts, dur, device):
        return {**x("k", ts, dur, "kernel"), "args": {"device": device}}

    events = [x(trace.STEP, 0, 100), k(0, 40, 0), k(20, 40, 0), k(50, 10, 1)]
    assert trace.summarize(events, 2)["busy_s"] == pytest.approx((60 + 10) / 2 * 1e-6)
    # a device used but idle in the window still counts in the average
    assert trace.summarize(events, 4)["busy_s"] == pytest.approx((60 + 10) / 4 * 1e-6)


def test_a_span_records_the_installing_thread_only():
    import threading
    import types

    mod = types.ModuleType("hvdb_test_target")
    mod.work = lambda: 7
    import sys

    sys.modules[mod.__name__] = mod
    try:
        spans = Spans()
        spans.wrap("hvdb_test_target:work", "work")
        out = []
        t = threading.Thread(target=lambda: out.append(mod.work()))
        t.start()
        t.join()
        assert out == [7] and spans.calls["work"] == []
        assert mod.work() == 7 and len(spans.calls["work"]) == 1
        spans.restore()
    finally:
        del sys.modules[mod.__name__]
