"""The port's profiling helpers (``utils/profiling.py``): ``device_timer``
as the JAX package's test holds its own, ``trace_to`` writing a Chrome
trace of the enclosed block, and ``device_busy_share`` on such a trace. A
``cuda``-marked test traces a kernel on the card."""

from __future__ import annotations

import json
import time

import pytest
import torch

from hydrus_video_deduplicator_tpu_torch.utils import device_timer, trace_to
from hydrus_video_deduplicator_tpu_torch.utils.profiling import TRACE_FILE, device_busy_share


def test_device_timer_measures():
    calls = []

    def step(i):
        calls.append(i)
        return torch.tensor([float(i)])

    mean = device_timer(step, iters=3, warmup=1)
    assert mean >= 0
    assert len(calls) == 4  # 1 warmup + 3 timed


def test_device_timer_is_wall_time_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    mean = device_timer(lambda i: calls.append(time.sleep(0.01) or i), iters=2, warmup=0)
    assert mean >= 0.01 and calls == [0, 1]


def test_trace_to_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace_to(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    path = tmp_path / "trace" / TRACE_FILE
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    busy, window, kernels = device_busy_share(str(path))
    assert (busy, kernels) == (0.0, 0) and window > 0  # no device on the CPU


def test_device_busy_share_is_the_union_of_kernel_intervals(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},  # 10-30
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},  # 20-40, overlaps
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 60, "dur": 5},  # 60-65
        {"ph": "X", "cat": "kernel", "name": "k4", "ts": 61, "dur": 2},  # inside k3
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 500},  # not an interval
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, window, kernels = device_busy_share(str(path))
    assert kernels == 4
    assert window == pytest.approx(100e-6)
    assert busy == pytest.approx(35e-6)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: traces and times kernels on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_and_timer_see_the_card(cuda_device, tmp_path):
    a = torch.randn(2048, 2048, device=cuda_device)
    ms = 1e3 * device_timer(lambda i: a @ a, iters=5, warmup=2)
    with trace_to(str(tmp_path)):
        for _ in range(5):
            a @ a
    busy, window, kernels = device_busy_share(str(tmp_path / TRACE_FILE))
    assert ms > 0 and kernels >= 5 and 0 < busy <= window
