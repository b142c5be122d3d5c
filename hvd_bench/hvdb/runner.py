"""One run of one cell: set-up, the measured window, the check, and the
result line.

``python3 hvd_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything the program prints
goes to standard error; standard output carries the result line alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import cells, record, trace
from .spans import Spans, synchronize

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
#: cells held out of BENCHMARK.json, runnable for trials (README)
HELD = Path(__file__).resolve().parents[1] / "held_cells.json"
TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "hydrus_video_deduplicator_tpu")


def log(msg: str) -> None:
    print(f"[hvd_bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench() -> dict:
    """BENCHMARK.json, with the held cells' entries that it does not give."""
    bench = load_json(BENCH)
    if HELD.is_file():
        held = load_json(HELD)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            names = {e["name"] for e in bench[key]}
            bench[key] = bench[key] + [e for e in held.get(key, []) if e["name"] not in names]
    return bench


def cell_spec(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration's file, its traffic file)."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in {BENCH.name}")
    wl = found[0]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == wl["config"]]
    return wl, load_json(ROOT / cfg_entry["file"]), load_json(TRAFFIC / f"{wl['traffic']}.json")


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layers = [
        m for m in bench["per_layer"]
        if workload in m.get("workloads", [workload] if m["moves"] in names else [])
    ]
    return e2e, layers


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cell_device(chips: int) -> str | None:
    """The device a cell's program is given: the one card of a one-chip
    cell; for more, none, so that the program spreads itself over every
    visible card."""
    return "cuda:0" if chips == 1 else None


def used_devices() -> list[int]:
    """The CUDA devices on which the run allocated memory."""
    import torch

    return [i for i in range(torch.cuda.device_count()) if torch.cuda.max_memory_allocated(i) > 0]


def run(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
        device: str | None, t0: float, config: dict | None = None) -> dict:
    """One run; returns the result object. ``device`` None spreads the
    program over every visible card. ``config`` replaces the
    configuration's file (the benchmark's tests run smaller libraries)."""
    import torch

    wl, cfg, traffic = cell_spec(bench, workload)
    cfg = config or cfg
    e2e, layers = cell_metrics(bench, workload)
    cells.set_env(cfg)
    cell = cells.make(cfg, traffic, seed, device, log)
    on_cuda = device is None or torch.device(device).type == "cuda"
    cell.setup()

    readers = [record.load_reader(m["name"]) for m in layers] if traced else []
    spans = Spans()
    record.install(readers, spans)
    profiler = None
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    steps: list[tuple[float, float]] = []
    total = 0.0
    try:
        while not steps or total < seconds:
            cell.prepare()
            with torch.profiler.record_function(trace.STEP) if traced else contextlib.nullcontext():
                a = time.perf_counter()
                cell.step()
                if on_cuda:
                    synchronize()
                b = time.perf_counter()
            cell.record()
            steps.append((a, b))
            total += b - a
            log(f"step {len(steps)}: {b - a:.3f} s")
    finally:
        if profiler is not None:
            profiler.stop()
        spans.restore()
    used = used_devices() if on_cuda else []
    peak = max((torch.cuda.max_memory_allocated(i) for i in used), default=0)
    if on_cuda and len(used) != wl["chips"]:
        log(f"the cell asks for {wl['chips']} device(s); the run used {len(used)}: {used}")

    summary = None
    if profiler is not None:
        with tempfile.TemporaryDirectory(prefix="hvd_bench_trace_") as td:
            path = os.path.join(td, "trace.json")
            profiler.export_chrome_trace(path)
            summary = trace.summarize_file(path, max(len(used), 1))
        del profiler
    rec = record.Record(steps, spans, summary)

    metrics: dict = {}
    if traced:
        for m, reader in zip(layers, readers):
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, traffic["metric"]: total / len(steps)}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    spans.launches.clear()
    if on_cuda:
        torch.cuda.empty_cache()  # the reference runs in what the program freed
    t_check = time.perf_counter()
    verdict = cell.verdict(cell.truth(device or "cuda:0"))  # the reference on the first card
    cell.close()
    log(f"check over {verdict.attempted} steps: {time.perf_counter() - t_check:.3f} s")

    dev = {
        "platform": "gpu" if on_cuda else device,
        "kind": torch.cuda.get_device_name(used[0] if used else 0) if on_cuda else device,
        "count": len(used) if on_cuda else 1,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": verdict.correct, "attempted": verdict.attempted, "failed": verdict.failed,
        "metrics": metrics, "device": dev,
    }
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["check"] = verdict.as_json()
    return result


def main(argv: list[str], t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.stdout.flush()
    result_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # what anything else prints on standard output goes to standard error

    bench = load_bench()
    wl, _, _ = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {wl['chips']} CUDA device(s), found {n}: no result")
        return 3
    log(f"{args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}; card: "
        f"{card_line()}; python {sys.version.split()[0]}, torch {torch.__version__}")
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                 cell_device(wl["chips"]), t0)
    found = forbidden_modules()
    if found:
        log(f"modules that may not be loaded were loaded: {found}: no result")
        return 4
    log(f"result: correct {result['correct']}, metrics {json.dumps(result['metrics'])}")
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), file=result_out, flush=True)
    return 0
