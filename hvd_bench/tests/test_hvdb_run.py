"""Whole runs of each cell on the CPU at a small size (the program's plain
kernels): sound runs are correct; the control and each fault a cell can
have are not; no run loads JAX; run.py refuses without a card."""

import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from hvdb import control, runner

HERE = Path(__file__).resolve().parent
BENCH = runner.load_bench()  # the held scene cells too
SMALL = {
    "scene100k-auto": ({"n_videos": 800}, {"sample_rows": 96}),
    "scene100k-delta": ({"n_videos": 600}, {"n_new": 300, "n_cross": 40, "n_pairs": 20, "sample_rows": 64}),
    "clips1m-sweep": ({"n_videos": 2_000, "n_plant": 100, "n_plant_far": 50}, {"chunk_rows": 500, "sample_rows": 128}),
}
SEED = 3_000_000_019


def small_run(monkeypatch, workload, traced=False, seed=SEED):
    over_cfg, over_traffic = SMALL[workload]
    _, cfg, traffic = runner.cell_spec(BENCH, workload)
    real = runner.cell_spec
    monkeypatch.setattr(
        runner, "cell_spec",
        lambda b, w: (lambda e, c, t: (e, c, {**t, **over_traffic}))(*real(b, w)),
    )
    return runner.run(BENCH, workload, seed, 0.01, traced, "cpu", time.perf_counter(),
                      config={**cfg, **over_cfg})


@pytest.mark.parametrize("workload", list(SMALL))
def test_a_sound_run_is_correct(monkeypatch, workload):
    result = small_run(monkeypatch, workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", runner.cell_spec(BENCH, workload)[2]["metric"]}
    assert all(v["value"] == 0 for v in result["check"].values())
    assert list(result)[-1] == "check"


def test_a_traced_run_reads_the_span_metrics(monkeypatch):
    result = small_run(monkeypatch, "scene100k-auto", traced=True)
    assert result["correct"]
    names = set(result["metrics"])
    assert {"orchestrator_s.search", "clustering_s.search", "route_s.search",
            "verify_s.search", "db_s.search", "client_s.search"} <= names
    assert "k1_roofline.search" not in names  # no kernel launched on the CPU
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert result["device"]["count"] == 1


def test_the_device_set_follows_the_chips():
    assert runner.cell_device(1) == "cuda:0" and runner.cell_device(4) is None


@pytest.mark.parametrize("workload", ["scene100k-auto", "scene100k-delta", "clips1m-sweep"])
def test_the_control_is_not_correct(monkeypatch, workload):
    over_cfg, over_traffic = SMALL[workload]
    _, cfg, traffic = runner.cell_spec(BENCH, workload)
    real = runner.cell_spec
    monkeypatch.setattr(runner, "cell_spec", lambda b, w: (lambda e, c, t: (e, c, {**t, **over_traffic}))(*real(b, w)))
    out = control.numbers(BENCH, workload, SEED, "cpu", lambda m: None, {**cfg, **over_cfg})
    assert not out["correct"] and out["missing"] > 0


def unchanged(monkeypatch, workload):
    """A step that returns its state unchanged."""
    from hydrus_video_deduplicator_tpu_torch import dedup
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    if workload == "clips1m-sweep":
        monkeypatch.setattr(engine.GpuSearchEngine, "find_pairs", lambda self, *a, **k: [])
    else:
        monkeypatch.setattr(dedup.HydrusVideoDeduplicator, "find_potential_duplicates", lambda self: 0)


def half_batch(monkeypatch, workload):
    """Half of each row chunk left out of the search."""
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    name = "find_pairs" if workload == "clips1m-sweep" else "find_pairs_pruned"
    real = getattr(engine.GpuSearchEngine, name)

    def half(self, rows, *args, **kwargs):
        k = len(rows) // 2
        if kwargs.get("rows_at") is not None:
            kwargs["rows_at"] += k
        return [(i + k, j, *s) for i, j, *s in real(self, rows[k:], *args, **kwargs)]

    monkeypatch.setattr(engine.GpuSearchEngine, name, half)


def altered(monkeypatch, workload):
    """One answer altered where it is produced."""
    from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    if workload == "clips1m-sweep":
        real = engine._with_similarities

        def off_by_one(hits, *args):
            out = real(hits, *args)
            k = next(k for k, (i, j, _) in enumerate(out) if i != j)
            out[k] = (out[k][0], out[k][1], out[k][2] - 1)
            return out

        monkeypatch.setattr(engine, "_with_similarities", off_by_one)
    else:
        real = pair_verify.verify_pairs

        def moved(*args):
            out = real(*args)
            if out:
                i, j, s = out[-1]
                out[-1] = (i, (j + 7) % 100, s)
            return out

        monkeypatch.setattr(pair_verify, "verify_pairs", moved)


@pytest.mark.parametrize("workload", list(SMALL))
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_each_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    result = small_run(monkeypatch, workload, seed=SEED + 1)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert any(v["value"] > 0 for v in result["check"].values())


def test_no_run_loads_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from hvdb import runner, cells, control, record\n"
        "import hydrus_video_deduplicator_tpu_torch.dedup\n"
        "for m in [m['name'] for m in runner.load_bench()['per_layer']]:\n"
        "    record.load_reader(m)\n"
        "print(runner.forbidden_modules())\n"
    ) % (str(HERE.parent), str(HERE.parents[1]))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hydrus_video_deduplicator_tpu.dedup", object())
    assert runner.forbidden_modules() == ["hydrus_video_deduplicator_tpu"]
    monkeypatch.delitem(sys.modules, "hydrus_video_deduplicator_tpu.dedup")
    assert "hydrus_video_deduplicator_tpu_torch" not in runner.forbidden_modules()


def imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    hvdb = HERE.parent / "hvdb"
    for name in ("reference.py", "library.py", "check.py", "control.py", "trace.py", "roofline.py"):
        assert imports(hvdb / name) <= {"__future__", "numpy", "torch", "json", "bisect",
                                        "dataclasses", "pathlib", "argparse"}, name
    for path in HERE.parent.rglob("*.py"):
        assert not imports(path) & {"jax", "jaxlib", "flax", "hydrus_video_deduplicator_tpu"}, path


def test_run_py_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "hvd_bench/run.py", "--workload", "clips1m-sweep", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=HERE.parents[1], timeout=300,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.cuda
def test_the_reference_on_the_card_equals_the_cpu():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hvdb import library, reference

    blobs = library.build_corpus(3_000, 12)[0]
    rows = np.arange(0, 3_000, 7)
    cpu = reference.row_matches(blobs, rows, 1, "cpu", col_block=1 << 16)
    cuda = reference.row_matches(blobs, rows, 1, "cuda", col_block=1 << 16, block_elems=1 << 24)
    assert cpu == cuda and sum(map(len, cpu.values())) > len(rows)


def test_restore_file_rewrites_only_the_pages_that_differ(tmp_path):
    from hvdb import cells

    rng = np.random.default_rng(3)
    src, dst = tmp_path / "saved", tmp_path / "db"
    saved = rng.integers(0, 256, 10 * 4096 + 100, dtype=np.uint8).tobytes()
    src.write_bytes(saved)
    changed = bytearray(saved)
    changed[5] ^= 1  # page 0
    changed[3 * 4096 + 7] ^= 1  # page 3
    dst.write_bytes(bytes(changed) + b"grown by the step" * 500)
    assert cells.restore_file(src, dst, block=8192) == 2 * 4096
    assert dst.read_bytes() == saved
    assert cells.restore_file(src, dst, block=8192) == 0
