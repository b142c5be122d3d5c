"""The cell ``scene1m-pruned`` (step kind ``pruned_sweep``) on the CPU at a
small size, on the port's plain kernels: a sound run is correct with every
limit at 0; the control and each fault of a sweep (a dropped hit, a changed
similarity, a missing self-pair) are not; a traced run gives each of the
cell's program readers a value; the readers of the new counts give nothing
on a program without them; each step clusters and stages its own
columns."""

from types import SimpleNamespace

import pytest
from hvdb import control, program_spans, record, runner

WORKLOAD = "scene1m-pruned"
BENCH = runner.load_bench()
SMALL_CONFIG = {"n_videos": 500}
SMALL_TRAFFIC = {"chunk_rows": 200, "sample_rows": 64}
SEED = 3_000_000_023
READERS = ("row_pack_s.pruned", "drain_wait_s.pruned", "drain_decode_s.pruned",
           "col_reps_s.pruned", "stage_b_s.pruned", "candidates.pruned", "leader_share.pruned")


@pytest.fixture
def small(monkeypatch):
    """runner.cell_spec with the small traffic, and the small configuration."""
    real = runner.cell_spec
    monkeypatch.setattr(
        runner, "cell_spec",
        lambda b, w: (lambda e, c, t: (e, c, {**t, **SMALL_TRAFFIC}))(*real(b, w)),
    )
    return {**real(BENCH, WORKLOAD)[1], **SMALL_CONFIG}


def small_run(config, traced=False, seed=SEED):
    import time

    return runner.run(BENCH, WORKLOAD, seed, 0.01, traced, "cpu", time.perf_counter(),
                      config=config)


def test_a_sound_run_is_correct(small):
    result = small_run(small)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "sweep_s"}
    assert set(result["check"]) == {"missing", "extra", "sim_wrong", "self_wrong"}
    assert all(v["value"] == 0 and v["limit"] == 0 for v in result["check"].values())


def test_the_control_is_not_correct(small):
    out = control.numbers(BENCH, WORKLOAD, SEED, "cpu", lambda m: None, small)
    assert not out["correct"] and out["missing"] > 0


def _first_pair(hits, at):
    """The corpus pair {i, j}, i != j, of the first non-self triple of a
    call's output, or None."""
    return next(({i + at, j} for i, j, _ in hits if i + at != j), None)


def dropped_hit(hits, at):
    """Every triple of one pair left out (both directions inside a chunk)."""
    pair = _first_pair(hits, at)
    return [t for t in hits if {t[0] + at, t[1]} != pair]


def changed_similarity(hits, at):
    pair = _first_pair(hits, at)
    return [(i, j, s - 1) if {i + at, j} == pair else (i, j, s) for i, j, s in hits]


def missing_self_pair(hits, at):
    k = next(k for k, (i, j, _) in enumerate(hits) if i + at == j)
    return hits[:k] + hits[k + 1 :]


@pytest.mark.parametrize("fault", [dropped_hit, changed_similarity, missing_self_pair])
def test_each_fault_is_not_correct(small, monkeypatch, fault):
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    real = engine.GpuSearchEngine.find_pairs_pruned

    def faulty(self, rows, *args, **kwargs):
        return fault(real(self, rows, *args, **kwargs), kwargs["rows_at"])

    monkeypatch.setattr(engine.GpuSearchEngine, "find_pairs_pruned", faulty)
    result = small_run(small, seed=SEED + 1)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert any(v["value"] > 0 for v in result["check"].values())


def test_a_traced_run_reads_the_program_spans_and_counts(small):
    result = small_run(small, traced=True)
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(metrics), metrics
    assert all(metrics[m] > 0 for m in READERS), metrics
    assert "k1_roofline.pruned" not in metrics  # no kernel launched on the CPU
    assert metrics["candidates.pruned"] >= small["n_videos"] - small["n_videos"] // 50
    assert 5 < metrics["leader_share.pruned"] < 70


def test_the_new_readers_give_nothing_without_the_counts(monkeypatch):
    """A program whose spans carry no prune.col_* counts (the port before
    they were added): the leader share gives None and does not raise."""
    main = program_spans.STEP_THREAD
    spans = [SimpleNamespace(name="find_pairs_pruned", start=int(11e9), end=int(12e9),
                             thread=main, counts={"prune.candidates": 9})]
    monkeypatch.setattr(program_spans, "profiling", SimpleNamespace(records=lambda: spans))
    rec = SimpleNamespace(steps=[(10.0, 20.0)])
    assert record.load_reader("leader_share.pruned").read(rec) is None
    assert record.load_reader("candidates.pruned").read(rec) == 9
    assert record.load_reader("col_reps_s.pruned").read(rec) is None


def test_each_step_clusters_and_stages_its_columns(small):
    """A new engine and col_state a step: each step clusters the columns
    (one prune.col_leaders count) and stages them (one seg.stage span)."""
    from hydrus_video_deduplicator_tpu_torch.utils import profiling

    from hvdb import cells

    _, _, traffic = runner.cell_spec(BENCH, WORKLOAD)
    cell = cells.make(small, traffic, SEED, "cpu", lambda m: None)
    cell.build()
    was = profiling.enable(True)
    profiling.clear()
    try:
        for _ in range(2):
            cell.prepare()
            cell.step()
            cell.record()
        names = [r.name for r in profiling.records()]
        counted = [r for r in profiling.records() if "prune.col_leaders" in r.counts]
    finally:
        profiling.enable(was)
        profiling.clear()
    assert len(counted) == 2 and names.count("seg.stage") == 2
    assert names.count("find_pairs_pruned") == 2 * -(-cell.n // traffic["chunk_rows"])
    assert (cell.outputs[0] == cell.outputs[1]).all()
