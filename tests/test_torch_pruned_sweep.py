"""The benchmark's pruned sweep (``hvd_bench/steps/pruned_sweep.py``: stage
4's pruned search, ``GpuSearchEngine.find_pairs_pruned`` a row chunk with
``rows_at`` and ``col_limit``) on the CPU, on a small library of the
benchmark's frozen scene model (median 48, clip 512, with its plants):

- the step's triples equal, exactly, those of the benchmark's plain
  reference (``hvdb.reference.row_matches`` over every row) cut to the
  step's triangle, in one row chunk and in three, at thresholds 75 and 50;
- the counts ``prune.col_frames`` and ``prune.col_leaders``, made once a
  sweep where the columns are clustered, equal the frames of the eligible
  videos and of ``extract_reps``' leaders, at a share below the one above
  which ``auto`` declines the prune.

The library has 400 videos: the reference compares every frame with every
frame (about 42 s on 8 CPU threads at 1,500 videos, 2 s at 400).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu_torch.ops import reps
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
from hydrus_video_deduplicator_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "hvd_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))  # the harness's own import root (hvd_bench/tests/conftest.py)

from hvdb import cells, reference  # noqa: E402

N_VIDEOS = 400
SEED = 3_000_000_021
CONFIG = json.loads((BENCH / "configs" / "scene1m_mean71.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "pruned_sweep.json").read_text())


def _cell(threshold: float = 75.0, chunk_rows: int = N_VIDEOS):
    config = {**CONFIG, "n_videos": N_VIDEOS, "threshold": threshold}
    traffic = {**TRAFFIC, "chunk_rows": chunk_rows}
    return cells.step_kind("pruned_sweep")(config, traffic, SEED, "cpu", lambda msg: None)


@pytest.fixture(scope="module")
def library():
    """The library from the step kind's own build, and the reference's
    matches of every row at the lower threshold."""
    cell = _cell()
    cell.build()
    assert len(cell.planted) > 0 and sum(not b for b in cell.blobs) > 0
    return cell.blobs, reference.row_matches(cell.blobs, np.arange(N_VIDEOS), 50, "cpu")


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.delenv(profiling.DEBUG_TIMING_ENV, raising=False)
    profiling.debug_timing()
    profiling.enable(True)
    profiling.clear()
    yield profiling
    profiling.enable(False)
    profiling.clear()


def _sweep(blobs, threshold: float, chunk_rows: int) -> np.ndarray:
    """One step of the step kind over ``blobs``: its (row, col, sim) triples."""
    cell = _cell(threshold, chunk_rows)
    cell.blobs, cell.n = blobs, len(blobs)
    cell.prepare()
    cell.step()
    cell.record()
    return cell.outputs[-1]


@pytest.mark.parametrize("threshold", [75.0, 50.0])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_the_step_equals_the_reference(library, threshold, n_chunks):
    blobs, matches = library
    chunk_rows = -(-N_VIDEOS // n_chunks)
    min_sim = cells.min_similarity(threshold)
    got = [tuple(t) for t in _sweep(blobs, threshold, chunk_rows).tolist()]
    want = {
        (r, j, s)
        for r, row in matches.items()
        for j, s in row.items()
        if s >= min_sim and j < min((r // chunk_rows + 1) * chunk_rows, N_VIDEOS)
    }
    assert len(got) == len(set(got))
    assert set(got) == want
    assert sum(1 for i, j, _ in want if i != j) > 0


def test_the_column_counts_equal_the_clustering(library, recorder):
    blobs, _ = library
    _sweep(blobs, 75.0, -(-N_VIDEOS // 3))
    counted = [r.counts for r in recorder.records() if "prune.col_leaders" in r.counts]
    assert [r.name for r in recorder.records() if "prune.col_frames" in r.counts] == ["prune.col_reps"]
    (counts,) = counted  # once a sweep, where the columns are clustered
    eligible = [b for b in blobs if 1 <= len(b) // reps.BYTES <= seg.SEG_MAX_FRAMES]
    assert counts["prune.col_frames"] == sum(map(len, eligible)) // reps.BYTES
    assert counts["prune.col_leaders"] == sum(map(len, reps.extract_reps(eligible))) // reps.BYTES
    share = counts["prune.col_leaders"] / counts["prune.col_frames"]
    assert 0 < share < GpuSearchEngine.PREFILTER_MAX_REP_FRACTION
