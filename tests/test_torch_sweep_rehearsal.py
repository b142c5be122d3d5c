"""The JAX package's exact all-pairs sweep (``artifacts/sweep_1m.py``) in
the port, on the CPU: ``scene_library.build_sweep_corpus`` against the
JAX logs' corpus lines and chunk hits, the port's ``find_pairs`` (the
plain PyTorch versions) against the JAX engine chunk by chunk under
``chip_smoke.sweep_rehearsal``'s own checks, the same corpus through both
packages' ``main()``, and the rehearsals' refusal to run without CUDA.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu import entrypoint as jax_entrypoint
from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
from hydrus_video_deduplicator_tpu_torch import entrypoint, scene_library as sl
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

from .test_torch_search_checkpoint import PACKAGES, _main_run, _queue

#: the CPU corpora: (n, chunk rows, plants scaled down with n)
SIZES = {
    "uniform": (1600, 400, {"n_plant": 40, "n_far": 20, "n_empty": 16}),
    "mixed": (1000, 250, {"n_plant": 25, "n_far": 12, "n_empty": 10}),
}
#: the library through main(): videos, checkpoint rows, plants
MAIN_N, MAIN_CHUNK_ROWS, MAIN_PLANTS = 600, 128, {"n_plant": 15, "n_far": 7}


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke imported with its argv pinned (it reads the library size
    from argv at import)."""
    argv = sys.argv
    sys.argv = ["chip_smoke.py"]
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def corpora():
    return {
        lengths: sl.build_sweep_corpus(n, lengths, **plants)
        for lengths, (n, _chunk, plants) in SIZES.items()
    }


def _plants_both_ways(n: int, **plants) -> dict:
    """The planted truth's (row, col) directions, without the similarities."""
    return {p: 0 for a, b in sl.sweep_plants(n, **plants) for p in ((a, b), (b, a))}


@pytest.mark.parametrize(
    "run, frames, empty",
    [
        ((240_000, 30_000, "triangle", "mixed"), 7_802_142, 100),
        ((1_000_000, 131_072, "triangle", "uniform"), 8_000_000, 0),
    ],
)
def test_corpus_and_truth_equal_the_jax_logs(chip_smoke, run, frames, empty):
    """The frame counts of the corpus at a JAX log's size (the cheap count
    draw, no frames held) give that log's corpus line, and the planted
    truth gives its eight chunk hits."""
    n, chunk, mode, lengths = run
    counts = sl.sweep_frame_counts(n, lengths)
    path, corpus, jax_hits = chip_smoke.sweep_log(*run)
    assert corpus == (n, lengths, frames, empty)
    assert (int(counts.sum()), int((counts == 0).sum())) == (frames, empty)
    assert chip_smoke.sweep_want(counts, _plants_both_ways(n), chunk, mode) == jax_hits
    assert len(jax_hits) == 8


@pytest.mark.parametrize("lengths", ["uniform", "mixed"])
def test_frame_counts_and_plants(corpora, lengths):
    """sweep_frame_counts is the built corpus's frame counts; every plant
    scores at least 75 in both directions, and only the plants are
    expected."""
    n, _chunk, plants = SIZES[lengths]
    blobs, expected, n_empty = corpora[lengths]
    counts = sl.sweep_frame_counts(n, lengths, **plants)
    assert np.array_equal(counts, [len(b) // 32 for b in blobs])
    assert n_empty == int((counts == 0).sum()) == (plants["n_empty"] if lengths == "mixed" else 0)
    plants_at = _plants_both_ways(n, n_plant=plants["n_plant"], n_far=plants["n_far"])
    assert set(expected) == set(plants_at)
    assert min(expected.values()) >= sl.MIN_SIM
    assert all(expected[(a, b)] == expected[(b, a)] for a, b in expected)
    if lengths == "mixed":
        assert counts.min() == 0 and counts.max() <= sl.SWEEP_MAX_FRAMES
    # a second build draws the same bytes
    assert sl.build_sweep_corpus(n, lengths, **plants)[0] == blobs


@pytest.mark.parametrize("mode", ["triangle", "square"])
@pytest.mark.parametrize("lengths", ["uniform", "mixed"])
def test_find_pairs_equals_jax_chunk_by_chunk(chip_smoke, corpora, lengths, mode, monkeypatch):
    """sweep_rehearsal's loop on the CPU: row chunks through one engine
    with one shared col_state, each against the corpus prefix ending at
    itself (triangle) or all of it (square), on the port's segment route
    and on the JAX engine's; the sorted hits are equal chunk by chunk, and
    the rehearsal's checks pass: the planted truth's hits in each chunk,
    every non-empty video matching itself at 100, every planted direction
    at its similarity, nothing else."""
    n, chunk, _plants = SIZES[lengths]
    blobs, expected, n_empty = corpora[lengths]
    launches = []
    real = seg.similarity_segments
    monkeypatch.setattr(seg, "similarity_segments", lambda *a: launches.append(1) or real(*a))
    port, jax_engine = GpuSearchEngine(device="cpu"), TpuSearchEngine(force_segments=True)
    state: dict = {}
    jax_state: dict = {}
    tally = {"self": 0, "planted": 0, "extras": [], "wrong": []}
    got = []
    for i0 in range(0, n, chunk):
        rows = blobs[i0 : i0 + chunk]
        limit = min(i0 + chunk, n) if mode == "triangle" else None
        hits = sorted(port.find_pairs(rows, blobs, 75, col_state=state, col_limit=limit))
        want = sorted(jax_engine.find_pairs(rows, blobs, 75, col_state=jax_state, col_limit=limit))
        assert hits == want, f"chunk at row {i0}"
        chip_smoke.sweep_tally(hits, i0, expected, tally)
        got.append(len(hits))
    assert len(got) == -(-n // chunk) and launches
    want = chip_smoke.sweep_want([len(b) for b in blobs], expected, chunk, mode)
    assert got == want
    assert tally["self"] == n - n_empty and tally["planted"] == sum(want) - (n - n_empty)
    assert not tally["extras"] and not tally["wrong"]
    # the far plants cross chunks: a triangle finds them once, a square twice
    n_far = SIZES[lengths][2]["n_far"]
    near = 2 * SIZES[lengths][2]["n_plant"]
    assert tally["planted"] == near + (n_far if mode == "triangle" else 2 * n_far)


def test_sweep_library_through_main_equals_the_jax_orchestrator(
    chip_smoke, tmp_path, monkeypatch, capsys
):
    """sweep_orchestrator's run on the CPU, small: the sweep corpus queued,
    then main(skip_hashing=True) with search_prefilter="auto" in both
    packages: "auto" declines the prune on random frames (no prune lap,
    no sweep launch, the similarity kernel's plain version runs), both
    mark the planted pairs and return the same count, and the port's
    timing lines pass stage4_split's checks of an unpruned run."""
    blobs, expected, _ = sl.build_sweep_corpus(MAIN_N, **MAIN_PLANTS)
    planted = {(a, b) for a, b in expected if a < b}
    calls = {"similarity_segments": 0, "exists_mask_sweep": 0}
    for name in calls:
        real = getattr(seg, name)
        monkeypatch.setattr(
            seg, name, lambda *a, _n=name, _f=real: calls.__setitem__(_n, calls[_n] + 1) or _f(*a)
        )
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "CPU")
    results = {}
    for package, main in (
        ("jax", lambda **kw: jax_entrypoint.main(search_backend="tpu", **kw)),
        ("port", lambda **kw: entrypoint.main(search_backend="gpu", device="cpu", **kw)),
    ):
        db_mod, _, cls, _ = PACKAGES[package]
        monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", MAIN_CHUNK_ROWS)
        _queue(db_mod, tmp_path / package, 0, blobs)
        if package == "jax":
            results[package] = _main_run(main, tmp_path / package, MAIN_N, search_prefilter="auto")
            continue
        capsys.readouterr()
        t0 = time.perf_counter()
        with chip_smoke.debug_timing_run() as seen:
            results[package] = _main_run(main, tmp_path / package, MAIN_N, search_prefilter="auto")
        chip_smoke.stage4_split("sweep", seen, MAIN_N, time.perf_counter() - t0, pruned=False)
        assert "[prune-timing]" not in seen["out"] and "[verify-timing]" not in seen["err"]
        # the chunks' hits: the planted truth's at the orchestrator's chunks
        assert seen["hits"] == sum(
            chip_smoke.sweep_want([1] * MAIN_N, expected, MAIN_CHUNK_ROWS, "triangle")
        )
        with pytest.raises(AssertionError, match=r"prune-timing"):
            chip_smoke.stage4_split("sweep", seen, MAIN_N, time.perf_counter() - t0)
    assert results["port"] == results["jax"]
    assert results["port"][0] == len(planted) and results["port"][1] == planted
    assert calls["similarity_segments"] and not calls["exists_mask_sweep"]


@pytest.mark.parametrize("rehearsal", ["sweep_rehearsal", "sweep_orchestrator"])
def test_rehearsals_raise_without_cuda(chip_smoke, monkeypatch, rehearsal):
    """Without CUDA a rehearsal raises before it builds a corpus or
    measures anything: there is no CPU run of it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    monkeypatch.setattr(sl, "build_sweep_corpus", refuse)
    monkeypatch.setattr(chip_smoke, "kernel3_rate", refuse)
    monkeypatch.setattr(chip_smoke, "card_line", refuse)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(chip_smoke, rehearsal)(24_000)
