"""The port's span recorder (``utils/profiling``: ``span``, ``count``,
``enable``, ``records``, ``clear``) on the CPU: silent while off; the tree
of spans stage 4 records, with parents, threads and call identifiers; its
counts against the work they count; its spans as ``torch.profiler``
annotations on the main thread only; and its cap."""

from __future__ import annotations

import functools
import json
import sys
import threading
import time

import pytest
import torch

from hydrus_video_deduplicator_tpu_torch import entrypoint, scene_library
from hydrus_video_deduplicator_tpu_torch.parallel import engine
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
from hydrus_video_deduplicator_tpu_torch.utils import profiling

from .test_torch_search_checkpoint import PACKAGES, _main_run, _queue

N_VIDEOS = 160
CHUNK_ROWS = 64
#: each span's parent, by name, in the two searches
TREES = {
    "find_pairs": {
        "find_pairs": None,
        "find_pairs.row_index": "find_pairs",
        "find_pairs.col_index": "find_pairs",
        "seg.stage": "find_pairs",
        "seg.stage.pack": "seg.stage",
        "seg.stage.copy": "seg.stage",
        "seg.route": "find_pairs",
        "seg.row_pack": "seg.route",
        "seg.dispatch": "seg.route",
        "seg.drain.fetch": "seg.route",
        "seg.drain.decode": "seg.route",
        "seg.similarities": "find_pairs",
    },
    "find_pairs_pruned": {
        "find_pairs_pruned": None,
        "prune.col_reps": "find_pairs_pruned",
        "prune.row_reps": "find_pairs_pruned",
        "seg.stage": "find_pairs_pruned",
        "seg.stage.pack": "seg.stage",
        "seg.stage.copy": "seg.stage",
        "seg.route": "find_pairs_pruned",
        "seg.row_pack": "seg.route",
        "seg.dispatch": "seg.route",
        "seg.drain.fetch": "seg.route",
        "seg.drain.decode": "seg.route",
        "verify": "find_pairs_pruned",
        "verify.bucket": "verify",
        "verify.pack": "verify",
        "verify.dispatch": "verify",
        "verify.drain": "verify",
    },
}


@pytest.fixture(scope="module")
def library():
    blobs, expected, _ = scene_library.build_corpus(N_VIDEOS, seed=11, median=48.0)
    return blobs, {(a, b) for a, b in expected if a < b}


@pytest.fixture
def recorder(monkeypatch):
    """The recorder switched on by enable() alone, emptied, and switched
    off and emptied again afterwards."""
    monkeypatch.delenv(profiling.DEBUG_TIMING_ENV, raising=False)
    profiling.debug_timing()
    profiling.enable(True)
    profiling.clear()
    yield profiling
    profiling.enable(False)
    profiling.clear()


def _by_id(records) -> dict:
    return {r.id: r for r in records}


def _search(name: str, blobs, monkeypatch) -> list:
    """One call of ``name`` on the CPU, one row block a tile, so the route
    drains several tiles."""
    monkeypatch.setattr(GpuSearchEngine, "_row_blocks_per_tile", lambda self, n, s: 1)
    return getattr(GpuSearchEngine(device="cpu"), name)(blobs, blobs, 75)


def _annotations(prof, tmp_path) -> list[tuple[str, float, float]]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
    ]


def test_off_records_nothing_and_opens_no_annotation(library, monkeypatch, tmp_path):
    """Switched off and without HVD_DEBUG_TIMING: a search records nothing,
    a span is the shared null span and opens no profiler annotation."""
    blobs, planted = library
    monkeypatch.delenv(profiling.DEBUG_TIMING_ENV, raising=False)
    profiling.enable(False)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        hits = _search("find_pairs", blobs, monkeypatch)
        with profiling.span("off.test") as sp:
            profiling.count("off.count", 3)
    assert {(i, j) for i, j, _ in hits if i < j} == planted
    assert sp is profiling.NULL_SPAN and sp.seconds == 0.0 and not sp.counts
    assert profiling.records() == []
    assert _annotations(prof, tmp_path) == []


@pytest.mark.parametrize("search", sorted(TREES))
def test_a_search_records_its_tree(library, recorder, monkeypatch, search):
    """Every span of one search call on the main thread, under the one
    root of the call, each nested in its parent in time; the call id is
    the root's."""
    blobs, planted = library
    hits = _search(search, blobs, monkeypatch)
    assert {(i, j) for i, j, _ in hits if i < j} == planted
    records = recorder.records()
    tree = TREES[search]
    by_id = _by_id(records)
    assert {r.name for r in records} == set(tree)
    (root,) = [r for r in records if r.parent is None]
    assert root.name == search
    main = threading.main_thread().ident
    for r in records:
        assert r.thread == main and r.call == root.id, r.name
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.name == tree[r.name], r.name
            assert up.start <= r.start <= r.end <= up.end, r.name


@pytest.mark.parametrize("overflow", [False, True])
def test_the_counts_equal_the_work(library, recorder, monkeypatch, overflow):
    """seg.tiles counts every drained tile on the route's span, seg.device_sims
    every hit whose similarity came from kernel 3's hit lists and
    seg.sims_overflow every slab that fell back to its mask, on the route's
    span too, and seg.host_hits every hit the similarities scored, on
    theirs: every hit on the kernel's side, or, with every hit list of
    capacity 0, every hit on the host's and every slab overflowed."""
    blobs, _ = library
    drained, scored = [], []
    real_drain, real_sims = GpuSearchEngine._drain, engine._with_similarities
    monkeypatch.setattr(
        GpuSearchEngine, "_drain", lambda self, *a: drained.append(1) or real_drain(self, *a)
    )
    monkeypatch.setattr(
        engine, "_with_similarities",
        lambda hits, *a: scored.append((len(hits), sum(b - a0 for a0, b in a[-1])))
        or real_sims(hits, *a),
    )
    if overflow:
        monkeypatch.setattr(GpuSearchEngine, "_hit_capacity", lambda self, rows: 0)
    _search("find_pairs", blobs, monkeypatch)
    records = recorder.records()
    counted = {
        name: [(r.name, r.counts[name]) for r in records if name in r.counts]
        for name in ("seg.tiles", "seg.host_hits", "seg.device_sims", "seg.sims_overflow")
    }
    assert len(drained) > 1 and counted["seg.tiles"] == [("seg.route", len(drained))]
    ((n_hits, n_host),) = scored
    assert n_hits > N_VIDEOS and n_host == (n_hits if overflow else 0)
    assert counted["seg.host_hits"] == [("seg.similarities", n_host)]
    assert counted["seg.device_sims"] == [("seg.route", n_hits - n_host)]
    assert counted["seg.sims_overflow"] == [("seg.route", len(drained) if overflow else 0)]


def test_spans_are_profiler_annotations_on_the_main_thread_only(
    library, recorder, monkeypatch, tmp_path
):
    """Under a CPU torch.profiler run, each main-thread span is one
    user_annotation of its name, inside an annotation of its parent's
    name; a span on another thread is recorded, with its thread, but is
    no annotation."""
    blobs, _ = library

    def helper():
        with profiling.span("helper.test"):
            profiling.count("helper.count", 2)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _search("find_pairs_pruned", blobs, monkeypatch)
        th = threading.Thread(target=helper)
        th.start()
        th.join()
    records = recorder.records()
    notes = _annotations(prof, tmp_path)
    (helper_span,) = [r for r in records if r.name == "helper.test"]
    assert helper_span.thread == th.ident != threading.main_thread().ident
    assert helper_span.parent is None and helper_span.counts == {"helper.count": 2}
    main = [r for r in records if r is not helper_span]
    assert sorted(n for n, _, _ in notes) == sorted(r.name for r in main)
    by_id = _by_id(records)
    for r in main:
        if r.parent is None:
            continue
        parent = by_id[r.parent].name
        for name, a, b in notes:
            if name == r.name:
                assert any(p == parent and pa <= a and b <= pb for p, pa, pb in notes), name


def test_the_orchestrator_records_its_chunks(library, recorder, tmp_path, monkeypatch):
    """stage 4 of the port's main() in checkpoint chunks: one chunk span a
    chunk with its fetch (the prefetch's wait in it), search, mark and
    cache update, the search's spans under the chunk's call, its hits
    counted, and the row prefetch's span on its own thread."""
    blobs, planted = library
    db_mod, _, cls, _ = PACKAGES["port"]
    monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", CHUNK_ROWS)
    _queue(db_mod, tmp_path, 0, blobs)
    main = functools.partial(entrypoint.main, search_backend="gpu", device="cpu")
    _, marked, _ = _main_run(main, tmp_path, len(blobs), search_prefilter="reps")
    assert marked == planted
    records = recorder.records()
    by_id = _by_id(records)
    chunks = [r for r in records if r.name == "chunk"]
    assert len(chunks) == -(-N_VIDEOS // CHUNK_ROWS)
    for c in chunks:
        children = sorted(r.name for r in records if r.parent == c.id)
        assert children == ["chunk.cache_update", "chunk.fetch", "chunk.mark", "chunk.search"]
        assert c.counts["chunk.hits"] >= 1 and c.call == c.id
    waits = [r for r in records if r.name == "chunk.prefetch_wait"]
    assert len(waits) == len(chunks) and all(by_id[r.parent].name == "chunk.fetch" for r in waits)
    for r in records:
        if r.name == "find_pairs_pruned":
            assert by_id[r.parent].name == "chunk.search" and by_id[r.call].name == "chunk"
    prefetch = [r for r in records if r.name == "chunk.prefetch"]
    assert len(prefetch) == len(chunks)
    assert all(r.thread != threading.main_thread().ident and r.parent is None for r in prefetch)


#: search_prefilter and library -> (columns clustered, search the chunks call)
PREFILTERS = {
    "none": (False, "find_pairs"),
    "reps": (True, "find_pairs_pruned"),
    "auto-scenes": (True, "find_pairs_pruned"),
    "auto-clips": (True, "find_pairs"),
}


@pytest.mark.parametrize("case", sorted(PREFILTERS))
def test_the_engine_clusters_the_orchestrators_columns_once(
    library, recorder, tmp_path, monkeypatch, case
):
    """stage 4 of the port's main() asks the engine whether to prune: but
    for none, extract_reps clusters the columns once a sweep, inside the
    engine's prune.col_reps span with its frame and leader counts; auto
    prunes the scene library and declines 8-frame random clips, leaving
    no leaders in col_state and sweeping unpruned."""
    clustered, search = PREFILTERS[case]
    prefilter = case.split("-")[0]
    if case == "auto-clips":
        blobs, expected, _ = scene_library.build_sweep_corpus(N_VIDEOS, n_plant=4, n_far=2)
        planted = {(a, b) for a, b in expected if a < b}
    else:
        blobs, planted = library
    db_mod, _, cls, _ = PACKAGES["port"]
    monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", CHUNK_ROWS)
    calls, states = [], []
    real_reps = engine.reps_mod.extract_reps
    monkeypatch.setattr(
        engine.reps_mod, "extract_reps",
        lambda b, *a: calls.append(time.perf_counter_ns()) or real_reps(b, *a),
    )
    for name in ("find_pairs", "find_pairs_pruned"):
        real = getattr(GpuSearchEngine, name)

        def spy(self, *args, col_state=None, _real=real, **kwargs):
            states.append(col_state)
            return _real(self, *args, col_state=col_state, **kwargs)

        monkeypatch.setattr(GpuSearchEngine, name, spy)
    _queue(db_mod, tmp_path, 0, blobs)
    main = functools.partial(entrypoint.main, search_backend="gpu", device="cpu")
    _, marked, _ = _main_run(main, tmp_path, len(blobs), search_prefilter=prefilter)
    assert marked == planted
    records = recorder.records()
    by_id = _by_id(records)
    searches = [r.name for r in records if r.parent and by_id[r.parent].name == "chunk.search"]
    assert searches == [search] * -(-len(blobs) // CHUNK_ROWS)
    assert all(state is states[0] for state in states)
    clusterings = [r for r in records if "prune.col_leaders" in r.counts]
    if not clustered:
        assert calls == [] and clusterings == []
        return
    (c,) = clusterings
    assert c.name == "prune.col_reps" and len(calls) == 1 and c.start <= calls[0] <= c.end
    assert c.counts["prune.col_frames"] == sum(len(b) for b in blobs) // 32
    assert ("prune" in states[0]) == (search == "find_pairs_pruned")


@pytest.mark.parametrize("cap", [0, 3])
def test_the_cap_holds_and_spans_past_it_still_time(recorder, monkeypatch, cap):
    """No more than MAX_RECORDS records are kept; a span past the cap is
    still timed, with its counts and its children's seconds, for the
    lines printed from it."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", cap)
    for _ in range(cap + 2):
        with profiling.span("cap.outer", first=1) as outer:
            with profiling.span("cap.inner"):
                profiling.count("cap.count", 5)
            profiling.count("cap.count", 2)
    assert len(recorder.records()) == cap
    assert outer.seconds >= outer.child_seconds("cap.inner") > 0
    assert outer.counts == {"first": 1, "cap.count": 2}


def test_the_cap_holds_across_threads(recorder, monkeypatch):
    """Spans closing on many threads at once, switched often: exactly
    MAX_RECORDS are kept, each with its own thread's counts."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", 1000)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(200):
            with profiling.span("stress"):
                profiling.count("stress.n", 1)

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    records = recorder.records()
    assert len(records) == 1000
    assert all(r.counts == {"stress.n": 1} and r.parent is None for r in records)
