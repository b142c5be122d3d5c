"""Stage 4's checkpoints and its incremental (delta) run: the port's
orchestrator (``search_backend="gpu"``, ``device="cpu"``, so every kernel's
plain PyTorch version) against the JAX package's (``search_backend="tpu"``
on the CPU) on the same inputs.

- The counterparts of ``tests/unit_tests/test_search_checkpoint.py``: a
  search interrupted between chunks leaves exactly its finished chunks
  committed and the next run finishes it; a run in small chunks marks what
  one chunk marks. Both on the test corpus served by the fake Hydrus.
- The delta: a first run over a scene library, then a second run with new
  videos added (re-encodes of searched videos and pairs among the new
  ones, ``scene_library.build_delta``), through both packages' ``main()``:
  the same relationships and the same returned count on each run, the
  count following the reference's rule (a new-against-searched hit is one
  event, a new-against-new hit two, halved at the end).
- The engine over a searched prefix: row chunks that start past the
  searched videos, each sweeping the corpus up to its own end.
- The rep cache the engine clusters for stage 4's sweep, on a second
  ``deduplicate()`` of the same orchestrator.
"""

from __future__ import annotations

import functools
import shutil
import sqlite3
import uuid
from pathlib import Path

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu import entrypoint as jax_entrypoint
from hydrus_video_deduplicator_tpu.client import HVDClient as JaxClient
from hydrus_video_deduplicator_tpu.db import DedupeDB as jax_db
from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator as JaxDeduplicator
from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
from hydrus_video_deduplicator_tpu_torch import entrypoint, scene_library
from hydrus_video_deduplicator_tpu_torch.client import HVDClient
from hydrus_video_deduplicator_tpu_torch.db import DedupeDB, vptree
from hydrus_video_deduplicator_tpu_torch.dedup import HydrusVideoDeduplicator
from hydrus_video_deduplicator_tpu_torch.ops import reps as reps_mod
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

from .fake_hydrus import CORPUS_EXPECTED_PAIRS, DEFAULT_ACCESS_KEY, FakeHydrus, corpus_file_store

#: package -> (its DedupeDB module, its client, its orchestrator, the
#: orchestrator's arguments for the device search)
PACKAGES = {
    "jax": (jax_db, JaxClient, JaxDeduplicator, {"search_backend": "tpu"}),
    "port": (DedupeDB, HVDClient, HydrusVideoDeduplicator, {"search_backend": "gpu", "device": "cpu"}),
}
#: the delta library: videos, new videos, their plants, and a median frame
#: count that keeps the unpruned search small on the CPU
N_LIBRARY = 300
N_NEW = 60
N_CROSS = 8
N_NEW_PAIRS = 6
MEDIAN = 8.0


def _file_hash(i: int) -> str:
    return f"{i:064x}"


def _searched(db) -> int:
    return db.execute(
        "SELECT COUNT(*) FROM shape_search_cache WHERE searched_distance IS NOT NULL"
    ).fetchone()[0]


# -- checkpoints, on the test corpus ---------------------------------------


@pytest.fixture(scope="module")
def corpus_db(tmp_path_factory):
    """A database after stages 1 and 2 of the test corpus (hashed once, by
    the port; a database opens in either package)."""
    d = tmp_path_factory.mktemp("corpus_db")
    server = FakeHydrus(corpus_file_store())
    server.start()
    try:
        DedupeDB.set_db_dir(d)
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(d, DedupeDB.get_db_name())
        db.init_connection()
        deduper = HydrusVideoDeduplicator(
            db, HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None), **PACKAGES["port"][3]
        )
        db.begin_transaction()
        with db.conn:
            deduper.add_perceptual_hashes_to_db(
                list(deduper.client.get_video_hashes(deduper.search_tags))
            )
            deduper.process_phashed_file_queue()
        db.close()
    finally:
        server.stop()
    return d / DedupeDB.get_db_name()


@pytest.fixture()
def corpus_server():
    server = FakeHydrus(corpus_file_store())
    server.start()
    yield server
    server.stop()


def _open(package: str, template: Path, tmp_path: Path, server):
    """(db, orchestrator) of ``package`` on a copy of ``template``."""
    db_mod, client_cls, cls, kwargs = PACKAGES[package]
    d = tmp_path / f"{package}_{uuid.uuid4().hex}"
    d.mkdir()
    shutil.copyfile(template, d / db_mod.get_db_name())
    db_mod.set_db_dir(d)
    db = db_mod.DedupeDb(d, db_mod.get_db_name())
    db.init_connection()
    return db, cls(db, client_cls(None, server.url, DEFAULT_ACCESS_KEY, None), **kwargs)


def _interrupted_then_resumed(package, template, tmp_path, server, monkeypatch):
    """Stage 4 in 5-row chunks, skipped once the first chunk is committed,
    then run to its end: (files, searched after the interrupt, searched
    at a second connection then, relationships after the interrupt, after
    the resumed run)."""
    cls = PACKAGES[package][2]
    monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", 5)
    db, deduper = _open(package, template, tmp_path, server)
    n_files = db.execute("SELECT COUNT(*) FROM shape_search_cache").fetchone()[0]
    deduper.should_skip_step_fn = lambda: _searched(db) >= 5
    db.begin_transaction()
    with db.conn:
        deduper.find_potential_duplicates()
        other = sqlite3.connect(db.db_dir / db.db_name)  # sees committed rows only
        committed = other.execute(
            "SELECT COUNT(*) FROM shape_search_cache WHERE searched_distance IS NOT NULL"
        ).fetchone()[0]
        other.close()
    searched = _searched(db)
    partial = set(server.relationships)
    deduper.should_skip_step_fn = None
    db.begin_transaction()
    with db.conn:
        deduper.find_potential_duplicates()
    assert _searched(db) == n_files
    db.close()
    return n_files, searched, committed, partial, set(server.relationships)


def test_interrupt_between_chunks_checkpoints(corpus_db, tmp_path, monkeypatch):
    """Skipped at the second chunk boundary, stage 4 has committed exactly
    its first chunk; the resumed run searches the rest and ends with the
    JAX orchestrator's relationships."""
    runs = {}
    for package in PACKAGES:
        server = FakeHydrus(corpus_file_store())
        server.start()
        try:
            runs[package] = _interrupted_then_resumed(
                package, corpus_db, tmp_path, server, monkeypatch
            )
        finally:
            server.stop()
    n_files, searched, committed, partial, final = runs["port"]
    assert n_files > 10
    assert searched == committed == 5
    assert partial <= final and len(final) == CORPUS_EXPECTED_PAIRS
    assert runs["port"] == runs["jax"]


def test_chunked_run_matches_unchunked(corpus_db, tmp_path, corpus_server, monkeypatch):
    """3-row chunks mark the relationships of one chunk, and those of the
    JAX orchestrator in 3-row chunks, with every file searched."""
    marked = {}
    for package, rows in (("port", 3), ("port", 8192), ("jax", 3)):
        monkeypatch.setattr(PACKAGES[package][2], "SEARCH_CHECKPOINT_ROWS", rows)
        corpus_server.relationships.clear()
        db, deduper = _open(package, corpus_db, tmp_path, corpus_server)
        db.begin_transaction()
        with db.conn:
            deduper.find_potential_duplicates()
        assert _searched(db) == db.execute("SELECT COUNT(*) FROM shape_search_cache").fetchone()[0]
        db.close()
        marked[package, rows] = set(corpus_server.relationships)
    assert len(marked["port", 3]) == CORPUS_EXPECTED_PAIRS
    assert marked["port", 3] == marked["port", 8192] == marked["jax", 3]


# -- the delta, on a scene library -----------------------------------------


@pytest.fixture(scope="module")
def delta_library():
    """(library blobs, its expected pairs, new blobs, the delta's expected
    pairs), pairs as undirected index tuples."""
    blobs, expected, _ = scene_library.build_corpus(N_LIBRARY, seed=7, median=MEDIAN)
    new, delta = scene_library.build_delta(
        blobs, N_NEW, n_cross=N_CROSS, n_pairs=N_NEW_PAIRS, median=MEDIAN
    )
    undirected = lambda e: {(a, b) for a, b in e if a < b}  # noqa: E731
    return blobs, undirected(expected), new, undirected(delta)


def _queue(db_mod, db_dir: Path, first: int, blobs) -> None:
    """Queue blobs as files first, first + 1, ... (stage 1's output)."""
    db_mod.set_db_dir(db_dir)
    if not db_mod.does_db_exist():
        db_mod.create_db()
    db = db_mod.DedupeDb(db_dir, db_mod.get_db_name())
    db.init_connection()
    db.conn.executemany(
        "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
        [(_file_hash(first + i), b) for i, b in enumerate(blobs)],
    )
    db.commit()
    db.close()


def _main_run(main, db_dir: Path, n_files: int, **kwargs) -> tuple[int, set, list]:
    """main(skip_hashing=True) against a fake server that lists the
    library's n_files: (returned count, marked index pairs, POSTed index
    pairs, sorted, one entry a POST)."""
    server = FakeHydrus({_file_hash(i): b"" for i in range(n_files)})
    server.start()
    try:
        pairs = main(
            api_key=DEFAULT_ACCESS_KEY, api_url=server.url, dedup_database_dir=db_dir,
            skip_hashing=True, threshold=75.0, **kwargs,
        )
    finally:
        server.stop()
    idx = {_file_hash(i): i for i in range(n_files)}
    pair = lambda a, b: tuple(sorted((idx[a], idx[b])))  # noqa: E731
    posted = sorted(pair(r["hash_a"], r["hash_b"]) for r in server.relationship_posts)
    return pairs, {pair(a, b) for a, b in server.relationships}, posted


@pytest.mark.parametrize("chunk_rows", [8192, 32])
@pytest.mark.parametrize("prefilter", ["reps", "none"])
def test_delta_run_equals_the_jax_orchestrator(
    delta_library, tmp_path, monkeypatch, prefilter, chunk_rows
):
    """A first run over the library, then a second with the new videos
    queued: both packages mark the same pairs and return the same count on
    each run; the second marks exactly the delta's plants, POSTs no pair
    of two searched videos, returns (cross + 2 x new-new) // 2, and a third
    run marks nothing. 32-row chunks put new-new pairs across chunks."""
    blobs, expected, new, delta = delta_library
    n = len(blobs)
    n_cross = sum(1 for a, _ in delta if a < n)
    assert n_cross == N_CROSS and len(delta) - n_cross == N_NEW_PAIRS
    mains = {
        "jax": functools.partial(jax_entrypoint.main, search_backend="tpu"),
        "port": functools.partial(entrypoint.main, search_backend="gpu", device="cpu"),
    }
    runs = {}
    for package, main in mains.items():
        db_mod, _, cls, _ = PACKAGES[package]
        monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", chunk_rows)
        db_dir = tmp_path / package
        _queue(db_mod, db_dir, 0, blobs)
        first = _main_run(main, db_dir, n, search_prefilter=prefilter)
        _queue(db_mod, db_dir, n, new)
        second = _main_run(main, db_dir, n + len(new), search_prefilter=prefilter)
        third = _main_run(main, db_dir, n + len(new), search_prefilter=prefilter)
        runs[package] = (first, second, third)
    assert runs["port"] == runs["jax"]
    (pairs1, marked1, _), (pairs2, marked2, posted2), (pairs3, marked3, _) = runs["port"]
    assert marked1 == expected and pairs1 == len(expected)
    assert marked2 == delta and pairs2 == (n_cross + 2 * N_NEW_PAIRS) // 2
    assert all(max(p) >= n for p in posted2)  # every POST involves a new video
    assert pairs3 == 0 and not marked3


def test_same_orchestrator_runs_the_delta_on_its_rep_cache(delta_library, tmp_path, monkeypatch):
    """Two deduplicate() calls of one orchestrator, the second after the
    new videos were queued: each sweep's rep cache is the one the engine
    clustered when stage 4 asked it whether to prune (every library
    video's reps, stamped with the radius cap find_pairs_pruned checks, so
    no chunk clusters a column again), and the runs return and mark what
    the JAX orchestrator's do."""
    blobs, expected, new, delta = delta_library
    n = len(blobs)
    caches = []
    real = GpuSearchEngine.find_pairs_pruned

    def spy(self, rows, cols, *args, col_state=None, **kwargs):
        prune = col_state["prune"]
        caches.append((len(cols), len(prune["rep_cols"]), prune["rep_cols_radius_cap"]))
        return real(self, rows, cols, *args, col_state=col_state, **kwargs)

    monkeypatch.setattr(GpuSearchEngine, "find_pairs_pruned", spy)
    clusters = []
    real_reps = reps_mod.extract_reps
    monkeypatch.setattr(
        reps_mod, "extract_reps", lambda b, *a: clusters.append(len(b)) or real_reps(b, *a)
    )
    results = {}
    for package in PACKAGES:
        db_mod, client_cls, cls, kwargs = PACKAGES[package]
        db_dir = tmp_path / package
        _queue(db_mod, db_dir, 0, blobs)
        server = FakeHydrus({})
        server.start()
        try:
            db = db_mod.DedupeDb(db_dir, db_mod.get_db_name())
            db.init_connection()
            deduper = cls(
                db, client_cls(None, server.url, DEFAULT_ACCESS_KEY, None),
                search_prefilter="reps", **kwargs,
            )
            first = deduper.deduplicate(skip_hashing=True)
            marked1 = set(server.relationships)
            _queue(db_mod, db_dir, n, new)
            second = deduper.deduplicate(skip_hashing=True)
            db.close()
        finally:
            server.stop()
        idx = {_file_hash(i): i for i in range(n + len(new))}
        undirected = lambda rel: {tuple(sorted((idx[a], idx[b]))) for a, b in rel}  # noqa: E731
        results[package] = (first, undirected(marked1), second, undirected(server.relationships))
    assert results["port"] == results["jax"]
    assert results["port"][1] == expected and results["port"][3] == expected | delta
    non_empty = lambda bs: sum(1 for b in bs if b)  # noqa: E731
    assert caches == [
        (n, non_empty(blobs), reps_mod.RADIUS_CAP),
        (n + len(new), non_empty(blobs + new), reps_mod.RADIUS_CAP),
    ]
    # each sweep's columns are clustered once (in slabs), none again by a chunk
    assert clusters == [non_empty(blobs), non_empty(blobs + new)]


# -- the engine over a searched prefix --------------------------------------


@pytest.mark.parametrize("pruned", [False, True])
def test_engine_sweeps_new_rows_against_a_searched_prefix(delta_library, pruned):
    """Stage 4's calls of a delta run: the library is the searched prefix,
    the new videos are rows in 20-row chunks, each chunk compared with the
    corpus up to its own end (col_limit) and, pruned, looked up by position
    (rows_at). The port's hits equal the JAX engine's called the same way,
    and the square sweep's restricted to the triangle past the prefix."""
    blobs, _, new, _ = delta_library
    corpus = blobs + new
    n = len(blobs)
    port, jax_engine = GpuSearchEngine(device="cpu"), TpuSearchEngine(force_segments=True)
    state, jax_state = {}, {}
    got, want = [], []
    for r0 in range(n, len(corpus), 20):
        r1 = min(r0 + 20, len(corpus))
        rows = corpus[r0:r1]
        kwargs = {"col_limit": r1}
        if pruned:
            kwargs["rows_at"] = r0
        port_fn = port.find_pairs_pruned if pruned else port.find_pairs
        jax_fn = jax_engine.find_pairs_pruned if pruned else jax_engine.find_pairs
        got += [(i + r0, j, s) for i, j, s in port_fn(rows, corpus, 75, col_state=state, **kwargs)]
        want += [
            (i + r0, j, s) for i, j, s in jax_fn(rows, corpus, 75, col_state=jax_state, **kwargs)
        ]
    assert sorted(got) == sorted(want)
    square = TpuSearchEngine(force_segments=True).find_pairs(corpus[n:], corpus, 75)
    chunk_end = lambda i: min(n + (i - n) // 20 * 20 + 20, len(corpus))  # noqa: E731
    triangle = [(i + n, j, s) for i, j, s in square if j < chunk_end(i + n)]
    assert sorted(got) == sorted(triangle)
    assert any(j < n != i for i, j, _ in got)  # hits against the searched prefix
    assert np.all(np.asarray([i for i, _, _ in got]) >= n)


# -- a fresh library, through both packages' main() -------------------------

#: the fresh libraries held against the JAX orchestrator: the mean-200
#: profile (median 160), and the 1024-frame clip with long plants, pairs
#: with a 513-1024-frame side (the pruned search's long-video complements)
FRESH_LIBRARIES = {
    "median160": {"n": 300, "median": 160.0},
    "clip1024": {"n": 200, "clip": 1024, "median": 160.0, "long_plants": (2, 1, 1)},
}


def _unsearched(db_mod, db_dir: Path) -> int:
    """Files whose search-cache entry is not marked at the threshold."""
    db = sqlite3.connect(db_dir / db_mod.get_db_name())
    try:
        return db.execute(
            "SELECT COUNT(*) FROM shape_search_cache WHERE searched_distance IS NULL"
            " OR searched_distance < ?",
            (vptree.fix_vpdq_similarity(75.0),),
        ).fetchone()[0]
    finally:
        db.close()


@pytest.mark.parametrize("library", sorted(FRESH_LIBRARIES))
def test_fresh_library_equals_the_jax_orchestrator(tmp_path, library):
    """A never-searched library queued into each package's database, then
    main(skip_hashing=True) with the user's default search_prefilter
    ("auto"), as chip_smoke.fresh_rehearsal runs it on the card: both
    packages return the same count and mark the same pairs, the planted
    set; the search cache is fully marked; a re-run marks and POSTs
    nothing."""
    kwargs = FRESH_LIBRARIES[library]
    blobs, expected, _ = scene_library.build_corpus(seed=7, **kwargs)
    planted = {(a, b) for a, b in expected if a < b}
    n = len(blobs)
    if "long_plants" in kwargs:
        long_side = [p for p in planted if max(len(blobs[i]) for i in p) // 32 > 512]
        assert len(long_side) >= 2
    mains = {
        "jax": functools.partial(jax_entrypoint.main, search_backend="tpu"),
        "port": functools.partial(entrypoint.main, search_backend="gpu", device="cpu"),
    }
    runs = {}
    for package, main in mains.items():
        db_mod = PACKAGES[package][0]
        db_dir = tmp_path / package
        _queue(db_mod, db_dir, 0, blobs)
        first = _main_run(main, db_dir, n, search_prefilter="auto")
        unsearched = _unsearched(db_mod, db_dir)
        again = _main_run(main, db_dir, n, search_prefilter="auto")
        runs[package] = (first, unsearched, again)
    assert runs["port"] == runs["jax"]
    (pairs, marked, _), unsearched, again = runs["port"]
    assert marked == planted and pairs == len(planted)
    assert unsearched == 0
    assert again == (0, set(), [])
