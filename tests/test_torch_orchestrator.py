"""The port's CLI ``main()`` end to end against the fake Hydrus server:
native or device hashing, stage 2, maintenance, the pruned search (through
the plain PyTorch versions on the CPU) and pair marking, against the JAX
package's ``main()`` on the same corpus; and ``main()`` over queued hashes
on the unpruned segment route against the pruned route and the VP-tree."""

from __future__ import annotations

import functools
import re
import time
import uuid
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu import entrypoint as jax_entrypoint
from hydrus_video_deduplicator_tpu_torch import dedup as port_dedup
from hydrus_video_deduplicator_tpu_torch import entrypoint
from hydrus_video_deduplicator_tpu_torch.db import DedupeDB
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

from .fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus, corpus_file_store
from .unit_tests.test_pruned_search import _mixed_corpus, _reencode, _scene_video

#: scene_b (6 encodings) + scene_d (5) + two files that match nothing:
#: C(6,2) + C(5,2) = 25 pairs, at a fraction of the full corpus's hashing
SUBSET = ("scene_b/", "scene_d/", "strange/one_frame.gif", "strange/mono.y4m")
SUBSET_PAIRS = 25


def _subset_store() -> dict[str, bytes]:
    from .fake_hydrus import sha256_hex

    videos = Path(__file__).parent / "corpus" / "videos"
    store = {}
    for vid in sorted(videos.rglob("*")):
        rel = vid.relative_to(videos).as_posix()
        if vid.is_file() and rel.startswith(SUBSET):
            data = vid.read_bytes()
            store[sha256_hex(data)] = data
    assert len(store) == 13 and set(store) <= set(corpus_file_store())
    return store


def _run(main, store, db_dir, **kwargs):
    server = FakeHydrus(store)
    server.start()
    try:
        pairs = main(
            api_key=DEFAULT_ACCESS_KEY,
            api_url=server.url,
            dedup_database_dir=Path(db_dir),
            search_prefilter="reps",
            **kwargs,
        )
        return pairs, set(server.relationships), server
    finally:
        server.stop()


def test_port_cli_marks_the_jax_pair_set_and_reruns_empty(tmp_path):
    store = _subset_store()
    jax_pairs, jax_rel, _ = _run(
        jax_entrypoint.main, store, tmp_path / uuid.uuid4().hex, search_backend="tpu"
    )
    db = tmp_path / uuid.uuid4().hex
    pairs, rel, _ = _run(entrypoint.main, store, db, search_backend="gpu", device="cpu")
    assert pairs == jax_pairs == SUBSET_PAIRS
    assert rel == jax_rel and len(rel) == SUBSET_PAIRS
    # re-run on the same database: nothing new to hash or search
    pairs2, _, server = _run(entrypoint.main, store, db, search_backend="gpu", device="cpu")
    assert pairs2 == 0
    assert "/get_files/file" not in server.requests_seen


def _stored_phashes(db_dir: Path) -> dict[str, bytes]:
    import sqlite3

    conn = sqlite3.connect(db_dir / "videohashes.sqlite")
    try:
        return dict(
            conn.execute(
                "SELECT f.file_hash, p.phash FROM files f"
                " JOIN shape_perceptual_hash_map m ON m.hash_id = f.hash_id"
                " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
            )
        )
    finally:
        conn.close()


def test_port_cli_gpu_hashing_marks_the_jax_pair_set(tmp_path):
    """--hash-backend gpu (the plain filter on the CPU) stores the same
    phash per file as the native hasher and marks the JAX main()'s 25
    pairs."""
    store = _subset_store()
    _, jax_rel, _ = _run(jax_entrypoint.main, store, tmp_path / "jax", search_backend="tpu")
    native_db, gpu_db = tmp_path / "native", tmp_path / "gpu"
    n_pairs, n_rel, _ = _run(
        entrypoint.main, store, native_db, search_backend="gpu", hash_backend="native",
        device="cpu",
    )
    g_pairs, g_rel, _ = _run(
        entrypoint.main, store, gpu_db, search_backend="gpu", hash_backend="gpu", device="cpu"
    )
    assert g_pairs == n_pairs == SUBSET_PAIRS
    assert g_rel == n_rel == jax_rel and len(g_rel) == SUBSET_PAIRS
    stored = _stored_phashes(gpu_db)
    assert set(stored) == set(store)
    assert stored == _stored_phashes(native_db)


def test_port_cli_spelling_and_unported_paths(tmp_path):
    store = _subset_store()
    with pytest.raises(SystemExit):  # the JAX spelling is not the port's
        _run(entrypoint.main, store, tmp_path / "a", search_backend="tpu", device="cpu")
    # --rerank clip without weights: refused before any connection or
    # database, as the JAX package refuses it
    server = FakeHydrus(store)
    server.start()
    try:
        with pytest.raises(SystemExit) as exc:
            entrypoint.main(
                api_key=DEFAULT_ACCESS_KEY, api_url=server.url, dedup_database_dir=tmp_path / "b",
                rerank="clip", rerank_weights=None, device="cpu",
            )
    finally:
        server.stop()
    assert exc.value.code == 1
    assert server.requests_seen == []
    assert DedupeDB.get_db_name().endswith(".sqlite")
    assert not list((tmp_path / "b").glob("*.sqlite*"))  # no database file appeared


@pytest.mark.parametrize("jax_backend, port_backend", [("tree", "tree"), ("tpu", "gpu")])
def test_rerank_counts_match_the_jax_orchestrator(tmp_path, capsys, jax_backend, port_backend):
    """At a threshold that splits the candidate pairs, the port's
    deduplicate() checks and rejects as many pairs as the JAX package's on
    the same search backend, and prints the same rerank summary."""
    from .test_torch_rerank import SPLIT_SEED, run_main, splitting_threshold, write_weights

    weights = write_weights(tmp_path / "vit.npz", SPLIT_SEED)
    threshold, kept = splitting_threshold(weights)
    store = _subset_store()
    kwargs = {"rerank_weights": str(weights), "rerank_threshold": threshold}
    jax_pairs, jax_marked, jax_summary = run_main(
        jax_entrypoint.main, store, tmp_path / "jax", capsys, search_backend=jax_backend, **kwargs
    )
    pairs, marked, summary = run_main(
        entrypoint.main, store, tmp_path / "port", capsys, search_backend=port_backend,
        device="cpu", **kwargs,
    )
    assert summary == jax_summary and summary is not None
    rejected, checked = map(int, re.findall(r"\d+", summary))
    assert 0 < rejected < checked
    assert marked == jax_marked == kept and pairs == jax_pairs == len(kept)


def test_backend_choices_map_onto_the_base_class(monkeypatch):
    """The port's orchestrator resolves its own backend names ("gpu", not
    the JAX package's "tpu"), and a named device means no device mesh
    (``test_torch_mesh.py`` covers the mesh over several devices)."""
    D = port_dedup.HydrusVideoDeduplicator

    def ns(search="auto", hash_="auto", device=None):
        return SimpleNamespace(
            threshold=50.0,
            search_backend=search,
            hash_backend=hash_,
            device=device,
            GPU_ENGINE_MIN_BATCH=D.GPU_ENGINE_MIN_BATCH,
            GPU_HASH_MIN_BATCH=D.GPU_HASH_MIN_BATCH,
        )

    assert D._pick_search_backend(ns("gpu"), 1) == "gpu"
    assert D._pick_search_backend(ns("tree"), 10_000) == "tree"
    assert D._pick_search_backend(ns(device="cpu"), D.GPU_ENGINE_MIN_BATCH) == "gpu"
    assert D._pick_search_backend(ns(device="cpu"), D.GPU_ENGINE_MIN_BATCH - 1) == "tree"
    assert D._pick_hash_backend(ns(hash_="gpu", device="cpu"), 1) == "gpu"
    assert D._pick_hash_backend(ns(hash_="native"), 10_000) == "native"
    assert D._pick_hash_backend(ns(hash_="auto", device="cpu"), 10_000) == "native"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        assert D._pick_hash_backend(ns(hash_="auto"), 10_000) == "native"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            D._pick_hash_backend(ns(hash_="gpu"), 1)
    assert D._device_mesh(ns(device="cpu")) is None
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 1)
        assert D._device_mesh(ns()) is None
    with pytest.raises(ValueError, match="unknown search backend"):
        D(None, None, search_backend="tpu")
    with pytest.raises(ValueError, match="unknown hash backend"):
        D(None, None, hash_backend="tpu")


def test_auto_hash_backend_follows_the_link_probe(monkeypatch):
    """"auto" takes the device only with a device, enough files, and a link
    the probe measures fast enough within its time budget."""
    D = port_dedup.HydrusVideoDeduplicator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def ns(mbps, device="cuda:0", delay=0.0):
        def probe(dev):
            assert dev == torch.device("cuda", 0)
            time.sleep(delay)
            if mbps is None:
                raise RuntimeError("CUDA error: no device")
            return mbps

        return SimpleNamespace(
            hash_backend="auto",
            device=device,
            GPU_HASH_MIN_BATCH=D.GPU_HASH_MIN_BATCH,
            GPU_HASH_MIN_LINK_MBPS=D.GPU_HASH_MIN_LINK_MBPS,
            HASH_PROBE_TIMEOUT_S=0.2,
            _device_link_mbps=probe,
        )

    fast, slow = 10 * D.GPU_HASH_MIN_LINK_MBPS, D.GPU_HASH_MIN_LINK_MBPS / 10
    assert D._pick_hash_backend(ns(fast), D.GPU_HASH_MIN_BATCH) == "gpu"
    assert D._pick_hash_backend(ns(fast), D.GPU_HASH_MIN_BATCH - 1) == "native"
    assert D._pick_hash_backend(ns(slow), 10_000) == "native"
    assert D._pick_hash_backend(ns(None), 10_000) == "native"  # the probe failed
    assert D._pick_hash_backend(ns(fast, device="cpu"), 10_000) == "native"
    assert D._pick_hash_backend(ns(fast, delay=1.0), 10_000) == "native"  # over budget


def _dedupe_queued(db_dir: Path, blobs: list[bytes], **kwargs) -> tuple[int, set]:
    """The port's ``main(skip_hashing=True)`` (stage 2, maintenance, stage
    4) over hashes queued straight into a fresh database, as if stage 1 had
    run: (reported count, marked corpus index pairs). A re-run must mark
    nothing."""
    def file_hash(i: int) -> str:
        return f"{i:064x}"

    DedupeDB.set_db_dir(db_dir)
    DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()
    db.conn.executemany(
        "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
        [(file_hash(i), b) for i, b in enumerate(blobs)],
    )
    db.commit()
    db.close()
    server = FakeHydrus({})
    server.start()
    try:
        run = functools.partial(
            entrypoint.main, api_key=DEFAULT_ACCESS_KEY, api_url=server.url,
            dedup_database_dir=db_dir, skip_hashing=True, device="cpu", **kwargs,
        )
        pairs = run()
        assert run() == 0
    finally:
        server.stop()
    idx = {file_hash(i): i for i in range(len(blobs))}
    return pairs, {tuple(sorted((idx[a], idx[b]))) for a, b in server.relationships}


def test_unpruned_segment_route_marks_the_pruned_and_tree_pairs(tmp_path, monkeypatch):
    """main() with search_prefilter="none" (the CLI's --search-prefilter
    none), whose find_pairs takes the segment route (the kernel's plain
    version on the CPU), marks the pairs that the pruned route and the
    VP-tree mark, long videos and an empty hash included."""
    rng = np.random.default_rng(77)
    blobs = _mixed_corpus(rng, long_video=True)
    for k in (0, 4, 8, 12):  # more planted re-encodes among short videos
        v = np.frombuffer(blobs[k], np.uint8).reshape(-1, 32)
        blobs.append(_reencode(rng, v).tobytes())
    blobs.append(_scene_video(rng, 2, 4).tobytes())
    reps = _dedupe_queued(tmp_path / "reps", blobs, search_backend="gpu", search_prefilter="reps")
    tree = _dedupe_queued(tmp_path / "tree", blobs, search_backend="tree")
    launches = []
    real = seg.similarity_segments

    def spy(*args):
        launches.append(1)
        return real(*args)

    monkeypatch.setattr(seg, "similarity_segments", spy)
    none = _dedupe_queued(tmp_path / "none", blobs, search_backend="gpu", search_prefilter="none")
    assert none == reps == tree
    assert none[0] >= 6 and launches
