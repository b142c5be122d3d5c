"""The mesh over several members at the fresh libraries' profiles, on the
CPU: ``chip_smoke.stage4_orchestrator`` runs stage 2 and saves the
database (``save_db=``, ``search=False``, as ``chip_smoke.mesh_rehearsal``
does on the card), then stage 4 of the port's orchestrator runs on a
four-member CPU mesh from a copy of it, against a one-member mesh and the
JAX orchestrator on copies of the same database, with the turn's split
read as ``chip_smoke.turn_split`` reads it; and ``mesh_rehearsal``'s
refusals: without CUDA, and without room for two databases, before it
builds anything.
"""

from __future__ import annotations

import contextlib
import importlib
import shutil
import sqlite3
import sys
import time
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from hydrus_video_deduplicator_tpu.client import HVDClient as JaxClient
from hydrus_video_deduplicator_tpu.db import DedupeDB as jax_db
from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator as JaxDeduplicator
from hydrus_video_deduplicator_tpu_torch import dedup, scene_library as sl
from hydrus_video_deduplicator_tpu_torch.client import HVDClient
from hydrus_video_deduplicator_tpu_torch.db import DedupeDB, vptree
from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel.mesh import Mesh

from .fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

#: (build_library's arguments, search_prefilter, checkpoint rows, the
#: kernels that must run on every member, the turn parts that must take
#: time): the mean-200 profile pruned, and the long tail (clip 1024, long
#: plants) unpruned, so kernels 3 and 5 run
LIBRARIES = {
    "median160-auto": (
        {"n": 200, "median": 160.0}, "auto", 67, ("exists_mask_sweep",),
        ("clustering", "staging", "route", "verify"),
    ),
    "clip1024-none": (
        {"n": 32, "clip": 1024, "median": 160.0, "long_plants": (2, 1, 1)}, "none", 11,
        ("similarity_segments", "similarity_block"), ("staging", "route", "other timed stages"),
    ),
}
KERNEL_MODULES = {"exists_mask_sweep": seg, "similarity_segments": seg, "similarity_block": sb}
MEMBERS = 4


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


def _stage4(chip_smoke, package: str, saved: Path, d: Path, n: int, prefilter: str, mesh=None):
    """Stage 4 and a re-run of ``package``'s orchestrator on a copy of
    ``saved``: ((returned count, marked index pairs, POSTed index pairs,
    files left unsearched, the re-run's count and POSTs), the port's turn
    split). The port's stage 4 runs under chip_smoke.search_timers, read
    by chip_smoke.turn_split, with the drain's split beside it."""
    db_mod, client_cls = (DedupeDB, HVDClient) if package == "port" else (jax_db, JaxClient)
    d.mkdir()
    shutil.copyfile(saved, d / db_mod.get_db_name())
    db_mod.set_db_dir(d)
    db = db_mod.DedupeDb(d, db_mod.get_db_name())
    db.init_connection()
    server = FakeHydrus({chip_smoke.file_hash(i): b"" for i in range(n)})
    server.start()
    split = None
    try:
        client = client_cls(None, server.url, DEFAULT_ACCESS_KEY, None)
        if package == "port":
            deduper = dedup.HydrusVideoDeduplicator(
                db, client, search_backend="gpu", search_prefilter=prefilter
            )
            deduper._device_mesh = lambda: mesh
            deduper.threshold = chip_smoke.THRESHOLD
            timers = chip_smoke.search_timers(set())
            t0 = time.perf_counter()
            try:
                pairs = deduper.deduplicate(skip_hashing=True)
            finally:
                timers.restore()
            split = chip_smoke.turn_split(timers.seconds, time.perf_counter() - t0)
            split["drain"] = timers.drain()
        else:
            deduper = JaxDeduplicator(db, client, search_backend="tpu", search_prefilter=prefilter)
            deduper.threshold = chip_smoke.THRESHOLD
            pairs = deduper.deduplicate(skip_hashing=True)
        posts = len(server.relationship_posts)
        again = deduper.deduplicate(skip_hashing=True)
        again_posts = len(server.relationship_posts) - posts
    finally:
        server.stop()
        db.close()
    idx = {chip_smoke.file_hash(i): i for i in range(n)}
    pair = lambda a, b: tuple(sorted((idx[a], idx[b])))  # noqa: E731
    posted = sorted(pair(r["hash_a"], r["hash_b"]) for r in server.relationship_posts)
    marked = {pair(a, b) for a, b in server.relationships}
    conn = sqlite3.connect(d / db_mod.get_db_name())
    try:
        unsearched = chip_smoke.unsearched_files(
            conn, vptree.fix_vpdq_similarity(chip_smoke.THRESHOLD)
        )
    finally:
        conn.close()
    return (pairs, marked, posted, unsearched, (again, again_posts)), split


def _count_members(monkeypatch, kernels) -> dict:
    """Launches of each kernel wrapper by member index, read from the
    member whose ``Mesh.member`` block the launch ran in (every member of
    a CPU mesh is the same device)."""
    current: list = [None]
    real_member = Mesh.member

    @contextlib.contextmanager
    def member(self, k):
        current[0] = k
        try:
            with real_member(self, k):
                yield
        finally:
            current[0] = None

    monkeypatch.setattr(Mesh, "member", member)
    launched = {name: {} for name in kernels}
    for name in kernels:
        module = KERNEL_MODULES[name]
        real = getattr(module, name)

        def counted(*args, _name=name, _real=real):
            k = current[0]
            launched[_name][k] = launched[_name].get(k, 0) + 1
            return _real(*args)

        monkeypatch.setattr(module, name, counted)
    return launched


@pytest.mark.parametrize("library", sorted(LIBRARIES))
def test_stage4_on_a_four_member_mesh_from_a_saved_database(
    chip_smoke, tmp_path, monkeypatch, library
):
    """A library saved after stage 2 by chip_smoke.stage4_orchestrator
    (save_db=, search=False), then stage 4 from a copy of it on a
    four-member CPU mesh, on a one-member mesh and through the JAX
    orchestrator, in several triangle chunks: the same count, the same
    marked pairs (the planted set) and the same POSTs; the cache fully
    marked; a re-run marking and POSTing nothing; every kernel of the
    route launched on each of the four members; and the turn's split
    (turn_split) summing to its seconds, with time in the route's parts
    and drained row tiles."""
    kwargs, prefilter, chunk_rows, kernels, timed = LIBRARIES[library]
    blobs, planted, n_empty, min_sim = chip_smoke.build_library(**kwargs)
    n = len(blobs)
    if "long_plants" in kwargs:
        assert any(max(len(blobs[i]) for i in p) // 32 > sl.SEG_MAX_FRAMES for p in planted)
    for cls in (dedup.HydrusVideoDeduplicator, JaxDeduplicator):
        monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", chunk_rows)
    assert -(-n // chunk_rows) >= 3
    monkeypatch.setenv("HVD_SQLITE_CACHE_MB", "1024")
    saved = tmp_path / "stage2.sqlite"
    assert chip_smoke.stage4_orchestrator(
        "test", blobs, planted, n_empty, min_sim, set(), save_db=str(saved), search=False,
        workdir=str(tmp_path), device="cpu", search_prefilter=prefilter,
    ) is None
    conn = sqlite3.connect(saved)
    try:  # stage 2 done, stage 4 not begun
        assert conn.execute("SELECT count(*) FROM phashed_file_queue").fetchone()[0] == 0
        assert chip_smoke.unsearched_files(
            conn, vptree.fix_vpdq_similarity(chip_smoke.THRESHOLD)
        ) == n
    finally:
        conn.close()

    runs, launched, splits = {}, {}, {}
    for label, size in (("mesh", MEMBERS), ("one", 1)):
        with monkeypatch.context() as m:
            launched[label] = _count_members(m, kernels)
            runs[label], splits[label] = _stage4(
                chip_smoke, "port", saved, tmp_path / label, n, prefilter, Mesh(["cpu"] * size)
            )
    runs["jax"], _ = _stage4(chip_smoke, "jax", saved, tmp_path / "jax", n, prefilter)

    assert runs["mesh"] == runs["one"] == runs["jax"]
    pairs, marked, posted, unsearched, again = runs["mesh"]
    assert marked == planted and pairs == len(planted) and len(posted) == len(planted)
    assert unsearched == 0
    assert again == (0, 0)
    for name in kernels:
        assert sorted(launched["mesh"][name]) == list(range(MEMBERS)), (name, launched["mesh"])
        assert sorted(launched["one"][name]) == [0], (name, launched["one"])
    for label, split in splits.items():
        fetch, host, tiles = split.pop("drain")
        assert tiles > 0 and fetch >= 0 and host >= 0, (label, tiles, fetch, host)
        assert all(split[part] > 0 for part in timed), (label, split)
        assert split["rest"] >= 0, (label, split)
        assert set(split) == set(chip_smoke.TURN_PARTS) | {"other timed stages", "rest"}


DiskUsage = namedtuple("DiskUsage", "total used free")


def test_mesh_rehearsal_asks_for_two_databases_before_building(chip_smoke, tmp_path, monkeypatch):
    """mesh_rehearsal asks for FRESH_BYTES_PER_FRAME bytes a frame for two
    databases (the saved one and a turn's copy), fresh_rehearsal for one:
    with room for one only, mesh_rehearsal raises before it builds,
    compiles or asks the card anything, where fresh_rehearsal goes on to
    build; with room for two, mesh_rehearsal goes on too."""
    n, median = 1_000_000, 160.0
    one_db = chip_smoke.FRESH_BYTES_PER_FRAME * 206_742_884  # the library's frames

    class Built(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Built

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("build_library", "phase0_build", "stage4_orchestrator", "turn_meshes"):
        monkeypatch.setattr(chip_smoke, name, refuse)
    monkeypatch.setattr(chip_smoke, "card_lines", lambda: ["CPU"])
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "CPU")
    free = {"bytes": one_db * 3 // 2}
    monkeypatch.setattr(
        chip_smoke.shutil, "disk_usage", lambda path: DiskUsage(0, 0, free["bytes"])
    )
    assert chip_smoke.check_free_space("x", n, 512, median, str(tmp_path))[:2] == (
        206_742_884, one_db
    )
    with pytest.raises(RuntimeError, match=r"mesh_rehearsal: 2 database\(s\) of 206742884 frames"):
        chip_smoke.mesh_rehearsal(n, median=median, workdir=str(tmp_path))
    with pytest.raises(Built):
        chip_smoke.fresh_rehearsal(n, median=median, workdir=str(tmp_path))
    free["bytes"] = 2 * one_db
    with pytest.raises(Built):
        chip_smoke.mesh_rehearsal(n, median=median, workdir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("rehearsal", ["fresh_rehearsal", "mesh_rehearsal"])
def test_rehearsals_raise_without_cuda(chip_smoke, monkeypatch, rehearsal):
    """Without CUDA a rehearsal raises before it checks the disk, builds a
    library or asks the card anything: there is no CPU run of it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    for name in ("build_library", "check_free_space", "card_line", "card_lines", "phase0_build"):
        monkeypatch.setattr(chip_smoke, name, refuse)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(chip_smoke, rehearsal)(1_000_000)
