"""The cells: one cell's library, set-up, timed step and check.

A traffic file names its kind of step (``"step"``); ``steps/<step>.py``
gives the kind's ``Cell`` class, found by that name, so a new kind is a
new file. The kinds so far, whose classes live here:

- ``search``: a user's ``--clear-search-cache`` re-run over a scene
  library in the program's database: ``DedupeDb.clear_search_cache()``,
  then ``deduplicate(skip_hashing=True)`` on a new
  ``HydrusVideoDeduplicator``. Untimed before it, the fake server's
  relationships are emptied.
- ``delta``: a returning user's run once stage 1 has queued new videos:
  ``deduplicate(skip_hashing=True)`` on the database saved after set-up's
  full search. Untimed before it, the database file is restored from that
  copy and the queue is filled.
- ``sweep``: one exact all-pairs sweep of a library through one
  ``GpuSearchEngine.find_pairs`` a row chunk, with one shared
  ``col_state`` (column staging included).

The program's modules are imported inside the functions, so that the
benchmark's tests import this module without them.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

from . import check, library

QUEUE_BATCH = 50_000
RESTORE_BLOCK = 1 << 20
#: the unit restore_file rewrites: SQLite's page size (DedupeDB's default)
RESTORE_PAGE = 4096


def file_hash(i: int) -> str:
    """The Hydrus file hash of video i (64 hex digits, the index first)."""
    return f"{i:016x}" + "00" * 24


def file_index(h: str) -> int:
    return int(h[:16], 16)


def min_similarity(threshold: float) -> int:
    """The least integer similarity a pair needs at ``threshold``."""
    return max(1, int(threshold))


def restore_file(src: Path, dst: Path, block: int = RESTORE_BLOCK, page: int = RESTORE_PAGE) -> int:
    """Make ``dst`` equal to ``src`` byte for byte, writing only the pages
    that differ (a delta step touches pages all over a large database, but
    few of them): returns the bytes written."""
    written = 0
    size = src.stat().st_size
    with open(src, "rb") as s, open(dst, "r+b") as d:
        for off in range(0, size, block):
            a = s.read(block)
            b = d.read(len(a))
            if a == b:
                continue
            for p in range(0, len(a), page):
                if a[p : p + page] != b[p : p + page]:
                    d.seek(off + p)
                    d.write(a[p : p + page])
                    written += len(a[p : p + page])
            d.seek(off + len(a))
        d.truncate(size)
    return written


def warm_up(cell) -> None:
    """The traffic's ``warmup_steps`` steps (default 1), untimed and
    unchecked, at the cell's own shapes: every kernel is built and loaded,
    and the process's first searches are behind it."""
    for k in range(cell.traffic.get("warmup_steps", 1)):
        cell.prepare()
        cell.step()
        cell.record()
        cell.log(f"warm-up step {k + 1} done")
    cell.outputs.clear()


class SceneCell:
    """A scene library in the program's database behind a fake Hydrus
    server, searched by the orchestrator (steps ``search`` and ``delta``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str | None, log):
        self.config, self.traffic, self.seed, self.device, self.log = (
            config, traffic, seed, device, log,
        )
        self.kind = traffic["step"]
        self.min_sim = min_similarity(config["threshold"])
        self.outputs: list = []

    # -- set-up ------------------------------------------------------------

    def _deduper(self):
        from hydrus_video_deduplicator_tpu_torch import dedup

        d = dedup.HydrusVideoDeduplicator(
            self.db, client=self.client, search_backend="gpu",
            search_prefilter=self.traffic["prefilter"], device=self.device,
        )
        d.threshold = float(self.config["threshold"])
        return d

    def _queue(self, blobs, first: int) -> None:
        for i0 in range(0, len(blobs), QUEUE_BATCH):
            self.db.conn.executemany(
                "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
                [(file_hash(first + i), blobs[i]) for i in range(i0, min(i0 + QUEUE_BATCH, len(blobs)))],
            )
        self.db.commit()

    def _open(self) -> None:
        from hydrus_video_deduplicator_tpu_torch.db import DedupeDB

        self.db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        self.db.init_connection()

    def build(self) -> None:
        """The library from the seed (and the delta's new videos)."""
        cfg = self.config
        self.blobs, _, _, self.planted = library.build_corpus(
            cfg["n_videos"], seed=self.seed, clip=cfg["clip_frames"],
            long_plants=tuple(cfg["long_plants"]), median=cfg["median_frames"],
        )
        self.n = len(self.blobs)
        self.log(f"library: {self.n} videos, {sum(map(len, self.blobs)) // 32} frames")
        if self.kind == "delta":
            t = self.traffic
            self.new, _, self.delta_planted = library.build_delta(
                self.blobs, t["n_new"], t["n_cross"], t["n_pairs"], cfg["median_frames"],
                seed=[self.seed, library.DELTA_SEED],
            )
            self.log(f"delta: {len(self.new)} new videos")

    def setup(self) -> None:
        from hydrus_video_deduplicator_tpu_torch.client import HVDClient
        from hydrus_video_deduplicator_tpu_torch.db import DedupeDB

        from .fake_hydrus import ACCESS_KEY, FakeHydrus

        self.build()
        self.tmp = tempfile.TemporaryDirectory(prefix="hvd_bench_")
        DedupeDB.set_db_dir(self.tmp.name)
        DedupeDB.create_db()
        self.db_path = Path(DedupeDB.get_db_file_path())
        self._open()
        self.server = FakeHydrus()
        self.server.start()
        self.client = HVDClient(None, self.server.url, ACCESS_KEY, None)
        self._queue(self.blobs, 0)
        self.log("queue filled")
        deduper = self._deduper()
        self.db.begin_transaction()
        with self.db.conn:
            deduper.process_phashed_file_queue()
        self.log("stage 2 done")
        self.db.begin_transaction()
        with self.db.conn:
            deduper.run_maintenance()
        self.log("maintenance done")
        if self.kind == "delta":
            self.first_search = deduper.deduplicate(skip_hashing=True)
            self.log(f"the library's first search marked {self.first_search} pairs")
            self.db.close()
            self.saved = Path(self.tmp.name) / "searched.sqlite"
            shutil.copyfile(self.db_path, self.saved)
            self._open()
        warm_up(self)

    # -- the window --------------------------------------------------------

    def prepare(self) -> None:
        """Untimed, before each step."""
        if self.kind == "delta":
            self.db.close()
            restored = restore_file(self.saved, self.db_path)
            self.log(f"database restored: {restored} bytes rewritten")
            self._open()
            self._queue(self.new, self.n)
        self.server.clear_relationships()

    def step(self) -> None:
        if self.kind == "search":
            self.db.begin_transaction()
            with self.db.conn:
                self.db.clear_search_cache()
        self.count = self._deduper().deduplicate(skip_hashing=True)

    def record(self) -> None:
        """Untimed, after each step: what it left for the check."""
        rel = {tuple(sorted((file_index(a), file_index(b)))) for a, b in self.server.relationships}
        posts = [
            tuple(sorted((file_index(r["hash_a"]), file_index(r["hash_b"]))))
            for r in self.server.relationship_posts
        ]
        (unsearched,) = self.db.execute(
            "SELECT count(*) FROM shape_search_cache WHERE searched_distance IS NULL"
        ).fetchone()
        self.outputs.append((rel, posts, self.count, unsearched))

    def close(self) -> None:
        self.server.stop()
        self.db.close()
        self.tmp.cleanup()

    # -- the check ---------------------------------------------------------

    def library(self) -> tuple[list, list, int]:
        """(every video's hash, the planted pairs in scope, the first
        video in scope)."""
        if self.kind == "delta":
            return self.blobs + self.new, self.delta_planted, self.n
        return self.blobs, self.planted, 0

    def truth(self, ref_device) -> check.Truth:
        blobs, planted, scope = self.library()
        lens = np.fromiter((len(b) // 32 for b in blobs), dtype=np.int64, count=len(blobs))
        rng = np.random.default_rng([self.seed, 2])
        sample = check.sample_rows(rng, lens, np.arange(scope, len(blobs)), self.traffic)
        return check.build_truth(blobs, planted, self.min_sim, sample, ref_device, scope)

    def verdict(self, truth: check.Truth) -> check.Verdict:
        v = check.Verdict()
        for rel, posts, count, unsearched in self.outputs:
            v.add(check.marked_step(truth, rel, posts, count, unsearched, self.kind == "delta"))
        return v


class SweepCell:
    """Short clips held in memory, swept whole by the engine (step
    ``sweep``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str | None, log):
        self.config, self.traffic, self.seed, self.device, self.log = (
            config, traffic, seed, device, log,
        )
        self.min_sim = min_similarity(config["threshold"])
        self.outputs: list = []

    def build(self) -> None:
        cfg = self.config
        self.blobs, _, _, self.planted = library.build_sweep_corpus(
            cfg["n_videos"], cfg["lengths"], seed=self.seed, frames=cfg["frames"],
            n_plant=cfg["n_plant"], n_far=cfg["n_plant_far"], n_empty=cfg["n_empty"],
        )
        self.n = len(self.blobs)
        self.log(f"library: {self.n} videos, {sum(map(len, self.blobs)) // 32} frames")

    def setup(self) -> None:
        self.build()
        warm_up(self)

    def prepare(self) -> None:
        self.hits = None

    def step(self) -> None:
        from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

        chunk = self.traffic["chunk_rows"]
        triangle = self.traffic["mode"] == "triangle"
        if self.device is None:
            from hydrus_video_deduplicator_tpu_torch.parallel.mesh import build_mesh

            engine = GpuSearchEngine(mesh=build_mesh())
        else:
            engine = GpuSearchEngine(device=self.device)
        col_state: dict = {}
        self.hits = [
            (i0, engine.find_pairs(
                self.blobs[i0 : i0 + chunk], self.blobs, self.min_sim, col_state=col_state,
                col_limit=min(i0 + chunk, self.n) if triangle else None,
            ))
            for i0 in range(0, self.n, chunk)
        ]

    def record(self) -> None:
        parts = [
            np.asarray(h, dtype=np.int64).reshape(-1, 3) + np.asarray([i0, 0, 0])
            for i0, h in self.hits
        ]
        self.outputs.append(np.concatenate(parts) if parts else np.zeros((0, 3), np.int64))
        self.hits = None

    def close(self) -> None:
        pass

    def library(self) -> tuple[list, list, int]:
        return self.blobs, self.planted, 0

    def truth(self, ref_device) -> check.Truth:
        lens = np.fromiter((len(b) // 32 for b in self.blobs), dtype=np.int64, count=self.n)
        rng = np.random.default_rng([self.seed, 2])
        sample = check.sample_rows(rng, lens, np.arange(self.n), self.traffic)
        return check.build_truth(self.blobs, self.planted, self.min_sim, sample, ref_device)

    def verdict(self, truth: check.Truth) -> check.Verdict:
        lens = np.fromiter((len(b) // 32 for b in self.blobs), dtype=np.int64, count=self.n)
        v = check.Verdict()
        for hits in self.outputs:
            v.add(check.sweep_step(truth, hits, lens))
        return v


STEPS = Path(__file__).resolve().parents[1] / "steps"


def step_kind(name: str):
    """The ``Cell`` class of the step kind ``name`` (``steps/<name>.py``)."""
    path = STEPS / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no step kind {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location("hvdb_step_" + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Cell


def make(config: dict, traffic: dict, seed: int, device: str | None, log):
    """The traffic's cell. ``device`` is the one CUDA device of a one-chip
    cell, or None for a cell over several, whose program spreads itself
    over every visible device (the orchestrator's and the engine's mesh)."""
    return step_kind(traffic["step"])(config, traffic, seed, device, log)


def set_env(config: dict) -> None:
    """The program settings a configuration passes through the environment."""
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)
