"""Dedupe database: SQLite store for files, perceptual hashes, the search
tree, and the resumable work queues.

Schema-, filename- and version-compatible with the reference tool
(upstream src/hydrusvideodeduplicator/db/DedupeDB.py:153-189): a
database written by either implementation can be opened by the other. The
version table stores the reference-equivalent version this framework tracks
(__about__.__compat_reference_version__) and upgrades follow the same
progressive migration thresholds (0.7.0 SqliteDict -> tables, 0.10.0 JSON
hash triples -> packed bytes).

Tables:
  version(version TEXT)
  files(hash_id PK, file_hash UNIQUE)
  shape_perceptual_hashes(phash_id PK, phash UNIQUE)
  shape_perceptual_hash_map(phash_id, hash_id)
  shape_vptree(phash_id PK, parent_id, radius, inner_id, inner_population,
               outer_id, outer_population)
  shape_maintenance_branch_regen(phash_id PK)
  shape_search_cache(hash_id PK, searched_distance)
  phashed_file_queue(file_hash UNIQUE, phash)
"""

from __future__ import annotations

import logging
import os
import sqlite3
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

from ..__about__ import __compat_reference_version__

if TYPE_CHECKING:
    from collections.abc import Iterable

log = logging.getLogger("db")

_db_dir: Path = Path()
_DB_FILE_NAME = "videohashes.sqlite"

#: Version written to new databases; tracks the reference tool's versioning
#: scheme so databases interoperate.
DB_VERSION = __compat_reference_version__


class DedupeDbException(Exception):
    """Base class for dedupe database errors."""


class SemanticVersion:
    """MAJOR.MINOR.PATCH ordering (reference DedupeDB.py:587-615)."""

    def __init__(self, version: str):
        self.version = version
        try:
            self.parts = [int(p) for p in version.split(".")]
        except ValueError as exc:
            raise DedupeDbException(f"Bad semantic version: {version}.\nFull exception: {exc}")
        if len(self.parts) != 3:
            raise DedupeDbException(f"Bad semantic version: {version}.\nFull exception: len != 3")

    def __eq__(self, other):
        return self.parts == other.parts

    def __lt__(self, other):
        return self.parts < other.parts

    def __le__(self, other):
        return self.parts <= other.parts

    def __gt__(self, other):
        return self.parts > other.parts

    def __ge__(self, other):
        return self.parts >= other.parts

    def __repr__(self):
        return f"SemanticVersion('{self.version}')"


# ---------------------------------------------------------------------------
# Module-level path management (same surface as the reference)
# ---------------------------------------------------------------------------


def set_db_dir(dir: Path) -> None:
    global _db_dir
    _db_dir = Path(dir)


def get_db_dir() -> Path:
    return _db_dir


def get_db_name() -> str:
    return _DB_FILE_NAME


def get_db_file_path() -> Path:
    return get_db_dir() / get_db_name()


def does_db_exist() -> bool:
    return get_db_file_path().is_file()


def create_db_dir() -> None:
    # exist_ok so re-runs are silent, but real failures (EACCES, EROFS,
    # ENOSPC) propagate instead of surfacing later as an opaque sqlite
    # "unable to open database file"
    os.makedirs(get_db_file_path().parent, exist_ok=True)
    log.info("Created DB dir %s", get_db_file_path().parent)


def create_db() -> None:
    """Create the database file with the full schema."""
    if not get_db_dir().exists():
        create_db_dir()
    db = DedupeDb(get_db_dir(), get_db_name())
    db.init_connection()
    db.create_tables()
    db.commit()
    db.close()


@dataclass
class DatabaseStats:
    num_videos: int
    file_size: int  # bytes


def get_db_stats(db: "DedupeDb") -> DatabaseStats:
    return DatabaseStats(db.get_num_phashed_files(), os.path.getsize(get_db_file_path()))


# ---------------------------------------------------------------------------
# The database object
# ---------------------------------------------------------------------------


class DedupeDb:
    def __init__(self, db_dir: Path, db_name: str):
        self.db_dir = Path(db_dir)
        self.db_name = db_name
        self.conn: sqlite3.Connection | None = None
        self.cur: sqlite3.Cursor | None = None

    # -- connection -------------------------------------------------------

    def init_connection(self) -> None:
        self.conn = sqlite3.connect(self.db_dir / self.db_name)
        self.cur = self.conn.cursor()
        # Connection tuning. All three pragmas are per-connection state —
        # nothing is persisted into the file, so databases stay
        # byte-compatible with reference-created ones.
        #   cache_size: SQLite's default ~2 MiB page cache thrashes once
        #     the UNIQUE-index B-trees outgrow it (file hashes and phash
        #     blobs arrive in random key order); the 10M-library stage-2
        #     drain measured a 36k -> 6k rows/s decline from exactly this
        #     (artifacts/drain_pragma_ab.py). HVD_SQLITE_CACHE_MB tunes it.
        #   temp_store MEMORY: the batched drain stages each batch in a
        #     temp table (drain_phashed_queue_batch).
        #   synchronous NORMAL: commits are resume checkpoints — app-crash
        #     safe (rollback journal), but in DELETE journal mode SQLite
        #     documents a rare power-loss corruption window under NORMAL,
        #     a durability step down from the reference's default FULL.
        #     HVD_SQLITE_SYNC=FULL restores reference durability;
        #     journal_mode stays DELETE so database FILES remain free of
        #     -wal/-shm sidecars and byte-compatible with reference ones.
        try:
            cache_mb = int(os.environ.get("HVD_SQLITE_CACHE_MB", "256"))
        except ValueError:
            cache_mb = 256
        sync = os.environ.get("HVD_SQLITE_SYNC", "NORMAL").upper()
        if sync not in ("OFF", "NORMAL", "FULL", "EXTRA"):
            sync = "NORMAL"
        for pragma in (
            f"PRAGMA cache_size = -{max(2, cache_mb) * 1024}",
            "PRAGMA temp_store = MEMORY",
            f"PRAGMA synchronous = {sync}",
        ):
            try:
                self.execute(pragma)
            except sqlite3.OperationalError:  # pragma: no cover - exotic builds
                pass
        # One-time for reference-created DBs. Tolerate read-only files:
        # the index is a perf fix, not a correctness
        # requirement, so opening must not fail on read-only media.
        try:
            self.ensure_indices()
            self.conn.commit()
        except sqlite3.OperationalError as exc:
            log.warning(
                "could not create indices on open (read-only database?): %s", exc
            )

    def execute(self, query: str, *args) -> sqlite3.Cursor:
        return self.cur.execute(query, *args)

    def executemany(self, query: str, rows) -> sqlite3.Cursor:
        return self.cur.executemany(query, rows)

    def commit(self) -> None:
        self.conn.commit()

    def begin_transaction(self) -> None:
        self.execute("BEGIN TRANSACTION")

    def close(self) -> None:
        self.conn.close()

    def vacuum(self) -> None:
        """Reclaim space. Must not be inside a transaction."""
        self.execute("VACUUM")

    # -- schema -----------------------------------------------------------

    _SCHEMA = [
        "CREATE TABLE IF NOT EXISTS version (version TEXT)",
        "CREATE TABLE IF NOT EXISTS files ( hash_id INTEGER PRIMARY KEY, file_hash BLOB_BYTES UNIQUE )",
        "CREATE TABLE IF NOT EXISTS shape_perceptual_hashes ( phash_id INTEGER PRIMARY KEY, phash BLOB_BYTES UNIQUE )",
        "CREATE TABLE IF NOT EXISTS shape_perceptual_hash_map ( phash_id INTEGER, hash_id INTEGER, PRIMARY KEY ( phash_id, hash_id ) )",
        "CREATE TABLE IF NOT EXISTS shape_vptree ( phash_id INTEGER PRIMARY KEY, parent_id INTEGER, radius INTEGER, inner_id INTEGER, inner_population INTEGER, outer_id INTEGER, outer_population INTEGER )",
        "CREATE TABLE IF NOT EXISTS shape_maintenance_branch_regen ( phash_id INTEGER PRIMARY KEY )",
        "CREATE TABLE IF NOT EXISTS shape_search_cache ( hash_id INTEGER PRIMARY KEY, searched_distance INTEGER )",
        "CREATE TABLE IF NOT EXISTS phashed_file_queue ( file_hash BLOB_BYTES NOT NULL UNIQUE, phash BLOB_BYTES NOT NULL, PRIMARY KEY ( file_hash, phash ) )",
    ]

    #: the reference probes shape_perceptual_hash_map by hash_id (its
    #: DedupeDB.py:307,356) — the (phash_id, hash_id) PK cannot serve
    #: that, so every probe is a FULL TABLE SCAN and stage 2 / per-file
    #: search degrade O(corpus^2) (measured: 960 rows/s at 20k queue
    #: rows, ~200 rows/s at ~1M — a 14-hour stage 2). This index fixes
    #: the class; it is schema-compatible both directions (an extra
    #: index is invisible to the reference tool).
    _INDICES = [
        "CREATE INDEX IF NOT EXISTS shape_perceptual_hash_map_hash_id_index"
        " ON shape_perceptual_hash_map ( hash_id )",
    ]

    def create_tables(self) -> None:
        for stmt in self._SCHEMA:
            self.execute(stmt)
        self.ensure_indices()
        self.execute("INSERT INTO version (version) VALUES (:v)", {"v": DB_VERSION})

    def ensure_indices(self) -> None:
        """Idempotent; also run on open so databases created by the
        reference tool (or older builds) gain the indices one-time."""
        if self.does_table_exist("shape_perceptual_hash_map"):
            missing = not self.execute(
                "SELECT name FROM sqlite_master WHERE type='index'"
                " AND name='shape_perceptual_hash_map_hash_id_index'"
            ).fetchone()
            if missing:
                n = self.execute(
                    "SELECT COUNT(*) FROM shape_perceptual_hash_map"
                ).fetchone()[0]
                if n > 100_000:
                    # a one-time CREATE INDEX on ~1M rows can take a while;
                    # say so instead of appearing hung at open
                    log.info(
                        "building one-time hash_id index over %d rows"
                        " (speeds up search/stage 2; may take a minute)...", n,
                    )
            for stmt in self._INDICES:
                self.execute(stmt)

    def does_table_exist(self, table: str) -> bool:
        res = self.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=:t", {"t": table}
        )
        return bool(res.fetchall())

    # -- version / migration ---------------------------------------------

    def get_version(self) -> str:
        if self.does_table_exist("version"):
            row = self.execute("SELECT version FROM version").fetchone()
            if row is None:
                # table created but its INSERT never committed (process
                # killed mid-create): fail with a clear message instead of
                # an opaque unpack TypeError
                raise RuntimeError(
                    "database version table is empty — the database is"
                    " corrupt or was only partially created; delete"
                    f" '{_DB_FILE_NAME}' and re-run"
                )
            return row[0]
        # pre-version-table databases are treated as the last version that
        # lacked one (reference DedupeDB.py:326-333)
        return "0.6.0"

    def set_version(self, version: str) -> None:
        self.execute("UPDATE version SET version = :v", {"v": version})

    def does_need_upgrade(self) -> bool:
        return SemanticVersion(self.get_version()) < SemanticVersion(DB_VERSION)

    def upgrade_db(self) -> bool:
        """Progressively upgrade an old database. Returns True if upgraded.

        Mirrors the reference's migration chain (DedupeDB.py:434-584):
        refuses downgrades; <0.7.0 migrates the SqliteDict pickle table into
        the queue; <0.10.0 converts JSON "phash,quality,frame" triples to
        packed byte blobs (byte order reversed, quality < 31 dropped).
        """
        version = self.get_version()
        if SemanticVersion(DB_VERSION) < SemanticVersion(version):
            raise DedupeDbException(
                f"Database version {version} is newer than this build supports"
                f" ({DB_VERSION}). Please upgrade the tool and try again."
            )
        if not self.does_need_upgrade():
            return False

        if SemanticVersion(version) < SemanticVersion("0.7.0"):
            log.info("Upgrading db from %s to 0.7.0", version)
            for stmt in self._SCHEMA:
                self.execute(stmt)
            if not self.execute("SELECT version FROM version").fetchone():
                self.execute("INSERT INTO version (version) VALUES ('0.6.0')")
            if self.does_table_exist("videos"):
                from pickle import loads

                rows = self.execute("SELECT key, value FROM videos").fetchall()
                for key, value in rows:
                    if value is None:
                        continue
                    try:
                        record = loads(bytes(value))
                    except Exception:
                        continue
                    if "perceptual_hash" in record:
                        self.execute(
                            "REPLACE INTO phashed_file_queue ( file_hash, phash ) VALUES ( :f, :p )",
                            {"f": key, "p": str(record["perceptual_hash"])},
                        )
            self.set_version("0.7.0")
            version = self.get_version()

        if SemanticVersion(version) < SemanticVersion("0.10.0"):
            log.info("Upgrading db from %s to 0.10.0", version)
            import json

            def convert(old_json: str) -> bytes:
                out = bytearray()
                for feature in json.loads(old_json):
                    phash_hex, quality, _frame = feature.split(",")
                    if int(quality) >= 31:
                        # pre-0.10.0 stored reversed byte order; flip to
                        # PDQ-native order (reference DedupeDB.py:535-559)
                        out += bytes.fromhex(phash_hex)[::-1]
                return bytes(out)

            for phash_id, phash in self.execute(
                "SELECT phash_id, phash FROM shape_perceptual_hashes"
            ).fetchall():
                self.execute(
                    "REPLACE INTO shape_perceptual_hashes ( phash_id, phash ) VALUES ( :i, :p )",
                    {"i": phash_id, "p": convert(phash)},
                )
            for file_hash, phash in self.execute(
                "SELECT file_hash, phash FROM phashed_file_queue"
            ).fetchall():
                self.execute(
                    "REPLACE INTO phashed_file_queue ( file_hash, phash ) VALUES ( :f, :p )",
                    {"f": file_hash, "p": convert(phash)},
                )
            self.set_version("0.10.0")
            version = self.get_version()

        self.set_version(DB_VERSION)
        return True

    # -- writes -----------------------------------------------------------

    def add_file(self, file_hash: str) -> None:
        self.execute(
            "INSERT OR IGNORE INTO files ( file_hash ) VALUES ( :f )", {"f": file_hash}
        )

    def add_perceptual_hash(self, perceptual_hash: bytes) -> int:
        """Insert (or find) a perceptual hash; returns its phash_id."""
        row = self.execute(
            "SELECT phash_id FROM shape_perceptual_hashes WHERE phash = :p",
            {"p": perceptual_hash},
        ).fetchone()
        if row is None:
            self.execute(
                "INSERT INTO shape_perceptual_hashes ( phash ) VALUES ( :p )",
                {"p": perceptual_hash},
            )
            row = self.execute(
                "SELECT phash_id FROM shape_perceptual_hashes WHERE phash = :p",
                {"p": perceptual_hash},
            ).fetchone()
        return int(row[0])

    def add_to_phashed_files_queue(self, file_hash: str, perceptual_hash: bytes) -> None:
        """Queue a hashed file for tree insertion (REPLACE on re-hash)."""
        self.execute(
            "REPLACE INTO phashed_file_queue ( file_hash, phash ) VALUES ( :f, :p )",
            {"f": file_hash, "p": perceptual_hash},
        )

    def associate_file_with_perceptual_hash(
        self, file_hash: str, perceptual_hash: bytes, build_tree: bool = True
    ) -> None:
        """Bind file <-> phash, insert the phash into the VP-tree, and reset
        the file's search cache entry. Files may share identical phashes
        (e.g. solid-color videos).

        build_tree=False defers the (expensive, O(depth x frames^2)) tree
        descent: the exact all-pairs engine never reads the tree, so
        tpu-backend runs skip it and the tree path reconciles missing
        phashes on demand (get_phashes_missing_from_tree)."""
        from . import vptree

        hash_id = self.get_hash_id(file_hash)
        phash_id = self.get_phash_id(perceptual_hash)
        assert phash_id is not None

        if build_tree:
            tree = vptree.VpTreeManager(self)
            tree.add_leaf(phash_id, perceptual_hash)

        existing = self.execute(
            "SELECT hash_id FROM shape_perceptual_hash_map WHERE hash_id = :h", {"h": hash_id}
        ).fetchone()
        if existing:
            self.execute(
                "DELETE FROM shape_perceptual_hash_map WHERE hash_id = :h", {"h": hash_id}
            )
        res = self.execute(
            "INSERT INTO shape_perceptual_hash_map ( phash_id, hash_id ) VALUES ( :p, :h )",
            {"p": phash_id, "h": hash_id},
        )
        res.fetchone()
        if res.rowcount > 0:
            self.execute(
                "REPLACE INTO shape_search_cache ( hash_id, searched_distance ) VALUES ( :h, NULL )",
                {"h": hash_id},
            )

    def drain_phashed_queue_batch(self, limit: int) -> int:
        """Set-based equivalent of one stage-2 pass over up to `limit`
        queue rows WITHOUT the per-insert tree descent (the deferred /
        tpu-backend route): add files, find-or-insert phashes, rebind the
        file->phash map, reset search-cache entries, and delete the
        processed queue rows. Returns the number of rows processed.

        Row-for-row identical end state to the per-row loop
        (add_file + add_perceptual_hash + associate_file_with_perceptual_hash
        (build_tree=False) + queue DELETE), but ~6 statements per BATCH
        instead of ~10 per ROW — the per-row python/SQLite loop measured
        ~1k rows/s at 1M queue rows (artifacts/db_scale_1m_r03.log), an
        ~17-minute stage 2 the reference's own loop shares
        (upstream src/hydrusvideodeduplicator/dedup.py:253-294)."""
        self.execute(
            "CREATE TEMP TABLE IF NOT EXISTS q_batch "
            "( file_hash BLOB_BYTES PRIMARY KEY, phash BLOB_BYTES )"
        )
        self.execute("DELETE FROM q_batch")
        self.execute(
            "INSERT INTO q_batch ( file_hash, phash ) "
            "SELECT file_hash, phash FROM phashed_file_queue LIMIT :n",
            {"n": int(limit)},
        )
        (n,) = self.execute("SELECT count(*) FROM q_batch").fetchone()
        if n == 0:
            return 0
        self.execute(
            "INSERT OR IGNORE INTO files ( file_hash ) SELECT file_hash FROM q_batch"
        )
        self.execute(
            "INSERT OR IGNORE INTO shape_perceptual_hashes ( phash ) "
            "SELECT DISTINCT phash FROM q_batch"
        )
        # re-hash semantics: a file already bound to a phash rebinds
        self.execute(
            "DELETE FROM shape_perceptual_hash_map WHERE hash_id IN "
            "( SELECT f.hash_id FROM q_batch q JOIN files f ON f.file_hash = q.file_hash )"
        )
        self.execute(
            "INSERT INTO shape_perceptual_hash_map ( phash_id, hash_id ) "
            "SELECT p.phash_id, f.hash_id FROM q_batch q "
            "JOIN files f ON f.file_hash = q.file_hash "
            "JOIN shape_perceptual_hashes p ON p.phash = q.phash"
        )
        self.execute(
            "REPLACE INTO shape_search_cache ( hash_id, searched_distance ) "
            "SELECT f.hash_id, NULL FROM q_batch q "
            "JOIN files f ON f.file_hash = q.file_hash"
        )
        self.execute(
            "DELETE FROM phashed_file_queue WHERE file_hash IN "
            "( SELECT file_hash FROM q_batch )"
        )
        self.execute("DELETE FROM q_batch")
        return int(n)

    def get_phashes_missing_from_tree(self) -> list[tuple[int, bytes]]:
        """Perceptual hashes not yet inserted into the VP-tree (deferred by
        tpu-backend runs); the tree search path inserts them before use."""
        rows = self.execute(
            "SELECT phash_id, phash FROM shape_perceptual_hashes"
            " WHERE phash_id NOT IN ( SELECT phash_id FROM shape_vptree )"
        ).fetchall()
        return [(int(r[0]), bytes(r[1])) for r in rows]

    # -- reads ------------------------------------------------------------

    def get_hash_id(self, file_hash: str) -> int | None:
        row = self.execute(
            "SELECT hash_id FROM files WHERE file_hash = :f", {"f": file_hash}
        ).fetchone()
        return row[0] if row else None

    def get_file_hash(self, hash_id: int) -> str | None:
        row = self.execute(
            "SELECT file_hash FROM files WHERE hash_id = :h", {"h": hash_id}
        ).fetchone()
        return row[0] if row else None

    def get_phash_id(self, perceptual_hash: bytes) -> int | None:
        row = self.execute(
            "SELECT phash_id FROM shape_perceptual_hashes WHERE phash = :p",
            {"p": perceptual_hash},
        ).fetchone()
        return row[0] if row else None

    def get_phash(self, phash_id: int) -> bytes | None:
        row = self.execute(
            "SELECT phash FROM shape_perceptual_hashes WHERE phash_id = :i", {"i": phash_id}
        ).fetchone()
        return row[0] if row else None

    def get_phash_id_from_hash_id(self, hash_id: int) -> int | None:
        row = self.execute(
            "SELECT phash_id FROM shape_perceptual_hash_map WHERE hash_id = :h", {"h": hash_id}
        ).fetchone()
        return row[0] if row else None

    def get_phashed_files(self) -> list[str]:
        """All file hashes that are phashed, including the pending queue."""
        rows = self.execute(
            "SELECT file_hash FROM files "
            "WHERE hash_id IN (SELECT hash_id FROM shape_perceptual_hash_map) "
            "UNION SELECT file_hash FROM phashed_file_queue"
        )
        return [r[0] for r in rows]

    def get_num_phashed_files(self) -> int:
        row = self.execute(
            "SELECT COUNT(*) FROM ("
            " SELECT file_hash FROM files"
            " WHERE hash_id IN (SELECT hash_id FROM shape_perceptual_hash_map)"
            " UNION SELECT file_hash FROM phashed_file_queue)"
        ).fetchone()
        return row[0] if row else 0

    # -- maintenance ------------------------------------------------------

    def clear_search_tree(self) -> None:
        """Dissolve the tree: move every mapped file back into the insert
        queue and clear tree + search-cache + regen tables."""
        pairs = self.execute(
            "SELECT phash_id, hash_id FROM shape_perceptual_hash_map"
        ).fetchall()
        for phash_id, hash_id in pairs:
            phash = self.get_phash(phash_id)
            file_hash = self.get_file_hash(hash_id)
            if phash is None or file_hash is None:
                log.error(
                    "clear_search_tree: dangling map row (phash_id=%s hash_id=%s); db may be corrupt",
                    phash_id,
                    hash_id,
                )
                continue
            self.add_to_phashed_files_queue(file_hash, phash)
        self.execute("DELETE FROM shape_vptree")
        self.execute("DELETE FROM shape_search_cache")
        self.execute("DELETE FROM shape_maintenance_branch_regen")

    def clear_search_cache(self) -> None:
        """Mark every file as never-searched."""
        self.execute("UPDATE shape_search_cache SET searched_distance = NULL")
