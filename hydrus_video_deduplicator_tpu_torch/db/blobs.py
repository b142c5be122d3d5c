"""SQLite-backed corpus blob column for the TPU search engine.

The engine's column side needs three access patterns over the corpus
perceptual hashes (parallel/engine.py): per-video frame counts up front
(metadata), ONE ordered streaming pass to fill the device staging, and
sparse random access at hit-emission/verification time. Holding the
whole corpus as a Python list of blobs costs gigabytes at 10M videos;
this view keeps only the hash_id order and frame
counts resident (~16 bytes/video) and fetches blob bytes from SQLite in
batches (streaming) or singly through a small LRU (random access).

Schema contract: blobs live in ``shape_perceptual_hashes`` and join to
files via ``shape_perceptual_hash_map`` (reference schema,
upstream src/hydrusvideodeduplicator/db/DedupeDB.py) — the
``(hash_id)`` index this package adds makes per-id probes O(log n).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

_BLOB_SQL = (
    "SELECT m.hash_id, p.phash FROM shape_perceptual_hash_map m"
    " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
    " WHERE m.hash_id IN ({})"
)

#: SQLite bind-variable budget per IN() probe (default compile-time limit
#: is 999 on older builds; stay under it)
_IN_CHUNK = 900


def fetch_blobs(db, hash_ids) -> list[bytes]:
    """Blobs for the given hash_ids, in argument order (chunked IN())."""
    out: dict[int, bytes] = {}
    ids = [int(h) for h in hash_ids]
    for k0 in range(0, len(ids), _IN_CHUNK):
        chunk = ids[k0 : k0 + _IN_CHUNK]
        sql = _BLOB_SQL.format(",".join("?" * len(chunk)))
        for hid, blob in db.execute(sql, tuple(chunk)):
            out[int(hid)] = bytes(blob)
    return [out[h] for h in ids]


class DbBlobColumn:
    """Sequence-like corpus view: position -> phash blob, from SQLite.

    hash_ids gives the corpus order (position i holds the file
    ``hash_ids[i]``); n_frames the per-video frame counts (the engine
    reads ``blob_n_frames`` instead of fetching bytes for metadata).
    ``iter_many`` streams blobs batched; ``__getitem__`` serves sparse
    lookups through an LRU of ``LRU_CAP`` blobs.
    """

    LRU_CAP = 8192

    def __init__(self, db, hash_ids: np.ndarray, n_frames: np.ndarray):
        self.db = db
        self.hash_ids = np.ascontiguousarray(hash_ids, dtype=np.int64)
        self.blob_n_frames = np.ascontiguousarray(n_frames, dtype=np.int64)
        assert len(self.hash_ids) == len(self.blob_n_frames)
        self._lru: OrderedDict[int, bytes] = OrderedDict()

    def __len__(self) -> int:
        return len(self.hash_ids)

    def __getitem__(self, i: int) -> bytes:
        i = int(i)
        blob = self._lru.get(i)
        if blob is not None:
            self._lru.move_to_end(i)
            return blob
        (blob,) = fetch_blobs(self.db, [self.hash_ids[i]])
        self._lru[i] = blob
        if len(self._lru) > self.LRU_CAP:
            self._lru.popitem(last=False)
        return blob

    def iter_many(self, indices):
        """(position, blob) stream for the given positions, in order,
        fetched in _IN_CHUNK-sized batches (bounded host RAM)."""
        idx = np.asarray(indices, dtype=np.int64)
        for k0 in range(0, len(idx), _IN_CHUNK):
            chunk = idx[k0 : k0 + _IN_CHUNK]
            blobs = fetch_blobs(self.db, self.hash_ids[chunk])
            yield from zip(chunk.tolist(), blobs)
