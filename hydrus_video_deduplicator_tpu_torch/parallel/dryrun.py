"""The multi-device dry run: every stage of the mesh path, held against the
port's own one-device result (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, stages 1-7).

    # from the repository's root, with its test suite's fake server
    python3 -c "from tests.fake_hydrus import FakeHydrus; \\
from hydrus_video_deduplicator_tpu_torch.parallel import dryrun, mesh; \\
dryrun.dryrun_multidevice(mesh.build_mesh(), FakeHydrus)"

| Stage | On the mesh | Held against |
| --- | --- | --- |
| 1 | sharded hashing (``GpuVideoHasher(mesh=...)``) | the hasher on the first member |
| 2 | the bucketed similarity block, one row slab per member, hit counts summed across members | the block on the first member |
| 3 | kernel 5's sharded launch: ``find_pairs`` on 513-1024-frame videos (the bucketed route) | the engine on the first member |
| 4 | the segment route: ``find_pairs`` on videos of at most 512 frames | the engine on the first member |
| 5 | stages 1, 2 and 4 on a 2-D layout: each device of the mesh twice, device-major (on a card, each member on a stream of its own) | the results on the mesh |
| 6 | the pruned route: ``find_pairs_pruned`` | the engine on the first member, and stage 4 |
| 7 | a miniature ``deduplicate()`` over the mesh against a fake Hydrus server | native ``matchHashBytes`` over every pair |

Where the JAX dry run reduces across devices with a collective, the port
gathers each member's result to the host. A mesh is a flat list of members
(``parallel/mesh.py``), so stage 5's second axis is the streams that share
a device rather than JAX's slices. Each stage raises on a difference.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from ..ops import similarity as ops_sim
from ..ops import similarity_block as sb
from .engine import GpuSearchEngine
from .mesh import Mesh, replicate, row_slabs


def _y4m(frames: np.ndarray) -> bytes:
    """A C444 y4m stream of uint8 [n, h, w, 3] planes (Y, U, V)."""
    n, h, w, _ = frames.shape
    out = [f"YUV4MPEG2 W{w} H{h} F1:1 Ip A1:1 C444\n".encode()]
    for f in frames:
        out += [b"FRAME\n", np.ascontiguousarray(f.transpose(2, 0, 1)).tobytes()]
    return b"".join(out)


def _hash(items, mesh: Mesh | None, device, batch_size: int) -> list[bytes]:
    from ..models.vpdq import GpuVideoHasher

    hasher = GpuVideoHasher(batch_size=batch_size, decode_workers=2, mesh=mesh, device=device)
    results = hasher.hash_videos(items)
    if any(r.error is not None for r in results):
        raise AssertionError(f"a video failed to hash: {[r.error for r in results]}")
    return [r.phash.bytes for r in results]


def _block_on_members(mesh: Mesh, packed: np.ndarray, counts: np.ndarray, pad: int):
    """The block of every video against every video, one row slab per
    member against the replicated columns; (the gathered block, the sum
    over the members of each one's hits at 100)."""
    cols = replicate(ops_sim.to_words(packed, mesh.devices[0]), mesh)
    col_counts = replicate(torch.from_numpy(counts).to(mesh.devices[0]), mesh)
    parts, hits = [], 0
    for k, (r0, r1) in enumerate(row_slabs(len(packed), mesh)):
        if r0 == r1:
            continue
        dev = mesh.devices[k]
        with mesh.member(k):
            sim = sb.similarity_block(
                ops_sim.to_words(packed[r0:r1], dev), torch.from_numpy(counts[r0:r1]).to(dev),
                cols[dev], col_counts[dev], pad, pad,
            )
            hits += int((sim >= 100).sum())  # this member's part of the reduction
            parts.append(sim.cpu().numpy())
    return np.concatenate(parts), hits


def _corpus(rng, n: int, lo: int, hi: int, n_plants: int) -> list[bytes]:
    """n random videos of lo..hi frames, the last n_plants re-encodes (a
    few bits flipped per frame) of the first ones, and one empty hash."""
    videos = [
        rng.integers(0, 256, (int(rng.integers(lo, hi + 1)), 32), dtype=np.uint8)
        for _ in range(n)
    ]
    for i in range(n_plants):
        v = videos[i].copy()
        rows = np.arange(len(v))
        cols = rng.integers(0, 32, len(v))
        v[rows, cols] ^= np.uint8(1) << rng.integers(0, 8, len(v)).astype(np.uint8)
        videos[n - 1 - i] = v
    blobs = [v.tobytes() for v in videos]
    blobs[n // 2] = b""
    return blobs


def _equal(stage: str, got, want) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(
            f"stage {stage}: the mesh gives {len(got)} results, one device {len(want)}"
        )


def dryrun_multidevice(mesh: Mesh, hydrus) -> dict:
    """Run stages 1-7 on ``mesh``; raise on the first difference from the
    one-device result. ``hydrus`` is the class of fake Hydrus API servers
    that stage 7 talks to, as ``tests/fake_hydrus.py``'s ``FakeHydrus``:
    built from a {file hash: bytes} store, with ``start()`` giving its URL,
    ``access_key``, the ``relationships`` it was sent, and ``stop()``.
    Returns a summary of what each stage compared."""
    one = mesh.devices[0]
    n = mesh.size
    rng = np.random.default_rng(0)
    summary: dict = {"mesh": repr(mesh)}

    # stage 1: sharded hashing, a partial last batch included
    videos = [_y4m(rng.integers(0, 256, (k, 64, 64, 3), dtype=np.uint8)) for k in (3, 4, 2)]
    items = list(enumerate(videos))
    hashes = _hash(items, mesh, None, 2 * n)
    if hashes != _hash(items, None, one, 2 * n) or not all(hashes):
        raise AssertionError("stage 1: the mesh hasher's hashes differ from one device's")
    summary["1 hashed frames"] = sum(len(h) // 32 for h in hashes)

    # stage 2: the row-sharded block with a cross-member reduction
    pad, n_vids = 4, 2 * n
    packed = rng.integers(0, 2**32, (n_vids, pad, 8), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(1, pad + 1, n_vids).astype(np.int32)
    sim, hits = _block_on_members(mesh, packed, counts, pad)
    want = sb.similarity_block(
        ops_sim.to_words(packed, one), torch.from_numpy(counts).to(one),
        ops_sim.to_words(packed, one), torch.from_numpy(counts).to(one), pad, pad,
    ).cpu().numpy()
    if not np.array_equal(sim, want) or hits != int((want >= 100).sum()):
        raise AssertionError("stage 2: the sharded block or its reduction differs from one device")
    if not (np.diag(sim) == 100).all():
        raise AssertionError("stage 2: a video's self-similarity is not 100")
    summary["2 block, hits at 100"] = hits

    # stage 3: kernel 5's sharded launch on the bucketed route
    long_blobs = _corpus(rng, 4, 513, 560, 1) + _corpus(rng, 3, 2, 9, 0)
    pairs = GpuSearchEngine(mesh=mesh).find_pairs(long_blobs, long_blobs, 1)
    _equal("3", pairs, GpuSearchEngine(device=one).find_pairs(long_blobs, long_blobs, 1))
    summary["3 bucketed pairs"] = len(pairs)

    # stage 4: the segment route
    blobs = _corpus(rng, 6 * n, 1, 40, n)
    seg_pairs = GpuSearchEngine(mesh=mesh).find_pairs(blobs, blobs, 1)
    _equal("4", seg_pairs, GpuSearchEngine(device=one).find_pairs(blobs, blobs, 1))
    if sum(i == j for i, j, _ in seg_pairs) != sum(1 for b in blobs if b):
        raise AssertionError("stage 4: a video does not match itself")
    summary["4 segment pairs"] = len(seg_pairs)

    # stage 5: a 2-D layout, (device, stream), rows over both jointly
    mesh2d = Mesh([d for d in mesh.devices for _ in range(2)])
    sim2d, hits2d = _block_on_members(mesh2d, packed, counts, pad)
    if not np.array_equal(sim2d, sim) or hits2d != hits:
        raise AssertionError("stage 5: the 2-D block differs from the mesh's")
    _equal("5", GpuSearchEngine(mesh=mesh2d).find_pairs(blobs, blobs, 1), seg_pairs)
    if _hash(items, mesh2d, None, 4 * n) != hashes:
        raise AssertionError("stage 5: 2-D hashing differs from the mesh's")
    summary["5 layout"] = repr(mesh2d)

    # stage 6: the pruned route
    pruned = GpuSearchEngine(mesh=mesh).find_pairs_pruned(blobs, blobs, 1)
    _equal("6", pruned, GpuSearchEngine(device=one).find_pairs_pruned(blobs, blobs, 1))
    _equal("6", pruned, seg_pairs)
    summary["6 pruned pairs"] = len(pruned)

    # stage 7: the orchestrator over the mesh
    summary["7 marked pairs"] = _deduplicate_on(mesh, rng, hydrus)
    return summary


def _deduplicate_on(mesh: Mesh, rng, hydrus) -> int:
    """Stage 2 and stage 4 of ``deduplicate()`` with its mesh set to
    ``mesh``, against a fake Hydrus server: the marked pairs must be every
    pair that native matchHashBytes puts at or above the threshold, and a
    re-run must mark none. Returns the pairs marked."""
    from .. import dedup
    from ..client import HVDClient
    from ..db import DedupeDB, vptree
    from ..vpdq import matchHashBytes

    n_lib = 96
    blobs = _corpus(rng, n_lib, 2, 8, 8)
    min_sim = max(1, 101 - vptree.fix_vpdq_similarity(75.0))
    expected = {
        (a, b)
        for a in range(n_lib)
        for b in range(a + 1, n_lib)
        if blobs[a] and blobs[b] and int(matchHashBytes(blobs[a], blobs[b])) >= min_sim
    }

    def file_hash(i: int) -> str:
        return f"{i:016x}" + "00" * 24

    db_dir = DedupeDB.get_db_dir()
    server = hydrus({})
    server.start()
    try:
        with tempfile.TemporaryDirectory(prefix="hvd_dryrun_") as td:
            DedupeDB.set_db_dir(td)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            try:
                db.conn.executemany(
                    "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
                    [(file_hash(i), blobs[i]) for i in range(n_lib)],
                )
                db.commit()
                client = HVDClient(None, server.url, server.access_key, None)
                deduper = dedup.HydrusVideoDeduplicator(db, client, search_backend="gpu")
                deduper._device_mesh = lambda: mesh
                deduper.threshold = 75.0
                db.begin_transaction()
                with db.conn:
                    deduper.process_phashed_file_queue()
                n_pairs = deduper.deduplicate(skip_hashing=True)
                idx = {file_hash(i): i for i in range(n_lib)}
                got = {tuple(sorted((idx[a], idx[b]))) for a, b in server.relationships}
                if got != expected or n_pairs != len(expected):
                    raise AssertionError(
                        f"stage 7: marked {len(got)} pairs, reported {n_pairs}, "
                        f"expected {len(expected)}"
                    )
                if deduper.deduplicate(skip_hashing=True) != 0:
                    raise AssertionError("stage 7: a re-run marked pairs")
            finally:
                db.close()
    finally:
        server.stop()
        DedupeDB.set_db_dir(db_dir)
    return n_pairs
