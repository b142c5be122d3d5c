"""Exact all-pairs VPDQ similarity search on a GPU (counterpart of the JAX
package's ``parallel/engine.py``).

``GpuSearchEngine.find_pairs_pruned`` is stage 4's main path:

1. host: ``ops.reps.extract_reps`` clusters each video's frames into scene
   leaders (native C++, the port's copy of the JAX package's clustering);
2. stage A: the existence mask sweep (``ops.similarity_segments``, a
   hand-written CUDA kernel) compares every row leader with every column
   leader at the inflated tolerance 31 + 2 * radius_cap; the column
   leaders stay on the device, bit-packed, across the checkpointed chunks
   of a sweep (``col_state``);
3. drain: ``torch.nonzero`` over the row-packed masks on the device, then
   a host bit decode (word w, bit b -> row slot 32w+b) to candidate pairs;
4. stage B: ``ops.pair_verify.verify_pairs`` computes each candidate's
   exact similarity.

``GpuSearchEngine.find_pairs`` is the unpruned search (stage 4 under
``--search-prefilter none``, or when ``auto`` declines the prune). Pairs of
videos of up to SEG_MAX_FRAMES frames take the segment route: the full
column frames are staged on the device once per sweep, each row tile is
one launch of the segment similarity kernel (``ops.similarity_segments``,
a hand-written CUDA kernel; its plain version on the CPU) in its mask
mode with a hit list, and the drain reads each hit's integer similarity
from that list, as the kernel computed it. A slab whose hits outgrow its
list drains its mask as stage A's do, and only those hits are scored on
the host (native ``matchHashBytes``). Pairs with a video of
SEG_MAX_FRAMES+1..MAX_BUCKET frames take the bucketed route: videos padded
to a power of two, each (row tile, column tile) of a bucket pair one launch
of the bucketed similarity kernel (``ops.similarity_block``, a
hand-written CUDA kernel; its plain version on the CPU), hits found on the
device. Longer videos are compared exactly on the host. The pruned search
reaches those two routes through ``find_pairs`` for its long-video
complements.

Over a mesh (``parallel.mesh``) both device routes shard their row tiles
over the members, with the columns replicated to every device.

Both searches mark their work with the recorder's spans and counts
(``utils.profiling.span``; README, "Stage 4's timing lines"). With
``HVD_DEBUG_TIMING`` set, the pruned search prints ``[prune-timing]`` laps
and both segment routes ``[seg-timing]`` laps with a ``drain split`` line,
in the JAX package's formats, from those spans (``utils.profiling.Laps``).
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import pair_verify
from ..ops import reps as reps_mod
from ..ops import similarity as ops_sim
from ..ops import similarity_block as sb
from ..ops import similarity_segments as seg
from ..ops.similarity import BYTES, LANES, TOL
from ..utils.profiling import NULL_SPAN, Laps, count, span
from ..vpdq import matchHashBytes
from .mesh import Mesh, replicate, resolve_mesh, row_slabs

#: videos longer than this many frames skip the bucketed device path and
#: are compared exactly on the host (native matchHashBytes)
MAX_BUCKET = sb.MAX_FRAMES


def _bucket_size(n_frames: int) -> int:
    p = 1
    while p < n_frames:
        p <<= 1
    return p


def iter_blob_items(src, indices):
    """(index, blob) stream over a blob source for the given indices.

    Sources that implement ``iter_many`` (DB-backed columns) stream in
    batches; plain sequences fall back to per-item indexing."""
    if hasattr(src, "iter_many"):
        return src.iter_many(indices)
    return ((int(i), src[int(i)]) for i in indices)


def blob_frame_counts(src) -> np.ndarray:
    """Per-video frame counts without holding blob bytes (DB-backed sources
    expose ``blob_n_frames``)."""
    if hasattr(src, "blob_n_frames"):
        return np.asarray(src.blob_n_frames, dtype=np.int64)
    return np.fromiter((len(b) // BYTES for b in src), dtype=np.int64, count=len(src))


#: next power of two for every legal bucketed frame count (1..MAX_BUCKET)
_POW2_TABLE = np.asarray(
    [_bucket_size(max(n, 1)) for n in range(MAX_BUCKET + 1)], dtype=np.int64
)


@dataclass
class _Bucket:
    pad: int
    video_idx: np.ndarray  # int64 corpus indices (ascending)
    counts: np.ndarray  # int32 frame counts, aligned with video_idx


class CorpusIndex:
    """Host-side index of a corpus of packed hashes, bucketed by length.

    Construction reads only frame counts; a bucket's packed frames
    materialize on demand in ``bucket_arrays``. Videos with more than
    MAX_BUCKET frames are kept in ``long`` with their blobs.
    """

    def __init__(self, phashes):
        self.src = phashes
        self.n = len(phashes)
        self.n_frames = blob_frame_counts(phashes) if self.n else np.zeros(0, np.int64)
        self.buckets: dict[int, _Bucket] = {}
        bucketable = (self.n_frames > 0) & (self.n_frames <= MAX_BUCKET)
        pads = np.zeros(self.n, dtype=np.int64)
        pads[bucketable] = _POW2_TABLE[self.n_frames[bucketable]]
        for pad in np.unique(pads[bucketable]):
            sel = np.nonzero(pads == pad)[0].astype(np.int64)
            self.buckets[int(pad)] = _Bucket(
                int(pad), sel, self.n_frames[sel].astype(np.int32)
            )
        self.long: list[tuple[int, bytes]] = list(
            iter_blob_items(phashes, np.nonzero(self.n_frames > MAX_BUCKET)[0])
        )

    def bucket_arrays(self, pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        b = self.buckets[pad]
        frames = np.zeros((len(b.video_idx), pad, LANES), dtype=np.uint32)
        for k, (_i, blob) in enumerate(iter_blob_items(self.src, b.video_idx)):
            n = len(blob) // BYTES
            frames[k, :n] = ops_sim.blobs_to_packed(blob)
        return b.video_idx, frames, b.counts


class SegColumns:
    """Column-side view of the segment-eligible corpus: indices and frame
    counts up front, blob bytes streamed once by the staging fill."""

    def __init__(self, indices: np.ndarray, counts: np.ndarray, src):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.counts = np.asarray(counts, dtype=np.int32)
        self.src = src

    def iter_items(self):
        return iter_blob_items(self.src, self.indices)


def seg_columns_from_pairs(pairs: "list[tuple[int, bytes]]") -> SegColumns:
    """SegColumns over a materialized [(corpus_idx, blob)] list (the pruned
    route's rep columns)."""
    by = {int(i): b for i, b in pairs}
    idx = np.fromiter((i for i, _ in pairs), dtype=np.int64, count=len(pairs))
    cnt = np.fromiter(
        (len(b) // BYTES for _, b in pairs), dtype=np.int32, count=len(pairs)
    )
    return SegColumns(idx, cnt, by)


def seg_columns(cols: CorpusIndex) -> SegColumns:
    """The segment-eligible columns of a corpus index, bucket by bucket in
    ascending pad order (as the JAX route stages them); indices ascend
    within a bucket, so ``col_limit``'s step gating still skips the steps
    past the triangle."""
    idx = np.concatenate(
        [np.zeros(0, np.int64)]
        + [cols.buckets[p].video_idx for p in sorted(cols.buckets) if p <= seg.SEG_MAX_FRAMES]
    )
    return SegColumns(idx, cols.n_frames[idx], cols.src)


def state_from_jax(col_state: dict) -> dict:
    """A port ``col_state`` from a JAX engine's one.

    Carries the host-side pruned-search state — the column scene
    representatives ``prune.rep_cols`` with the ``rep_cols_radius_cap``
    they were clustered at, and the column frame counts — so both engines
    sweep from the same reps. Device staging is not carried: the port
    stages its own columns on first use.
    """
    prune = col_state.get("prune", {})
    out: dict = {}
    if "rep_cols" in prune:
        out["prune"] = {
            "rep_cols": [(int(i), bytes(b)) for i, b in prune["rep_cols"]],
            "rep_cols_radius_cap": int(prune["rep_cols_radius_cap"]),
        }
    if "col_n_frames" in col_state:
        out["col_n_frames"] = np.asarray(col_state["col_n_frames"], dtype=np.int64).copy()
    return out


def _emptied(phashes, keep: set) -> list[bytes]:
    """``phashes`` as a list with every video whose index is not in ``keep``
    emptied (an empty blob matches nothing): the inputs of the pruned
    search's complement sweeps. Reads only the kept videos' blobs."""
    return [phashes[i] if i in keep else b"" for i in range(len(phashes))]


def _with_similarities(hits, row_phashes, all_phashes, fallback) -> list[tuple[int, int, int]]:
    """The unpruned segment route's hits, every one a (row, col, integer
    similarity) triple: the route's triples carry kernel 3's similarities;
    each ``hits[a:b]`` for (a, b) in ``fallback`` holds the (row, col)
    pairs of a slab whose hit list overflowed, scored here with native
    matchHashBytes, the kernel's own value by construction. Fills them in
    place and returns ``hits``. DB-backed columns (``iter_many``) fetch
    the scored columns' blobs in batched IN() probes, not one SELECT per
    hit; without a fallback nothing is fetched."""
    with span("seg.similarities"):
        count("seg.host_hits", sum(b - a for a, b in fallback))
        if not fallback:
            return hits
        col_blobs = all_phashes
        if hasattr(all_phashes, "iter_many"):
            with span("seg.similarities.fetch"):
                need = sorted({j for a, b in fallback for _, j in hits[a:b]})
                col_blobs = dict(all_phashes.iter_many(need))
        for a, b in fallback:
            hits[a:b] = [
                (i, j, int(matchHashBytes(row_phashes[i], col_blobs[j], TOL))) for i, j in hits[a:b]
            ]
        return hits


class _SegLaps(Laps):
    """The ``[seg-timing]`` laps of one segment route, printed from its
    spans: the column staging (``seg.stage``), the first row pack and the
    first 8 tiles' dispatches, then the rest of the route (``seg.route``,
    held here as ``route``) with the caller's work on the hits, and the
    drain's split: ``fetch``, the ``seg.drain.fetch`` spans (``torch.nonzero``
    and the copies to the host, which wait on the device), ``host``, the
    ``seg.drain.decode`` spans (the bit decode and the slot mapping) with
    the caller's similarities, over the ``seg.tiles`` row tiles; then the
    hits whose similarity came from kernel 3's hit lists
    (``seg.device_sims``) and the slabs that fell back to their mask
    (``seg.sims_overflow``), both 0 on stage A's route."""

    def __init__(self):
        super().__init__("[seg-timing]")
        self.route = NULL_SPAN
        self.shown = 0.0  # seconds of the route's laps printed so far

    def part(self, label: str, part, *counts: int) -> None:
        """A lap of one span of the route."""
        if self.on:
            self.shown += part.seconds
            self(label, *counts, seconds=part.seconds)

    def drain_split(self, similarities: float = 0.0) -> None:
        """The route's last lap and its drain split, ``similarities`` the
        seconds the caller spent on the hits' similarities; the JAX route's
        dense fallback has no counterpart here, so its count is always 0."""
        route = self.route
        self("row tiles + drain", seconds=route.seconds - self.shown + similarities)
        if self.on:
            fetch = route.child_seconds("seg.drain.fetch")
            host = route.child_seconds("seg.drain.decode") + similarities
            counts = route.counts
            print(
                f"{self.tag} drain split: fetch {fetch:.1f}s host {host:.1f}s "
                f"over {counts.get('seg.tiles', 0)} row tiles (0 dense-fallback groups); "
                f"{counts.get('seg.device_sims', 0)} device sims, "
                f"{counts.get('seg.sims_overflow', 0)} overflowed slabs",
                flush=True,
            )


def decode_mask_hits(word_rows: np.ndarray, cols: np.ndarray, words: np.ndarray):
    """Set bits of row-packed mask words -> (row slot, column slot) arrays.

    word_rows/cols: positions of nonzero words in a [rows/32, col slots]
    mask; words: their int32 values. Bit b of the word at [w, c] is row
    slot 32w+b, column slot c (the layout of the sweep's output).
    """
    u8 = np.ascontiguousarray(words, dtype=np.int32).view(np.uint8).reshape(-1, 4)
    bits = np.unpackbits(u8, axis=1, bitorder="little")  # [M, 32]
    m_i, bit_i = np.nonzero(bits)
    return np.asarray(word_rows)[m_i] * 32 + bit_i, np.asarray(cols)[m_i]


class GpuSearchEngine:
    """Exact all-pairs similarity search over packed VPDQ hashes on one
    device or over a mesh. ``device`` defaults to CUDA and raises without
    it; tests pass ``device="cpu"`` to run every kernel's plain PyTorch
    version.

    ``mesh`` (a ``parallel.mesh.Mesh``, exclusive with ``device``) shards
    the row side of every device launch over its members, as the JAX
    engine's shard_map wrappers do: each row tile splits into one slab per
    member (``row_slabs``), launched under that member's device and stream
    against the columns replicated to its device, and the slabs' hits are
    gathered by row offset. Without one, the engine is a mesh of its one
    device. Stage B (``verify_pairs``) runs on the first member, and the
    longest videos on the host.
    """

    #: fraction of the free device memory a launch's output may use: a row
    #: tile's sweep masks (a row block's mask is 8 words x 256 slots x 4
    #: bytes per column step: 9 MB per row block against a 1.4M-leader
    #: column corpus), or a bucketed similarity block (int32 per pair)
    MASK_MEMORY_FRACTION = 0.125
    #: the same budget on the CPU, where there is no memory query
    CPU_MASK_BUDGET_BYTES = 1 << 26
    #: column steps staged per host->device copy of the column corpus
    COL_FILL_STEPS = 64
    #: a slab's hit list holds this many records per row slot plus
    #: HITS_SLACK: every video hits itself once, and near copies are few
    HITS_PER_ROW = 4
    HITS_SLACK = 1 << 16

    def __init__(self, device: "str | torch.device | None" = None, mesh: Mesh | None = None):
        self.mesh = resolve_mesh(device, mesh)
        self.device = self.mesh.devices[0]
        self._progress_cb = None
        self._progress_done = 0
        self._progress_total = 0

    # -- the unpruned search: segment and bucketed routes ------------------

    def find_pairs(
        self,
        row_phashes: list[bytes],
        all_phashes: list[bytes],
        min_int_similarity: int,
        progress=None,
        col_state: dict | None = None,
        col_limit: int | None = None,
    ) -> list[tuple[int, int, int]]:
        """All (row_index, all_index, int_similarity) with similarity >=
        min_int_similarity (>= 1). Every row video is compared with every
        corpus video (its own slot included). Videos longer than
        MAX_BUCKET frames are compared exactly on the host.

        col_state: dict carrying the column-side index and device tiles
        across calls that sweep the same all_phashes. col_limit: report
        only hits whose corpus index is < col_limit; column tiles past it
        are skipped.

        Pairs of videos of at most SEG_MAX_FRAMES frames take the segment
        route (the column side is staged under ``col_state["seg_cols"]``
        once per sweep), every other bucket pair the bucketed route.
        """
        assert min_int_similarity >= 1, "minimum similarity must be >= 1"
        laps = _SegLaps()  # reads HVD_DEBUG_TIMING before the first span
        with span("find_pairs") as call:
            state = col_state if col_state is not None else {}
            with span("find_pairs.row_index"):
                rows = CorpusIndex(row_phashes)
                seg_rows = [
                    (int(i), row_phashes[int(i)])
                    for p, b in sorted(rows.buckets.items())
                    if p <= seg.SEG_MAX_FRAMES
                    for i in b.video_idx
                ]
            cols = state.get("cols_index")
            if cols is None:
                with span("find_pairs.col_index"):
                    cols = state["cols_index"] = CorpusIndex(all_phashes)
            total_pairs = 0
            for rb in rows.buckets.values():
                for cb in cols.buckets.values():
                    n_cols = len(cb.video_idx)
                    if col_limit is not None:
                        n_cols = int(np.searchsorted(cb.video_idx, col_limit))
                    total_pairs += len(rb.video_idx) * n_cols
            self._progress_done = 0
            self._progress_total = total_pairs
            self._progress_cb = progress
            out: list[tuple[int, int, int]] = []
            if seg_rows and any(p <= seg.SEG_MAX_FRAMES for p in cols.buckets):
                cols_dev = state.get("seg_cols")
                if cols_dev is None:
                    cols_dev = state["seg_cols"] = self._stage_columns(seg_columns(cols), laps)

                def launch(cols, a_words, slot_a, counts_a, valid, hits):
                    words, slots, counts = cols
                    return seg.similarity_segments(
                        a_words, slot_a, counts_a, words, slots, counts, valid,
                        min_int_similarity, hits,
                    )

                fallback: list[tuple[int, int]] = []
                hits = self._segment_route(seg_rows, cols_dev, col_limit, launch, laps, fallback)
                out.extend(_with_similarities(hits, row_phashes, all_phashes, fallback))
                # the JAX route finds each hit's similarity inside its drain
                laps.drain_split(call.child_seconds("seg.similarities"))
            col_arrays = state.setdefault("col_arrays", {})
            col_tiles = state.setdefault("col_tiles", {})
            for pa in rows.buckets:
                pbs = [
                    pb
                    for pb in cols.buckets
                    if not (pa <= seg.SEG_MAX_FRAMES and pb <= seg.SEG_MAX_FRAMES)
                ]
                if not pbs:
                    continue  # every column bucket is covered by the segment route
                r_idx, r_frames, r_counts = rows.bucket_arrays(pa)
                for pb in pbs:
                    if pb not in col_arrays:
                        col_arrays[pb] = cols.bucket_arrays(pb)
                    out.extend(
                        self._bucket_pair(
                            pa, r_idx, r_frames, r_counts, pb, *col_arrays[pb],
                            min_int_similarity, col_tiles, col_limit,
                        )
                    )
            out.extend(
                self._long_video_pairs(
                    rows, row_phashes, cols, all_phashes, min_int_similarity, col_limit
                )
            )
            return out

    def _bucket_pair(
        self, pa, r_idx, r_frames, r_counts, pb, c_idx, c_frames, c_counts, min_sim,
        col_tiles, col_limit,
    ):
        """Hits of one bucket pair: each row tile is one ``similarity_block``
        launch against the whole column bucket, with ``sim >= min_sim``
        found on the device. A bucket's columns are staged once per sweep,
        on every device of the mesh; under col_limit a launch takes only the
        columns below it (c_idx ascends). A row tile holds as many videos as
        the int32 block's memory budget allows on each member, times the
        mesh size; it splits into one slab per member, and every slab is
        launched before any is gathered. The kernel takes runtime sizes, so
        the last tile splits at its real size."""
        with span("bucket.pair"):
            n_live = len(c_idx)
            if col_limit is not None:
                n_live = int(np.searchsorted(c_idx, col_limit))
            if n_live == 0:
                return []
            staged = col_tiles.get(pb)
            if staged is None:
                # device columns depend only on pb: staged once per sweep
                staged = col_tiles[pb] = (
                    replicate(ops_sim.to_words(c_frames, self.device), self.mesh),
                    replicate(torch.from_numpy(c_counts).to(self.device), self.mesh),
                )
            n = self.mesh.size
            per_member = max(1, min(-(-len(r_idx) // n), self._output_budget() // (4 * n_live)))
            tr = per_member * n
            out = []
            for i0 in range(0, len(r_idx), tr):
                n_rows = min(tr, len(r_idx) - i0)
                sims = []
                for k, (s0, s1) in enumerate(row_slabs(n_rows, self.mesh)):
                    if s0 == s1:
                        continue
                    dev = self.mesh.devices[k]
                    with self.mesh.member(k):
                        rf = ops_sim.to_words(r_frames[i0 + s0 : i0 + s1], dev)
                        rc = torch.from_numpy(r_counts[i0 + s0 : i0 + s1]).to(dev)
                        sim = sb.similarity_block(
                            rf, rc, staged[0][dev][:n_live], staged[1][dev][:n_live], pa, pb
                        )
                    sims.append((k, i0 + s0, sim))
                for k, r0, sim in sims:
                    with self.mesh.member(k):
                        hits = torch.nonzero(sim >= min_sim).cpu().numpy()
                        if len(hits):
                            vals = sim[hits[:, 0], hits[:, 1]].cpu().numpy()
                            out.extend(
                                zip(
                                    r_idx[r0 + hits[:, 0]].tolist(),
                                    c_idx[hits[:, 1]].tolist(),
                                    vals.tolist(),
                                )
                            )
                if self._progress_cb is not None:
                    self._progress_done += n_rows * n_live
                    self._progress_cb(self._progress_done, self._progress_total)
            return out

    def _long_video_pairs(self, rows, row_phashes, cols, all_phashes, min_sim, col_limit=None):
        """Exact host-side comparison for videos too long to bucket: (long
        row x every col) and (every row x long col), the (long x long)
        block once. Threads run native matchHashBytes, which releases the
        GIL. Under col_limit, columns at or past it are excluded."""
        out: list[tuple[int, int, int]] = []
        long_cols = [(j, blob) for j, blob in cols.long if col_limit is None or j < col_limit]
        if not rows.long and not long_cols:
            return out
        with span("long.host"):
            long_row_set = {i for i, _ in rows.long}
            nonempty_cols = [
                (j, blob)
                for j, blob in enumerate(all_phashes)
                if len(blob) > 0 and (col_limit is None or j < col_limit)
            ]
            short_rows = [
                (i, blob)
                for i, blob in enumerate(row_phashes)
                if len(blob) > 0 and i not in long_row_set
            ]
            # (index, blob, others, flipped): flipped jobs come from long corpus
            # columns and emit (row, col) with the long video as the column
            jobs = [(i, blob, nonempty_cols, False) for i, blob in rows.long]
            jobs += [(j, blob, short_rows, True) for j, blob in long_cols]
            if self._progress_cb is not None:
                self._progress_total += sum(len(j[2]) for j in jobs)

            def one(job):
                idx, blob, others, flipped = job
                hits = []
                for k, other in others:
                    sim = int(matchHashBytes(blob, other, TOL))
                    if sim >= min_sim:
                        hits.append((k, idx, sim) if flipped else (idx, k, sim))
                return hits

            with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
                for job, hits in zip(jobs, ex.map(one, jobs)):
                    out.extend(hits)
                    if self._progress_cb is not None:
                        self._progress_done += len(job[2])
                        self._progress_cb(self._progress_done, self._progress_total)
            return out

    # -- the pruned route (stage 4's main path) ----------------------------

    def find_pairs_pruned(
        self,
        row_phashes: list[bytes],
        all_phashes: list[bytes],
        min_int_similarity: int,
        progress=None,
        col_state: dict | None = None,
        col_limit: int | None = None,
        radius_cap: int | None = None,
        rows_at: int | None = None,
    ) -> list[tuple[int, int, int]]:
        """find_pairs with the exact scene-representative prune: identical
        result contract, device work (total leaders)^2 + (candidates x
        their frames^2) instead of (total frames)^2.

        Stage A sweeps every video's scene leaders (ops/reps.py, radius
        <= radius_cap) at the inflated tolerance TOL + 2*radius_cap: by the
        triangle inequality a video pair with no leader pair within it has
        similarity exactly 0. Stage B verifies the surviving candidates
        exactly. Videos longer than SEG_MAX_FRAMES take the complement
        sweeps through find_pairs, unpruned.

        ``rows_at``: when the rows are exactly
        ``all_phashes[rows_at : rows_at + len(row_phashes)]`` (stage 4's
        checkpointed triangle), the row leaders are looked up in the
        column rep cache instead of re-clustered, and verify reuses the
        in-memory row blobs for candidates inside that span.

        With ``HVD_DEBUG_TIMING`` set it prints the JAX package's
        ``[prune-timing]`` laps, in its order: col reps, row reps, stage-A
        sweep (the column staging included), verify-blob fetch, verify. No
        lap covers the complement sweeps after them.
        """
        assert min_int_similarity >= 1, "minimum similarity must be >= 1"
        laps = Laps("[prune-timing]")  # reads HVD_DEBUG_TIMING before the first span
        with span("find_pairs_pruned") as call:
            radius_cap = reps_mod.RADIUS_CAP if radius_cap is None else radius_cap
            state = col_state if col_state is not None else {}
            prune_state = state.setdefault("prune", {})

            row_counts = blob_frame_counts(row_phashes)
            col_counts = state.get("col_n_frames")
            if col_counts is None:
                col_counts = state["col_n_frames"] = blob_frame_counts(all_phashes)

            seg_row_idx = np.nonzero(
                (row_counts >= 1) & (row_counts <= seg.SEG_MAX_FRAMES)
            )[0]

            # The rep cache is valid only for the radius_cap it was built at: a
            # sweep at prune_tolerance(smaller cap) over reps clustered at a
            # larger cap breaks the triangle bound and silently drops pairs.
            rep_cols = prune_state.get("rep_cols")
            with span("prune.col_reps") as part:
                if rep_cols is None or prune_state.get("rep_cols_radius_cap") != radius_cap:
                    seg_col_idx = np.nonzero(
                        (col_counts >= 1) & (col_counts <= seg.SEG_MAX_FRAMES)
                    )[0]
                    # cluster in slabs so only one slab of column blobs is resident
                    col_reps: list[bytes] = []
                    slab = 1 << 18
                    for s0 in range(0, len(seg_col_idx), slab):
                        sl = seg_col_idx[s0 : s0 + slab]
                        col_reps.extend(
                            reps_mod.extract_reps(
                                [b for _, b in iter_blob_items(all_phashes, sl)], radius_cap
                            )
                        )
                    # stage A's work grows with the square of the leaders' share
                    count("prune.col_frames", int(col_counts[seg_col_idx].sum()))
                    count("prune.col_leaders", sum(map(len, col_reps)) // BYTES)
                    rep_cols = prune_state["rep_cols"] = list(zip(seg_col_idx.tolist(), col_reps))
                    prune_state["rep_cols_radius_cap"] = radius_cap
                    # the device staging and the lookup of the old reps are stale
                    prune_state.pop("seg_cols", None)
                    prune_state.pop("rep_lookup", None)
            laps("col reps", seconds=part.seconds)

            with span("prune.row_reps") as part:
                if rows_at is not None:
                    rep_lookup = prune_state.get("rep_lookup")
                    if rep_lookup is None:
                        rep_lookup = prune_state["rep_lookup"] = dict(rep_cols)
                    row_reps = [rep_lookup[rows_at + int(i)] for i in seg_row_idx]
                else:
                    row_reps = reps_mod.extract_reps(
                        [b for _, b in iter_blob_items(row_phashes, seg_row_idx)], radius_cap
                    )
                seg_rows = list(zip(seg_row_idx.tolist(), row_reps))
            laps("row reps", seconds=part.seconds)

            self._progress_done = 0
            self._progress_total = len(seg_rows) * len(rep_cols)
            self._progress_cb = progress
            candidates: list[tuple[int, int]] = []
            if seg_rows and rep_cols:
                seg_laps = _SegLaps()
                cols_dev = prune_state.get("seg_cols")
                if cols_dev is None:
                    cols_dev = prune_state["seg_cols"] = self._stage_columns(
                        seg_columns_from_pairs(rep_cols), seg_laps
                    )
                tolerance = reps_mod.prune_tolerance(radius_cap)

                def launch(cols, a_words, slot_a, _counts_a, valid, _hits):
                    words, slots, _counts = cols
                    return seg.exists_mask_sweep(a_words, slot_a, words, slots, valid, tolerance)

                candidates = self._segment_route(seg_rows, cols_dev, col_limit, launch, seg_laps)
                seg_laps.drain_split()
            count("prune.candidates", len(candidates))
            laps(
                "stage-A sweep ({} candidates)", len(candidates),
                seconds=call.child_seconds("seg.stage", "seg.route"),
            )

            # DB-backed columns: fetch every candidate's column blob in batched
            # IN() probes; candidates inside this chunk's own row span reuse the
            # in-memory row blobs (nearly all of them at corpus scale, since
            # every video's self-pair is a candidate)
            col_blobs_for_verify = all_phashes
            if hasattr(all_phashes, "iter_many") and candidates:
                with span("prune.verify_fetch") as part:
                    need = sorted({j for _, j in candidates})
                    local: dict[int, bytes] = {}
                    if rows_at is not None:
                        n_rows = len(row_phashes)
                        for j in need:
                            if rows_at <= j < rows_at + n_rows:
                                local[j] = row_phashes[j - rows_at]
                        need = [j for j in need if not (rows_at <= j < rows_at + n_rows)]
                    if need:
                        local.update(all_phashes.iter_many(need))
                    col_blobs_for_verify = local
                laps("verify-blob fetch ({} off-span)", len(need), seconds=part.seconds)
            out = pair_verify.verify_pairs(
                candidates, row_phashes, col_blobs_for_verify, min_int_similarity, self.device
            )
            laps("verify ({} hits)", len(out), seconds=call.child_seconds("verify"))

            # Complement sweeps (unpruned find_pairs with the segment-eligible
            # side emptied — empty blobs match nothing): long rows x every col,
            # then segment rows x long cols. No overlap, no double count.
            long_rows = set(np.nonzero(row_counts > seg.SEG_MAX_FRAMES)[0].tolist())
            long_cols = set(np.nonzero(col_counts > seg.SEG_MAX_FRAMES)[0].tolist())
            if long_rows:
                out.extend(
                    self.find_pairs(
                        _emptied(row_phashes, long_rows), all_phashes, min_int_similarity,
                        col_state=state.setdefault("prune_long_rows", {}),
                        col_limit=col_limit,
                    )
                )
            if long_cols:
                out.extend(
                    self.find_pairs(
                        _emptied(row_phashes, set(seg_row_idx.tolist())),
                        _emptied(all_phashes, long_cols), min_int_similarity,
                        col_state=state.setdefault("prune_long_cols", {}),
                        col_limit=col_limit,
                    )
                )
            return out

    def _stage_columns(self, seg_cols: SegColumns, laps: Laps | None = None) -> dict:
        """Pack the column corpus into CHUNK_FRAMES chunks (N_SPLIT per
        step) and copy it to the device, bit-packed, COL_FILL_STEPS steps
        at a time so host memory stays bounded. Returns the device words
        [n_steps*STEP_FRAMES, 8] int32, slot ids [n_steps*STEP_FRAMES]
        int32 (-1 padding) and per-slot frame counts ``counts``
        [n_steps*STEP_SLOTS] int32 (0 empty), those three again under
        ``on`` for every device of the mesh (``replicate``), and the host
        map from flat column slot to corpus index ``smaps``
        [n_steps*STEP_SLOTS] int64 (-1 empty).

        The span ``seg.stage`` holds ``seg.stage.pack``, the host pack with
        the copy of each full group of COL_FILL_STEPS steps, and
        ``seg.stage.copy``, the last group's copy, the slot counts' and
        ``replicate``. ``laps`` (the caller's ``[seg-timing]`` laps) gets
        ``col stream+fill``, the span's seconds; only with
        ``HVD_DEBUG_TIMING`` set does it then wait for the copies (every
        CUDA device of the mesh) and lap ``col staging synced (debug)``."""
        laps = Laps("[seg-timing]") if laps is None else laps
        with span("seg.stage") as stage:
            columns = self._pack_columns(seg_cols)
        laps("col stream+fill", seconds=stage.seconds)
        if laps.on:
            for dev in self.mesh.distinct_devices:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            laps("col staging synced (debug)")
        return columns

    def _pack_columns(self, seg_cols: SegColumns) -> dict:
        """_stage_columns' work, inside its span."""
        counts = seg_cols.counts
        chunk_id, slot_id, _frame_off, n_chunks = seg.plan_chunks(
            counts, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
        )
        n_steps = max(1, -(-n_chunks // seg.N_SPLIT))
        n_frames = n_steps * seg.STEP_FRAMES
        words = torch.zeros((n_frames, LANES), dtype=torch.int32, device=self.device)
        slots = torch.full((n_frames,), -1, dtype=torch.int32, device=self.device)
        smaps = np.full(n_steps * seg.STEP_SLOTS, -1, dtype=np.int64)
        smaps[chunk_id * seg.CHUNK_SLOTS + slot_id] = seg_cols.indices
        slot_counts = np.zeros(n_steps * seg.STEP_SLOTS, dtype=np.int32)
        slot_counts[chunk_id * seg.CHUNK_SLOTS + slot_id] = counts

        grp = self.COL_FILL_STEPS * seg.STEP_FRAMES
        buf_w = np.zeros((grp, LANES), dtype=np.uint32)
        buf_s = np.full(grp, -1, dtype=np.int32)
        g0 = 0  # first frame of the group being filled

        def flush():
            n = min(grp, n_frames - g0)
            words[g0 : g0 + n].copy_(torch.from_numpy(buf_w[:n].view(np.int32)))
            slots[g0 : g0 + n].copy_(torch.from_numpy(buf_s[:n]))
            buf_w[:] = 0
            buf_s[:] = -1

        # a chunk's videos are contiguous from its first frame, so each
        # chunk packs with one blobs_to_packed over its joined bytes
        with span("seg.stage.pack"):
            items = enumerate(seg_cols.iter_items())
            for c, group in itertools.groupby(items, key=lambda kv: int(chunk_id[kv[0]])):
                group = list(group)
                ks = slice(group[0][0], group[-1][0] + 1)
                f0 = c * seg.CHUNK_FRAMES
                if f0 >= g0 + grp:
                    flush()
                    g0 = f0 - f0 % grp
                n = int(counts[ks].sum())
                buf_w[f0 - g0 : f0 - g0 + n] = ops_sim.blobs_to_packed(
                    b"".join(blob for _, (_j, blob) in group)
                )
                buf_s[f0 - g0 : f0 - g0 + n] = np.repeat(slot_id[ks], counts[ks])
        with span("seg.stage.copy"):
            flush()
            slot_counts = torch.from_numpy(slot_counts).to(self.device)
            copies = [replicate(t, self.mesh) for t in (words, slots, slot_counts)]
        return {
            "words": words,
            "slots": slots,
            "counts": slot_counts,
            # the three column tensors on every device of the mesh
            "on": {dev: tuple(c[dev] for c in copies) for dev in self.mesh.distinct_devices},
            "smaps": smaps,
            "n_steps": n_steps,
        }

    def _output_budget(self) -> int:
        """Bytes a launch's output may take on one member: the smallest
        over the mesh's devices of a device's budget divided among the
        members that share it."""
        budgets = []
        for dev in self.mesh.distinct_devices:
            budget = self.CPU_MASK_BUDGET_BYTES
            if dev.type == "cuda":
                free, _total = torch.cuda.mem_get_info(dev)
                budget = int(free * self.MASK_MEMORY_FRACTION)
            budgets.append(budget // self.mesh.sharing(dev))
        return min(budgets)

    def _row_blocks_per_tile(self, n_row_blocks: int, n_steps: int) -> int:
        """Row blocks per sweep launch on one member, from the memory its
        masks take."""
        mask_bytes = seg.MASK_WORDS * n_steps * seg.STEP_SLOTS * 4
        return max(1, min(n_row_blocks, 65535, self._output_budget() // mask_bytes))

    def _hit_capacity(self, live_rows: int) -> int:
        """Records of the hit list of a slab of up to ``live_rows`` row videos."""
        return self.HITS_PER_ROW * live_rows + self.HITS_SLACK

    def _segment_route(
        self, seg_rows, cols_dev, col_limit, launch, laps: _SegLaps, fallback: list | None = None
    ):
        """Hit (row, col) corpus pairs of seg_rows against staged columns.

        Each row tile's blocks round up to a multiple of the mesh size
        (padding blocks hold only slot id -1, which never matches) and
        split into one slab per member; each slab is one ``launch(cols,
        a_words, slot_a, counts_a, valid, hits)`` of a mask kernel on its
        member against the whole column corpus on that member's device (the
        sweep for stage A, the similarity kernel for the unpruned search);
        per-step validity skips steps holding no column below col_limit.
        The next tile is launched on every member before the previous one
        drains, so the devices work while the host decodes. Every launch
        is drained (a host wait on its stream) before the route returns.

        ``fallback`` None (stage A): ``hits`` is None and the route returns
        (row, col) pairs. A list (the unpruned search): each slab's launch
        gets a hit list (``seg.hit_list``) of ``_hit_capacity`` records for
        the row slots of a full slab, one of two lists per member that
        alternate between tiles, and the route returns (row, col, similarity) triples, but
        for the hits of a slab whose list overflowed: those are (row, col)
        pairs, decoded from its mask, at ``out[a:b]`` for each (a, b) the
        route appends to ``fallback`` (``_with_similarities`` scores them).

        The route is the span ``seg.route`` (kept as ``laps.route``), with
        the children ``seg.row_pack`` (the row blocks' pack, then each
        tile's stack), ``seg.dispatch`` (each tile's copies to the devices
        and launches), and ``seg.drain.fetch`` and ``seg.drain.decode``
        (``_drain``), and the count ``seg.tiles``. ``laps`` (the caller's
        ``[seg-timing]`` laps) gets ``row pack`` and ``row tile k
        dispatched`` for the first 8 tiles; the caller laps ``row tiles +
        drain`` and prints the drain's split (``_SegLaps.drain_split``) once
        its work on the hits is done. ``_drain`` adds the counts
        ``seg.device_sims`` and ``seg.sims_overflow`` with hit lists.
        """
        with span("seg.route") as laps.route:
            smaps = cols_dev["smaps"]
            n_steps = cols_dev["n_steps"]
            live = smaps.reshape(n_steps, seg.STEP_SLOTS) >= 0
            if col_limit is not None:
                live &= smaps.reshape(n_steps, seg.STEP_SLOTS) < col_limit
            total_cols = int(live.sum())
            valid = replicate(
                torch.from_numpy(live.any(axis=1).astype(np.int32)).to(self.device), self.mesh
            )

            with span("seg.row_pack") as part:
                row_blocks = seg.pack_blocks(seg_rows, seg.ROW_FRAMES, seg.ROW_SLOTS)
            laps.part("row pack", part)
            n = self.mesh.size
            per_tile = n * self._row_blocks_per_tile(-(-len(row_blocks) // n), n_steps)
            hit_lists: dict = {}  # (member, tile parity) -> its hit list
            list_capacity = self._hit_capacity(per_tile // n * seg.ROW_SLOTS)
            out: list = []
            pending = None
            for i0 in range(0, len(row_blocks), per_tile):
                group = row_blocks[i0 : i0 + per_tile]
                n_blocks = -(-len(group) // n) * n
                with span("seg.row_pack"):
                    packed, slot_ids, cnt, rmap = seg.stack_blocks(
                        group, n_blocks, seg.ROW_FRAMES, seg.ROW_SLOTS
                    )
                cnt = cnt.reshape(-1)
                slabs = []
                with span("seg.dispatch") as part:
                    for k, (b0, b1) in enumerate(row_slabs(n_blocks, self.mesh)):
                        dev = self.mesh.devices[k]
                        fs = slice(b0 * seg.ROW_FRAMES, b1 * seg.ROW_FRAMES)
                        ss = slice(b0 * seg.ROW_SLOTS, b1 * seg.ROW_SLOTS)
                        with self.mesh.member(k):
                            hits = None
                            if fallback is not None:
                                key = (k, i0 // per_tile % 2)
                                if key not in hit_lists:
                                    hit_lists[key] = seg.hit_list(list_capacity, dev)
                                hits = hit_lists[key]
                            masks = launch(
                                cols_dev["on"][dev],
                                ops_sim.to_words(packed[fs], dev),
                                torch.from_numpy(slot_ids[fs]).to(dev),
                                torch.from_numpy(cnt[ss]).to(dev),
                                valid[dev],
                                hits,
                            )
                        slabs.append((k, rmap[ss], masks, hits))
                if i0 < 8 * per_tile:
                    laps.part("row tile {} dispatched", part, i0 // per_tile)
                if pending is not None:
                    self._drain(pending, smaps, col_limit, total_cols, out, fallback)
                pending = slabs
            if pending is not None:
                self._drain(pending, smaps, col_limit, total_cols, out, fallback)
            return out

    def _drain(self, slabs, smaps, col_limit, total_cols, out, fallback):
        """Hits from one tile, slab by slab, a slab's row r mapped through
        its slice of the tile's rmap and column c through smaps, columns at
        or past col_limit dropped, in the order of the mask's set bits
        (word row, column, bit). A slab with a hit list that held every
        hit: its count and records copied from the slab's member
        (``seg.drain.fetch``, the records sorted there), then (row, col,
        similarity) triples (``seg.drain.decode``). Any other slab: nonzero
        mask words found on its member (``seg.drain.fetch``), their bits
        decoded on the host into (row, col) pairs (``seg.drain.decode``),
        whose range of ``out`` goes to ``fallback`` where the slab had a
        list. Counts the tile in ``seg.tiles`` and, with hit lists, its
        listed hits in ``seg.device_sims`` and its overflowed slabs in
        ``seg.sims_overflow``."""
        n_rows = n_sims = n_overflow = 0
        for k, rmap, masks, hits in slabs:
            with self.mesh.member(k):
                with span("seg.drain.fetch"):
                    records = None
                    if hits is not None:
                        found = int(seg.hit_count(hits))
                        if found <= hits.shape[0] - 1:
                            records = hits[1 : 1 + found].to(torch.int64)
                            rows_l, cols_l = records[:, 0], records[:, 1]
                            # the mask's order: word row, column, bit
                            key = ((rows_l >> 5) * masks.shape[1] + cols_l) * 32 + (rows_l & 31)
                            records = records[torch.argsort(key)].cpu().numpy()
                        else:
                            n_overflow += 1
                    if records is None:
                        nz = torch.nonzero(masks)
                        if len(nz):
                            vals = masks[nz[:, 0], nz[:, 1]].cpu().numpy()
                            nz = nz.cpu().numpy()
                with span("seg.drain.decode"):
                    if records is not None:
                        rows_l, cols_l, sims = records.T
                    elif len(nz):
                        rows_l, cols_l = decode_mask_hits(nz[:, 0], nz[:, 1], vals)
                    else:
                        rows_l = cols_l = np.zeros(0, np.int64)
                    ia = rmap[rows_l]
                    ib = smaps[cols_l]
                    keep = (ia >= 0) & (ib >= 0)
                    if col_limit is not None:
                        keep &= ib < col_limit
                    a = len(out)
                    if records is not None:
                        out.extend(zip(ia[keep].tolist(), ib[keep].tolist(), sims[keep].tolist()))
                        n_sims += len(out) - a
                    else:
                        out.extend(zip(ia[keep].tolist(), ib[keep].tolist()))
                        if hits is not None and len(out) > a:
                            fallback.append((a, len(out)))
            n_rows += int((rmap >= 0).sum())
        count("seg.tiles")
        if fallback is not None:
            count("seg.device_sims", n_sims)
            count("seg.sims_overflow", n_overflow)
        if self._progress_cb is not None:
            self._progress_done += n_rows * total_cols
            self._progress_cb(self._progress_done, self._progress_total)
