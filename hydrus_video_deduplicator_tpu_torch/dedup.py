"""The 4-stage resumable dedupe orchestrator on a GPU.

Subclasses the JAX package's ``HydrusVideoDeduplicator`` and overrides only
the touch points that reach JAX: the device mesh, the stage-1 and stage-4
backend choice and the link probe behind it, the device hashing of stage 1
(``GpuVideoHasher``), the stage-4 prefilter decision, and the stage-4
search itself (``GpuSearchEngine``), each with the reference's failure,
checkpointing, marking and search-cache semantics unchanged.

The base class spells the device backend ``"tpu"``; the port's CLI spells
it ``"gpu"``. ``_INTERNAL_BACKEND`` maps one onto the other, in the
constructor only.
"""

from __future__ import annotations

import functools
import gc
import logging
import os
import sqlite3
import threading
import time
from concurrent.futures import ThreadPoolExecutor

try:
    from rich import print
except ImportError:  # pragma: no cover
    pass

import numpy as np
import torch
from tqdm import tqdm

from hydrus_video_deduplicator_tpu import dedup as base
from hydrus_video_deduplicator_tpu.db import DedupeDB, vptree
from hydrus_video_deduplicator_tpu.db.blobs import DbBlobColumn, fetch_blobs
from hydrus_video_deduplicator_tpu.ops import reps as reps_mod

from ._device import resolve_device
from .models.vpdq import GpuVideoHasher
from .ops import similarity_segments as seg
from .parallel.engine import GpuSearchEngine, blob_frame_counts, iter_blob_items

log = logging.getLogger("hvd")

#: the port's CLI spelling -> the base class's internal backend value
_INTERNAL_BACKEND = {"auto": "auto", "tree": "tree", "native": "native", "gpu": "tpu"}


class HydrusVideoDeduplicator(base.HydrusVideoDeduplicator):
    """The orchestrator with stage 4 on ``GpuSearchEngine``.

    search_backend: "auto" | "tree" | "gpu"; hash_backend: "auto" |
    "native" | "gpu"; device: the torch device of the hasher and the
    engine — None is CUDA, and both raise without it; tests pass "cpu".
    """

    def __init__(
        self,
        db: DedupeDB.DedupeDb,
        client,
        *args,
        search_backend: str = "auto",
        hash_backend: str = "auto",
        rerank: str = "none",
        device: "str | torch.device | None" = None,
        **kwargs,
    ):
        if search_backend not in ("auto", "tree", "gpu"):
            raise ValueError(f"unknown search backend: {search_backend!r}")
        if hash_backend not in ("auto", "native", "gpu"):
            raise ValueError(f"unknown hash backend: {hash_backend!r}")
        if rerank != "none":
            raise NotImplementedError(
                "--rerank clip needs the vision tower, which is not ported yet"
                " (ROADMAP Queue 1 item 12)"
            )
        super().__init__(
            db,
            client,
            *args,
            search_backend=_INTERNAL_BACKEND[search_backend],
            hash_backend=_INTERNAL_BACKEND[hash_backend],
            **kwargs,
        )
        self.device = device

    @staticmethod
    def _device_mesh():
        """One device: the multi-GPU engine is not ported yet."""
        return None

    @staticmethod
    @functools.lru_cache(maxsize=1)
    def _device_link_mbps(device: torch.device) -> float:
        """One-shot measured H2D bandwidth (MB/s) to a CUDA device: a 4 MB
        copy from pinned memory, timed after a warm-up copy."""
        src = torch.zeros(4 << 20, dtype=torch.uint8).pin_memory()
        dst = torch.empty_like(src, device=device)
        dst[: 1 << 10].copy_(src[: 1 << 10])  # warm: context, allocator
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        return (src.numel() / 1e6) / max(dt, 1e-9)

    def _pick_hash_backend(self, num_files: int) -> str:
        """Resolve the stage-1 backend to the base's internal value.

        "gpu" ("tpu" inside) needs CUDA, or an explicit device: without one
        it raises. "auto" takes the device only when a CUDA device is there
        (or a non-CPU device was named), at least TPU_HASH_MIN_BATCH files
        need hashing, and the measured link carries TPU_HASH_MIN_LINK_MBPS
        within HASH_PROBE_TIMEOUT_S (the probe runs in a daemon thread, as
        the base's does); otherwise the native C++ hasher."""
        if self.hash_backend == "tpu":
            resolve_device(self.device)
            return "tpu"
        if self.hash_backend == "native":
            return "native"
        if self.device is not None:
            has_device = torch.device(self.device).type != "cpu"
        else:
            has_device = torch.cuda.is_available()
        if not has_device or num_files < self.TPU_HASH_MIN_BATCH:
            return "native"
        result: dict = {}

        def probe() -> None:
            try:
                result["mbps"] = self._device_link_mbps(resolve_device(self.device))
            except RuntimeError:
                log.exception("hash backend auto: device probe failed")

        th = threading.Thread(target=probe, daemon=True)
        th.start()
        th.join(self.HASH_PROBE_TIMEOUT_S)
        if "mbps" not in result:
            log.info("hash backend auto: no device link measured in %.0fs -> native",
                     self.HASH_PROBE_TIMEOUT_S)
            return "native"
        mbps = result["mbps"]
        backend = "tpu" if mbps >= self.TPU_HASH_MIN_LINK_MBPS else "native"
        log.info("hash backend auto: link %.0f MB/s -> %s", mbps, backend)
        return backend

    def _add_perceptual_hashes_to_db_tpu(self, video_hashes) -> base.PerceptualHashingStats:
        """Device-batched hashing: fetch a chunk of files (the next chunk is
        fetched meanwhile), decode in a thread pool, hash all their frames
        in shared device batches on ``self.device``, then commit. Per-file
        API failures are isolated, chunk sizes adapt to the frames and
        bytes seen so far, CTRL+C checkpoints at chunk boundaries — the
        base's semantics, with ``GpuVideoHasher`` in place of the TPU
        hasher."""
        stats = base.PerceptualHashingStats()
        hasher = GpuVideoHasher(
            decode_workers=self.job_count, sampling=self.sampling, device=self.device
        )

        def fetch_chunk(chunk) -> list[tuple[str, bytes]]:
            """Per-file API failure isolation (FileHasher semantics)."""
            fetched: list[tuple[str, bytes]] = []
            for file_hash in chunk:
                try:
                    response = self.client.client.get_file(hash_=file_hash)
                    fetched.append((file_hash, response.content))
                except base.hydrus_api.HydrusAPIException as exc:
                    stats.failed_from_api_errors_count += 1
                    print("[red] Hydrus API error during perceptual hashing:")
                    print(f"{exc}")
                    time.sleep(base.FileHasher.API_ERROR_BACKOFF_SECONDS)
            return fetched

        # adaptive chunk sizing state: cumulative means over hashed files
        n_seen_frames = [0, 0]  # [files, frames]
        n_seen_bytes = [0, 0]  # [files, bytes]
        target_frames = 2 * hasher.batch_size

        def next_chunk_size() -> int:
            if n_seen_frames[0] == 0:
                return self.TPU_HASH_CHUNK
            mean_frames = max(1.0, n_seen_frames[1] / n_seen_frames[0])
            size = int(target_frames / mean_frames)
            if n_seen_bytes[0]:
                mean_bytes = max(1.0, n_seen_bytes[1] / n_seen_bytes[0])
                size = min(size, int(self.TPU_HASH_FETCH_RAM_CAP / mean_bytes))
            return max(self.TPU_HASH_CHUNK, min(size, self.TPU_HASH_CHUNK_MAX))

        def progress_update(pbar) -> None:
            if self.update_progress_callback:
                self.update_progress_callback(
                    base.HashingProgress(complete=pbar.n, total=pbar.total)
                )

        try:
            with tqdm(
                total=len(video_hashes),
                desc="Perceptually hashing files (GPU)",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar, ThreadPoolExecutor(max_workers=1) as prefetcher:
                pos = 0

                def submit_next():
                    nonlocal pos
                    if pos >= len(video_hashes):
                        return None, 0
                    chunk = video_hashes[pos : pos + next_chunk_size()]
                    pos += len(chunk)
                    return prefetcher.submit(fetch_chunk, chunk), len(chunk)

                future, chunk_len = submit_next()
                while future is not None:
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return stats
                    progress_update(pbar)
                    fetched = future.result()
                    n_seen_bytes[0] += len(fetched)
                    n_seen_bytes[1] += sum(len(b) for _, b in fetched)
                    future_next, next_len = submit_next()
                    for result in hasher.hash_videos(fetched):
                        if result.error is not None:
                            stats.failed_from_phash_count += 1
                            print("[red] Failed to perceptually hash a file.")
                            print(f"Failed file SHA256 hash: {result.key}")
                            print(f"{result.error}")
                            if self.page_logger:
                                self.page_logger.add_failed_video(result.key)
                        else:
                            self.db.add_to_phashed_files_queue(result.key, result.phash.bytes)
                            stats.success_hash_count += 1
                            n_seen_frames[0] += 1
                            n_seen_frames[1] += result.n_frames
                    self.db.commit()
                    gc.collect()
                    pbar.update(chunk_len)
                    progress_update(pbar)
                    future, chunk_len = future_next, next_len
        except KeyboardInterrupt:
            raise base.CancelledPerceptualHashException(stats)
        return stats

    def _pick_search_backend(self, num_files: int) -> str:
        # degenerate thresholds (similarity < 1 => distance 101, "everything
        # matches") only have exact reference semantics on the tree path
        if vptree.fix_vpdq_similarity(self.threshold) > 100:
            return "tree"
        if self.search_backend in ("tree", "tpu"):
            return self.search_backend
        has_device = self.device is not None or torch.cuda.is_available()
        return "tpu" if has_device and num_files >= self.TPU_ENGINE_MIN_BATCH else "tree"

    def _pick_search_prefilter(self, all_phashes, col_state: dict) -> bool:
        """Decide once per sweep whether stage 4 uses the exact
        scene-representative prune, and when it does, seed col_state with
        the column-side reps. "auto" prunes only if the reps are at most
        PREFILTER_MAX_REP_FRACTION of the frames."""
        if self.search_prefilter == "none":
            return False
        counts = blob_frame_counts(all_phashes)
        eligible_idx = np.nonzero((counts > 0) & (counts <= seg.SEG_MAX_FRAMES))[0]
        # cluster in slabs so only one slab of blobs is resident at a time
        rep_blobs: list[bytes] = []
        slab = 1 << 18
        for s0 in range(0, len(eligible_idx), slab):
            sl = eligible_idx[s0 : s0 + slab]
            rep_blobs.extend(
                reps_mod.extract_reps([b for _, b in iter_blob_items(all_phashes, sl)])
            )
        rep_cols = list(zip(eligible_idx.tolist(), rep_blobs))
        if self.search_prefilter != "reps":  # auto
            total_frames = int(counts[eligible_idx].sum())
            total_reps = sum(len(rb) // 32 for rb in rep_blobs)
            if total_reps > self.PREFILTER_MAX_REP_FRACTION * total_frames:
                log.info(
                    "prefilter auto: reps %d / frames %d — compression too weak, "
                    "using the plain sweep",
                    total_reps,
                    total_frames,
                )
                return False
        prune_state = col_state.setdefault("prune", {})
        prune_state["rep_cols"] = rep_cols
        # stamp the cap the seeded reps were clustered at, or the engine's
        # cache-validity check discards them and re-clusters
        prune_state["rep_cols_radius_cap"] = reps_mod.RADIUS_CAP
        return True

    def _find_potential_duplicates_tpu(self, files: list[int], search_threshold: int) -> int:
        """Exact all-pairs search on the device with the reference's cache
        and count semantics: each unsearched file is compared against the
        whole corpus; directional double-counts are halved like the
        reference."""
        if not files:
            return 0
        if self.should_skip_step_fn and self.should_skip_step_fn():
            return 0
        # distance <= t  <=>  int sim >= 101 - t; clamped to >= 1
        min_sim = max(1, 101 - search_threshold)

        # corpus: every mapped file and its phash, already-searched files
        # FIRST and the unsearched row files after them in chunk order, so
        # each chunk's comparison set is a corpus PREFIX and the engine
        # sweeps the triangle. Only (hash_id, LENGTH) metadata is fetched up
        # front; blob bytes stream from SQLite through DbBlobColumn.
        meta = np.fromiter(
            self.db.execute(
                "SELECT m.hash_id, LENGTH(p.phash)"
                " FROM shape_perceptual_hash_map m"
                " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
            ),
            dtype=np.dtype([("id", np.int64), ("len", np.int64)]),
        )
        files_arr = np.asarray(files, dtype=np.int64)
        in_rows = np.isin(meta["id"], files_arr)
        searched_ids = meta["id"][~in_rows]  # corpus iteration order
        searched_lens = meta["len"][~in_rows]
        # row files in `files` order, restricted to mapped hashes
        order = np.argsort(meta["id"], kind="stable")
        sorted_ids = meta["id"][order]
        pos = np.searchsorted(sorted_ids, files_arr)
        pos_c = np.minimum(pos, max(len(sorted_ids) - 1, 0))
        present = (
            (pos < len(sorted_ids)) & (sorted_ids[pos_c] == files_arr)
            if len(sorted_ids)
            else np.zeros(len(files_arr), dtype=bool)
        )
        row_ids = files_arr[present]
        row_lens = meta["len"][order][pos_c[present]]
        n_searched = len(searched_ids)
        all_ids = np.concatenate([searched_ids, row_ids])
        all_phashes = DbBlobColumn(
            self.db,
            all_ids,
            np.concatenate([searched_lens, row_lens]) // 32,
        )

        if self.update_progress_callback:
            self.update_progress_callback(
                base.SearchingForDuplicatesProgress(complete=0, total=len(row_ids))
            )
        engine = GpuSearchEngine(device=self.device)

        # Checkpointed sweep: after each chunk its pairs are marked in Hydrus
        # and its search-cache entries committed, so an interrupt loses at
        # most one chunk. Column-side device state is shared across chunks
        # via col_state, so the corpus uploads once.
        MARK_BATCH = 256
        num_similar_pairs = 0
        marked: set[tuple[int, int]] = set()
        rejected: set[tuple[int, int]] = set()
        pending: list[dict] = []
        col_state: dict = {}
        row_id_set = set(row_ids.tolist())

        def post_pending():
            if pending:
                self.client.client.set_file_relationships(pending)
                pending.clear()

        def mark_hits(hits, chunk_row_ids, chunk_rows_start_pos) -> bool:
            """POST one chunk's hits; False if the user skipped mid-way.

            Counting weights reproduce the reference's accounting under the
            triangle sweep: a hit against an already-searched file is one
            event; a hit against an earlier chunk's row stands for the two
            directional events the square sweep would have produced; a
            within-chunk hit arrives in both directions, one event each.
            """
            nonlocal num_similar_pairs
            with tqdm(
                dynamic_ncols=True,
                total=len(hits),
                desc="Marking potential duplicates",
                unit="pair",
                colour="BLUE",
            ) as pbar:
                for r, c, _sim in hits:
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        # leave this chunk's search cache unmarked so the
                        # next run redoes the remaining marking work
                        post_pending()
                        return False
                    hash_a = chunk_row_ids[r]
                    hash_b = int(all_ids[c])
                    if hash_a == hash_b:
                        pbar.update(1)
                        continue
                    key = (min(hash_a, hash_b), max(hash_a, hash_b))
                    if key in rejected:
                        pbar.update(1)
                        continue
                    if key not in marked:
                        fh_a = self.db.get_file_hash(hash_a)
                        fh_b = self.db.get_file_hash(hash_b)
                        if not self._pair_passes_rerank(fh_a, fh_b):
                            rejected.add(key)  # neither direction is counted
                            pbar.update(1)
                            continue
                        marked.add(key)
                        pending.append(self._relationship_payload(fh_a, fh_b))
                        if len(pending) >= MARK_BATCH:
                            post_pending()
                    num_similar_pairs += 2 if n_searched <= c < chunk_rows_start_pos else 1
                    pbar.update(1)
            post_pending()
            return True

        use_prune = self._pick_search_prefilter(all_phashes, col_state)
        log.info(
            "stage-4 prefilter: %s", "scene-representative prune" if use_prune else "none"
        )

        rows_done = 0
        max_chunks = int(os.environ.get("HVD_SEARCH_MAX_CHUNKS", "0")) or self.SEARCH_MAX_CHUNKS
        chunk_rows = max(self.SEARCH_CHECKPOINT_ROWS, -(-len(files) // max_chunks))

        # one-chunk-ahead prefetch: the next chunk's row blobs are read from
        # SQLite on a second connection while the current chunk sweeps;
        # stage 4 writes only at the chunk checkpoint, after the read ended
        db_path = str(self.db.db_dir / self.db.db_name)
        chunk_starts = list(range(0, len(files), chunk_rows))
        prefetched: dict[int, tuple] = {}

        def prefetch_worker(ids: list[int], out: list) -> None:
            conn = sqlite3.connect(db_path)
            try:
                conn.execute("PRAGMA busy_timeout=30000")
                out.append(fetch_blobs(conn, ids))
            except sqlite3.Error:  # the main thread fetches instead
                log.exception("row prefetch failed")
            finally:
                conn.close()

        def start_prefetch(idx: int) -> None:
            if idx >= len(chunk_starts):
                return
            k0 = chunk_starts[idx]
            ids = [h for h in files[k0 : k0 + chunk_rows] if h in row_id_set]
            out: list = []
            th = threading.Thread(target=prefetch_worker, args=(ids, out), daemon=True)
            th.start()
            prefetched[idx] = (th, out, ids)

        start_prefetch(0)
        with tqdm(
            total=100,
            desc="Searching for duplicates (all-pairs engine)",
            dynamic_ncols=True,
            unit="%",
            colour="BLUE",
        ) as search_bar:
            for ci, k0 in enumerate(chunk_starts):
                chunk_files = files[k0 : k0 + chunk_rows]
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return num_similar_pairs // 2
                th, out, chunk_row_ids = prefetched.pop(ci)
                start_prefetch(ci + 1)
                th.join()
                chunk_phashes = out[0] if out else fetch_blobs(self.db, chunk_row_ids)
                # triangle sweep: this chunk compares against the corpus
                # prefix ending at its own last row
                chunk_rows_start_pos = n_searched + rows_done
                col_limit = chunk_rows_start_pos + len(chunk_row_ids)

                def on_progress(done: int, total: int) -> None:
                    frac = done / total if total else 1.0
                    n_done = rows_done + int(len(chunk_row_ids) * min(frac, 1.0))
                    pct = int(100 * n_done / len(row_ids)) if len(row_ids) else 100
                    search_bar.n = min(pct, 100)
                    search_bar.refresh()
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            base.SearchingForDuplicatesProgress(
                                complete=n_done, total=len(row_ids)
                            )
                        )

                search_fn = engine.find_pairs_pruned if use_prune else engine.find_pairs
                # rows are the corpus suffix at this chunk's position: the
                # engine reuses its column rep cache for the row side
                extra = {"rows_at": chunk_rows_start_pos} if use_prune else {}
                hits = (
                    search_fn(
                        chunk_phashes,
                        all_phashes,
                        min_sim,
                        progress=on_progress,
                        col_state=col_state,
                        col_limit=col_limit,
                        **extra,
                    )
                    if chunk_phashes
                    else []
                )
                if not mark_hits(hits, chunk_row_ids, chunk_rows_start_pos):
                    return num_similar_pairs // 2
                # the chunk is the checkpoint unit: its cache entries land
                # atomically in one statement and one commit
                self.db.conn.executemany(
                    "UPDATE shape_search_cache SET searched_distance = ? WHERE hash_id = ?",
                    [(search_threshold, h) for h in chunk_files],
                )
                self.db.commit()
                rows_done += len(chunk_row_ids)
                search_bar.n = int(100 * rows_done / len(row_ids)) if len(row_ids) else 100
                search_bar.refresh()
            search_bar.n = 100
            search_bar.refresh()
        if self.update_progress_callback:
            self.update_progress_callback(
                base.SearchingForDuplicatesProgress(complete=len(row_ids), total=len(row_ids))
            )
        return num_similar_pairs // 2

