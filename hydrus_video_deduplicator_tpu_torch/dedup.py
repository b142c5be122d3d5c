"""The 4-stage resumable dedupe orchestrator on a GPU (counterpart of the
JAX package's ``dedup.py``, with the same failure, checkpointing, marking
and search-cache semantics).

Stages (each independently interruptible; progress persists in SQLite):
  1. hash videos           -> phashed_file_queue         (commit every 4)
  2. drain queue           -> tables + VP-tree insert    (commit every 64)
  3. tree maintenance      -> branch rebuilds if due
  4. search for duplicates -> mark pairs in Hydrus       (commit every 64)

Stage 1 has two hashers: the threaded native C++ hasher ("native") and the
device-batched ``GpuVideoHasher`` ("gpu"). Stage 4 has two engines with
identical observable semantics:
  - "tree": the reference's VP-tree descent (per-file, incremental)
  - "gpu":  the exact all-pairs ``GpuSearchEngine`` (parallel/engine.py),
            the default when a batch of files needs searching.
Both honor the shape_search_cache contract, so runs are incremental and the
two engines can be mixed across runs, and with the JAX package's on the
same database.
"""

from __future__ import annotations

import builtins
import functools
import gc
import logging
import os
import sqlite3
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import TYPE_CHECKING

try:
    from rich import print
except ImportError:  # pragma: no cover
    pass

import numpy as np
import torch
from tqdm import tqdm

from ._device import resolve_device
from .client import HVDClient, hydrus_api
from .db import DedupeDB, vptree
from .db.blobs import DbBlobColumn, fetch_blobs
from .hashing import compute_phash
from .models.vpdq import GpuVideoHasher
from .page_logger import HydrusPageLogger
from .parallel import mesh as mesh_mod
from .parallel.engine import GpuSearchEngine
from .utils.profiling import count, debug_timing, span

if TYPE_CHECKING:
    from collections.abc import Callable, Sequence
    from typing import TypeAlias

    FileHash = str

log = logging.getLogger("hvd")

# ---------------------------------------------------------------------------
# results / failures / progress
# ---------------------------------------------------------------------------


@dataclass
class PerceptuallyHashedFile:
    file_hash: "FileHash"
    perceptual_hash: bytes


@dataclass
class FailedPerceptuallyHashedFile:
    file_hash: "FileHash"
    exc: Exception


class HydrusApiException(Exception):
    """Wrapper that decouples FileHasher callers from the API library."""


class FailedPerceptualHashException(Exception):
    def __init__(self, file_hash: "FileHash", other_exc: str = ""):
        super().__init__()
        self.file_hash = file_hash
        self.other_exc = other_exc


@dataclass
class PerceptualHashingStats:
    success_hash_count: int = 0
    failed_from_api_errors_count: int = 0
    failed_from_phash_count: int = 0


class CancelledPerceptualHashException(Exception):
    def __init__(self, stats: PerceptualHashingStats):
        super().__init__()
        self.stats = stats


@dataclass
class NoneProgress:
    placeholder: None = None


@dataclass
class HashingProgress:
    complete: int
    total: int


@dataclass
class BuildingSearchTreeProgress:
    complete: int
    total: int


@dataclass
class SearchingForDuplicatesProgress:
    complete: int
    total: int


@dataclass
class DoneProgress:
    placeholder: None = None


@dataclass
class DedupeProgress:
    progress: (
        NoneProgress
        | HashingProgress
        | BuildingSearchTreeProgress
        | SearchingForDuplicatesProgress
        | DoneProgress
    )


if TYPE_CHECKING:
    UpdateDedupeProgressCallback: TypeAlias = Callable[[DedupeProgress], None]


# ---------------------------------------------------------------------------
# FileHasher
# ---------------------------------------------------------------------------


class FileHasher:
    """Fetch a file from Hydrus and perceptually hash it, with typed
    failure results and a cool-down after API errors."""

    API_ERROR_BACKOFF_SECONDS = 3

    def __init__(self, client: HVDClient, num_threads: int = 0, sampling: str = "uniform"):
        self.client = client
        self.num_threads = num_threads
        self.sampling = sampling

    def _fetch_file(self, file_hash: str) -> bytes:
        try:
            response = self.client.client.get_file(hash_=file_hash)
        except hydrus_api.HydrusAPIException as exc:
            raise HydrusApiException(exc)
        return response.content

    def _phash_file(self, file: bytes) -> bytes:
        try:
            phash_bytes = compute_phash(file, self.num_threads, sampling=self.sampling).bytes
        except Exception as exc:
            raise FailedPerceptualHashException("", str(exc))
        # Empty hashes are legitimate (all frames below quality floor).
        if phash_bytes is None or len(phash_bytes) % 32 != 0:
            raise FailedPerceptualHashException("", "phash was None or not a multiple of 32 bytes.")
        return phash_bytes

    def fetch_and_phash_file(
        self, file_hash: str
    ) -> PerceptuallyHashedFile | FailedPerceptuallyHashedFile:
        try:
            file = self._fetch_file(file_hash)
        except HydrusApiException as exc:
            # brief cool-down so one transient API failure doesn't cascade
            time.sleep(self.API_ERROR_BACKOFF_SECONDS)
            return FailedPerceptuallyHashedFile(file_hash, exc)
        try:
            phash = self._phash_file(file)
        except FailedPerceptualHashException as exc:
            return FailedPerceptuallyHashedFile(file_hash, exc)
        return PerceptuallyHashedFile(file_hash, phash)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


class HydrusVideoDeduplicator:
    """The orchestrator with stage 1 on ``GpuVideoHasher`` and stage 4 on
    ``GpuSearchEngine``.

    search_backend: "auto" | "tree" | "gpu"; hash_backend: "auto" |
    "native" | "gpu"; device: the torch device of the hasher and the
    engine — None is CUDA, and both raise without it; tests pass "cpu".
    """

    hydlog = log
    threshold: float = 75.0
    _DEBUG = False

    HASH_COMMIT_BATCH = 4
    TREE_COMMIT_BATCH = 64
    #: queue rows per set-based stage-2 drain batch (deferred-descent
    #: route); each batch commits, so this is also the interrupt
    #: granularity of stage 2 on the gpu backend
    QUEUE_DRAIN_BATCH = 50_000
    SEARCH_COMMIT_BATCH = 64
    #: row files per checkpointed search chunk: after each chunk its pairs
    #: are marked and its search-cache entries committed, bounding the work
    #: an interrupt can lose while keeping device batches large. At corpus
    #: scale the chunk size grows so the total chunk count stays <=
    #: SEARCH_MAX_CHUNKS (each chunk has fixed costs: row packing and
    #: upload, the drain, SQLite row fetch). Override with
    #: HVD_SEARCH_MAX_CHUNKS for finer checkpoints.
    SEARCH_CHECKPOINT_ROWS = 8192
    SEARCH_MAX_CHUNKS = 16
    #: use the GPU engine when at least this many files need searching
    GPU_ENGINE_MIN_BATCH = 16

    def __init__(
        self,
        db: DedupeDB.DedupeDb,
        client: HVDClient,
        job_count: int = -2,
        failed_page_name: str | None = None,
        custom_query: "Sequence[str] | None" = None,
        update_progress_callback: "UpdateDedupeProgressCallback | None" = None,
        should_skip_step_fn: "Callable[[], bool] | None" = None,
        search_backend: str = "auto",
        search_prefilter: str = "auto",  # "auto" | "reps" | "none"
        hash_backend: str = "auto",
        sampling: str = "uniform",  # "uniform" (reference parity) | "scene"
        rerank: str = "none",  # "none" | "clip" (embedding gate, rerank.py)
        rerank_weights: str | None = None,
        rerank_threshold: float = 0.85,
        device: "str | torch.device | None" = None,
    ):
        if search_backend not in ("auto", "tree", "gpu"):
            raise ValueError(f"unknown search backend: {search_backend!r}")
        if hash_backend not in ("auto", "native", "gpu"):
            raise ValueError(f"unknown hash backend: {hash_backend!r}")
        if rerank not in ("none", "clip"):
            raise ValueError(f"unknown rerank mode: {rerank!r}")
        if rerank == "clip" and not rerank_weights:
            raise ValueError("--rerank clip requires --rerank-weights")
        self.db = db
        self.client = client
        self.job_count = job_count
        self.page_logger = (
            None if failed_page_name is None else HydrusPageLogger(client, failed_page_name)
        )
        self.search_tags = self.get_search_tags(custom_query)
        self.update_progress_callback = update_progress_callback
        if self.update_progress_callback:
            self.update_progress_callback(NoneProgress())
        self.should_skip_step_fn = should_skip_step_fn
        self.search_backend = search_backend
        self.search_prefilter = search_prefilter
        self.hash_backend = hash_backend
        self.sampling = sampling
        self.device = device
        self.reranker = None
        if rerank == "clip":
            from .rerank import ClipReranker

            self.reranker = ClipReranker(
                rerank_weights, threshold=rerank_threshold, sampling=sampling, device=device
            )

    def _pair_passes_rerank(self, hash_a: str, hash_b: str) -> bool:
        """Embedding gate for a candidate pair (always True when the
        rerank stage is disabled)."""
        if self.reranker is None:
            return True
        return self.reranker.pair_passes(hash_a, hash_b, self.client.get_video)

    def _print_rerank_summary(self) -> None:
        if self.reranker is not None and self.reranker.pairs_checked:
            print(
                f"[blue] Rerank: {self.reranker.pairs_rejected} of"
                f" {self.reranker.pairs_checked} candidate pairs rejected by"
                f" the embedding gate."
            )

    def _device_mesh(self) -> "mesh_mod.Mesh | None":
        """Mesh over every visible CUDA device when no device was named and
        more than one is visible, else None (counterpart of the JAX
        package's ``_device_mesh``). Stage 1's hasher and stage 4's engine
        shard their leading batch axis over it; the rerank tower stays on
        one device. A named device, "cpu" or "cuda:1", means that device
        alone."""
        if self.device is not None or torch.cuda.device_count() <= 1:
            return None
        return mesh_mod.build_mesh()

    # -- stage 0: discovery ------------------------------------------------

    def get_search_tags(self, custom_query: "Sequence[str] | None") -> list[str]:
        search_tags = [
            "system:filetype=video, gif, apng",
            "system:has duration",
            "system:file service is not currently in trash",
        ]
        if custom_query is not None:
            custom_query = [q for q in custom_query if q.strip()]
            if custom_query:
                search_tags.extend(custom_query)
                print(f"[yellow] Custom Query: {custom_query}")
        return search_tags

    def filter_unhashed(self, file_hashes: "list[FileHash]") -> "list[FileHash]":
        already = set(self.db.get_phashed_files())
        return [h for h in file_hashes if h not in already]

    # -- top level ---------------------------------------------------------

    def deduplicate(self, skip_hashing: bool) -> int:
        """Run the full pipeline; returns the number of similar pairs found."""
        num_similar_pairs = 0

        if skip_hashing:
            print("[yellow] Skipping perceptual hashing")
        else:
            video_hashes = list(self.client.get_video_hashes(self.search_tags))
            video_hashes = self.filter_unhashed(video_hashes)
            print(f"[blue] Found {len(video_hashes)} eligible files to perceptually hash.")
            print("\nTip: You can skip perceptual hashing at any time by pressing CTRL+C.")
            self.db.begin_transaction()
            with self.db.conn:
                stats = PerceptualHashingStats()
                try:
                    stats = self.add_perceptual_hashes_to_db(video_hashes)
                except CancelledPerceptualHashException as exc:
                    stats = exc.stats
                    print("[yellow] Perceptual hash processing was interrupted! Progress was saved.")
                else:
                    print("[green] Finished perceptual hash processing.")
                finally:
                    if self.update_progress_callback:
                        self.update_progress_callback(NoneProgress())
                    self._print_hashing_stats(stats)

        print("\nTip: You can skip building the search tree at any time by pressing CTRL+C.")
        self.db.begin_transaction()
        with self.db.conn:
            try:
                self.process_phashed_file_queue()
            except KeyboardInterrupt:
                print("[yellow] Building the search tree was interrupted! Progress was saved.")
            else:
                print("[green] Finished fully building the search tree.")

        self.db.begin_transaction()
        with self.db.conn:
            try:
                self.run_maintenance()
            except KeyboardInterrupt:
                print("[yellow] Maintenance was interrupted!")
            else:
                print("[green] Finished maintenance.")

        pre_dedupe_count = self.client.get_potential_duplicate_count_hydrus()

        print("\nTip: You can skip finding potential duplicates at any time by pressing CTRL+C.")
        self.db.begin_transaction()
        with self.db.conn:
            try:
                num_similar_pairs = self.find_potential_duplicates()
            except KeyboardInterrupt:
                if getattr(self, "_last_search_backend", "tree") == "gpu":
                    # the engine checkpoints per SEARCH_CHECKPOINT_ROWS
                    # chunk: completed chunks' pairs are marked and their
                    # cache entries committed; only the in-flight chunk
                    # is redone next run
                    print(
                        "[yellow] Searching for duplicates was interrupted!"
                        " Completed search chunks were saved; the next run"
                        " redoes only the interrupted chunk."
                    )
                else:
                    print("[yellow] Searching for duplicates was interrupted! Progress was saved.")

        self._print_rerank_summary()
        post_dedupe_count = self.client.get_potential_duplicate_count_hydrus()
        new_count = post_dedupe_count - pre_dedupe_count
        if new_count > 0:
            print(f"[green] {new_count} new potential duplicate pairs marked for manual processing!")
        else:
            print("[green] No new potential duplicate pairs found.")

        log.info("%d similar file pairs found.", num_similar_pairs)
        log.info("Deduplication done.")
        if self.update_progress_callback:
            self.update_progress_callback(DoneProgress())
        return num_similar_pairs

    def _print_hashing_stats(self, stats: PerceptualHashingStats) -> None:
        total_failures = stats.failed_from_api_errors_count + stats.failed_from_phash_count
        if total_failures > 0:
            print(f"[yellow] Perceptual hash processing had {total_failures} total failed files.")
            if stats.failed_from_api_errors_count > 0:
                print(
                    f"[yellow] {stats.failed_from_api_errors_count} failures were due to API"
                    " errors. Ensure Hydrus is running and accessible before trying again."
                )
            if stats.failed_from_phash_count > 0:
                print(
                    f"[yellow] {stats.failed_from_phash_count} failures were from an error"
                    " during perceptual hashing. Are the files corrupted?"
                )
                print(
                    "\nTip: You could have seen which files failed directly in Hydrus by"
                    " creating a Hydrus page with the name 'failed' and running the"
                    " program with '--failed-page-name=failed'\n"
                )
        print(f"[green] Added {stats.success_hash_count} new perceptual hashes to the database.")

    # -- stage 1: hashing --------------------------------------------------

    #: use the device hash path (when "auto") only with at least this many
    #: files — below it the per-batch dispatch overhead never amortizes
    GPU_HASH_MIN_BATCH = 64
    #: ...and only when the measured host->device link can carry 512x512
    #: rgb24 frames faster than the native path hashes them: each frame is
    #: 786 KB on the wire, so the link decides the backend
    GPU_HASH_MIN_LINK_MBPS = 300.0
    #: wall-clock budget for the auto-backend device probe: a device that
    #: cannot initialise and move 4 MB inside it cannot feed 786 KB frames
    HASH_PROBE_TIMEOUT_S = 10.0

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
        """Resolve the stage-1 backend.

        "gpu" needs CUDA, or an explicit device: without one it raises.
        "auto" takes the device only when a CUDA device is there (or a
        non-CPU device was named), at least GPU_HASH_MIN_BATCH files need
        hashing, and the measured link carries GPU_HASH_MIN_LINK_MBPS
        within HASH_PROBE_TIMEOUT_S (the probe runs in a daemon thread);
        otherwise the native C++ hasher."""
        if self.hash_backend == "gpu":
            resolve_device(self.device)
            return "gpu"
        if self.hash_backend == "native":
            return "native"
        if self.device is not None:
            has_device = torch.device(self.device).type != "cpu"
        else:
            has_device = torch.cuda.is_available()
        if not has_device or num_files < self.GPU_HASH_MIN_BATCH:
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
        backend = "gpu" if mbps >= self.GPU_HASH_MIN_LINK_MBPS else "native"
        log.info("hash backend auto: link %.0f MB/s -> %s", mbps, backend)
        return backend

    def add_perceptual_hashes_to_db(self, video_hashes: "Sequence[str]") -> PerceptualHashingStats:
        if self._pick_hash_backend(len(video_hashes)) == "gpu":
            return self._add_perceptual_hashes_to_db_gpu(video_hashes)
        return self._add_perceptual_hashes_to_db_native(video_hashes)

    def _add_perceptual_hashes_to_db_native(
        self, video_hashes: "Sequence[str]"
    ) -> PerceptualHashingStats:
        stats = PerceptualHashingStats()
        try:
            with tqdm(
                total=len(video_hashes),
                desc="Perceptually hashing files",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar:
                hasher = FileHasher(self.client, self.job_count, sampling=self.sampling)
                success_count = 0
                for video_hash in video_hashes:
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n + 1, total=pbar.total)
                        )
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return stats

                    result = hasher.fetch_and_phash_file(video_hash)
                    if isinstance(result, FailedPerceptuallyHashedFile):
                        if isinstance(result.exc, HydrusApiException):
                            stats.failed_from_api_errors_count += 1
                            print("[red] Hydrus API error during perceptual hashing:")
                            print(f"{result.exc}")
                        else:
                            stats.failed_from_phash_count += 1
                            print("[red] Failed to perceptually hash a file.")
                            print(f"Failed file SHA256 hash: {result.file_hash}")
                            print(f"{result.exc}")
                            if self.page_logger:
                                self.page_logger.add_failed_video(result.file_hash)
                    else:
                        self.db.add_to_phashed_files_queue(result.file_hash, result.perceptual_hash)
                        stats.success_hash_count += 1
                        success_count += 1
                        if success_count % self.HASH_COMMIT_BATCH == 0:
                            self.db.commit()

                    gc.collect()  # bound memory held by video bytes/frames
                    pbar.update(1)
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n, total=pbar.total)
                        )
        except KeyboardInterrupt:
            raise CancelledPerceptualHashException(stats)
        gc.collect()
        return stats

    #: files fetched+hashed per device round in the GPU hashing path.
    #: GPU_HASH_CHUNK is the floor (and the first chunk's size: frames and
    #: bytes per file are unknown until something is hashed); later chunks
    #: adapt to carry ~2 device batches of frames each. The cap bounds
    #: files in flight, and the fetch-RAM cap the bytes a chunk may hold (2
    #: chunks are resident at once: the one hashing and the one
    #: prefetching).
    GPU_HASH_CHUNK = 16
    GPU_HASH_CHUNK_MAX = 512
    GPU_HASH_FETCH_RAM_CAP = 1 << 30

    def _add_perceptual_hashes_to_db_gpu(self, video_hashes) -> PerceptualHashingStats:
        """Device-batched hashing: fetch a chunk of files (the next chunk is
        fetched meanwhile), decode in a thread pool, hash all their frames
        in shared device batches on ``self.device``, then commit. Per-file
        API failures are isolated, chunk sizes adapt to the frames and
        bytes seen so far, CTRL+C checkpoints at chunk boundaries — the
        native path's failure, stat and commit semantics."""
        stats = PerceptualHashingStats()
        hasher = GpuVideoHasher(
            decode_workers=self.job_count, sampling=self.sampling, device=self.device,
            mesh=self._device_mesh(),
        )

        def fetch_chunk(chunk) -> list[tuple[str, bytes]]:
            """Per-file API failure isolation (FileHasher semantics)."""
            fetched: list[tuple[str, bytes]] = []
            for file_hash in chunk:
                try:
                    response = self.client.client.get_file(hash_=file_hash)
                    fetched.append((file_hash, response.content))
                except hydrus_api.HydrusAPIException as exc:
                    stats.failed_from_api_errors_count += 1
                    print("[red] Hydrus API error during perceptual hashing:")
                    print(f"{exc}")
                    time.sleep(FileHasher.API_ERROR_BACKOFF_SECONDS)
            return fetched

        # adaptive chunk sizing state: cumulative means over hashed files
        n_seen_frames = [0, 0]  # [files, frames]
        n_seen_bytes = [0, 0]  # [files, bytes]
        target_frames = 2 * hasher.batch_size

        def next_chunk_size() -> int:
            if n_seen_frames[0] == 0:
                return self.GPU_HASH_CHUNK
            mean_frames = max(1.0, n_seen_frames[1] / n_seen_frames[0])
            size = int(target_frames / mean_frames)
            if n_seen_bytes[0]:
                mean_bytes = max(1.0, n_seen_bytes[1] / n_seen_bytes[0])
                size = min(size, int(self.GPU_HASH_FETCH_RAM_CAP / mean_bytes))
            return max(self.GPU_HASH_CHUNK, min(size, self.GPU_HASH_CHUNK_MAX))

        def progress_update(pbar) -> None:
            if self.update_progress_callback:
                self.update_progress_callback(HashingProgress(complete=pbar.n, total=pbar.total))

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
            raise CancelledPerceptualHashException(stats)
        return stats

    # -- stage 2: queue -> tree -------------------------------------------

    def process_phashed_file_queue(self) -> None:
        (n_queued,) = self.db.execute(
            "SELECT count(*) FROM phashed_file_queue"
        ).fetchone()
        # the exact all-pairs engine never reads the VP-tree, so runs that
        # will search on it defer the per-insert tree descent entirely (at
        # corpus scale the descent — not hashing or search — would dominate
        # the pipeline). The decision mirrors stage 4's backend resolution
        # with the queue size as the corpus estimate; a wrong guess is
        # harmless because the tree path reconciles deferred phashes on
        # demand (_reconcile_tree).
        build_tree = self._pick_search_backend(n_queued) == "tree"
        if not build_tree:
            # deferred-descent route: drain the queue with set-based SQL
            # (DedupeDB.drain_phashed_queue_batch)
            done = 0
            with tqdm(
                total=n_queued,
                desc="Binding hashed files",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar:
                # adaptive batch size: skip/interrupt is only checked
                # between batches, so batches target a few seconds of
                # wall each — start small, grow toward QUEUE_DRAIN_BATCH
                # while batches stay fast
                batch = min(self.QUEUE_DRAIN_BATCH, 4096)
                while done < n_queued:
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            BuildingSearchTreeProgress(complete=done, total=n_queued)
                        )
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return
                    t0 = time.monotonic()
                    n = self.db.drain_phashed_queue_batch(batch)
                    if n == 0:
                        break
                    done += n
                    self.db.commit()
                    pbar.update(n)
                    dt = time.monotonic() - t0
                    if dt < 1.0:
                        batch = min(batch * 2, self.QUEUE_DRAIN_BATCH)
                    elif dt > 4.0:
                        batch = max(batch // 2, 1024)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=n_queued, total=n_queued)
                    )
            return
        rows = self.db.execute("SELECT file_hash, phash FROM phashed_file_queue").fetchall()
        with tqdm(
            total=len(rows),
            desc="Building search tree",
            dynamic_ncols=True,
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, (file_hash, phash) in enumerate(rows, start=1):
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=pbar.n, total=pbar.total)
                    )
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return
                self.db.add_file(file_hash)
                self.db.add_perceptual_hash(phash)
                self.db.associate_file_with_perceptual_hash(
                    file_hash, phash, build_tree=build_tree
                )
                self.db.execute(
                    "DELETE FROM phashed_file_queue WHERE file_hash = :f AND phash = :p",
                    {"f": file_hash, "p": phash},
                )
                if i % self.TREE_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=pbar.n, total=pbar.total)
                    )
            if self.update_progress_callback:
                self.update_progress_callback(
                    BuildingSearchTreeProgress(complete=len(rows), total=len(rows))
                )

    # -- stage 3: maintenance ---------------------------------------------

    def run_maintenance(self) -> None:
        tree = vptree.VpTreeManager(self.db)
        search_threshold = vptree.fix_vpdq_similarity(self.threshold)
        assert search_threshold > 0 and isinstance(search_threshold, int)
        if tree.maintenance_due(search_threshold):
            print("[blue] Running search tree maintenance...")
            tree.maintain_tree()

    # -- stage 4: search ---------------------------------------------------

    @staticmethod
    def _relationship_payload(hash_a: str, hash_b: str) -> dict:
        """The reference's potential-duplicate relationship (dedup.py:385-394)."""
        return {
            "hash_a": hash_a,
            "hash_b": hash_b,
            "relationship": int(hydrus_api.DuplicateStatus.POTENTIAL_DUPLICATES),
            "do_default_content_merge": True,
        }

    def mark_videos_as_duplicates(self, video1_hash: str, video2_hash: str) -> None:
        self.client.client.set_file_relationships(
            [self._relationship_payload(video1_hash, video2_hash)]
        )

    def _pick_search_backend(self, num_files: int) -> str:
        # degenerate thresholds (similarity < 1 => distance 101, "everything
        # matches") only have exact reference semantics on the tree path
        if vptree.fix_vpdq_similarity(self.threshold) > 100:
            return "tree"
        if self.search_backend in ("tree", "gpu"):
            return self.search_backend
        has_device = self.device is not None or torch.cuda.is_available()
        return "gpu" if has_device and num_files >= self.GPU_ENGINE_MIN_BATCH else "tree"

    def find_potential_duplicates(self) -> int:
        search_threshold = vptree.fix_vpdq_similarity(self.threshold)
        assert search_threshold > 0 and isinstance(search_threshold, int)
        files = [
            row[0]
            for row in self.db.execute(
                "SELECT hash_id FROM shape_search_cache WHERE searched_distance IS NULL"
                " OR searched_distance < :t",
                {"t": search_threshold},
            ).fetchall()
        ]
        backend = self._pick_search_backend(len(files))
        self._last_search_backend = backend
        log.info("searching %d files with the %s backend", len(files), backend)
        if backend == "gpu":
            return self._find_potential_duplicates_gpu(files, search_threshold)
        return self._find_potential_duplicates_tree(files, search_threshold)

    def _reconcile_tree(self, tree: "vptree.VpTreeManager") -> None:
        """Insert phashes whose tree descent was deferred by earlier
        gpu-backend runs (DedupeDB.associate_file_with_perceptual_hash
        build_tree=False) so tree search sees the full corpus."""
        missing = self.db.get_phashes_missing_from_tree()
        if not missing:
            return
        with tqdm(
            total=len(missing),
            desc="Inserting deferred files into the search tree",
            dynamic_ncols=True,
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, (phash_id, phash) in enumerate(missing, start=1):
                tree.add_leaf(phash_id, phash)
                if i % self.TREE_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
        self.db.commit()

    def _find_potential_duplicates_tree(self, files: list[int], search_threshold: int) -> int:
        """Reference semantics: per-file VP-tree search (dedup.py:445-502)."""
        tree = vptree.VpTreeManager(self.db)
        self._reconcile_tree(tree)
        num_similar_pairs = 0
        with tqdm(
            dynamic_ncols=True,
            total=len(files),
            desc="Finding potential duplicates",
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, hash_id in enumerate(files, start=1):
                if self.update_progress_callback:
                    self.update_progress_callback(
                        SearchingForDuplicatesProgress(complete=pbar.n, total=pbar.total)
                    )
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return num_similar_pairs // 2
                result = tree.search_file(hash_id, max_hamming_distance=search_threshold)
                file_hash_a = self.db.get_file_hash(hash_id)
                for similar_hash_id, _distance in result:
                    if hash_id != similar_hash_id:
                        file_hash_b = self.db.get_file_hash(similar_hash_id)
                        if not self._pair_passes_rerank(file_hash_a, file_hash_b):
                            continue
                        log.info('Similar files found: "%s" and "%s"', file_hash_a, file_hash_b)
                        self.mark_videos_as_duplicates(file_hash_a, file_hash_b)
                        num_similar_pairs += 1
                self.db.execute(
                    "UPDATE shape_search_cache SET searched_distance = ? WHERE hash_id = ?",
                    (search_threshold, hash_id),
                )
                if i % self.SEARCH_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        SearchingForDuplicatesProgress(complete=pbar.n, total=pbar.total)
                    )
        # pairs between two unsearched files are found from both directions
        return num_similar_pairs // 2

    def _find_potential_duplicates_gpu(self, files: list[int], search_threshold: int) -> int:
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
                SearchingForDuplicatesProgress(complete=0, total=len(row_ids))
            )
        engine = GpuSearchEngine(device=self.device, mesh=self._device_mesh())

        # Checkpointed sweep: after each chunk its pairs are marked in Hydrus
        # and its search-cache entries committed, so an interrupt loses at
        # most one chunk. Column-side device state is shared across chunks
        # via col_state, so the corpus uploads once.
        MARK_BATCH = 256
        num_similar_pairs = 0
        marked: set[tuple[int, int]] = set()
        rejected: set[tuple[int, int]] = set()  # pairs the rerank gate refused
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

        use_prune = engine.pick_prefilter(all_phashes, col_state, self.search_prefilter)
        log.info(
            "stage-4 prefilter: %s", "scene-representative prune" if use_prune else "none"
        )

        rows_done = 0
        max_chunks = int(os.environ.get("HVD_SEARCH_MAX_CHUNKS", "0")) or self.SEARCH_MAX_CHUNKS
        chunk_rows = max(self.SEARCH_CHECKPOINT_ROWS, -(-len(files) // max_chunks))
        # HVD_DEBUG_TIMING: one [chunk-timing] line a chunk, as the JAX package
        # prints, from the chunk's spans
        chunk_timing = debug_timing()

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
                with span("chunk.prefetch"):
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
                with span("chunk") as chunk_span:
                    with span("chunk.fetch"):
                        th, out, chunk_row_ids = prefetched.pop(ci)
                        start_prefetch(ci + 1)
                        with span("chunk.prefetch_wait"):
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
                                SearchingForDuplicatesProgress(
                                    complete=n_done, total=len(row_ids)
                                )
                            )

                    search_fn = engine.find_pairs_pruned if use_prune else engine.find_pairs
                    # rows are the corpus suffix at this chunk's position: the
                    # engine reuses its column rep cache for the row side
                    extra = {"rows_at": chunk_rows_start_pos} if use_prune else {}
                    with span("chunk.search"):
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
                    count("chunk.hits", len(hits))
                    with span("chunk.mark"):
                        marked_all = mark_hits(hits, chunk_row_ids, chunk_rows_start_pos)
                    if not marked_all:
                        return num_similar_pairs // 2
                    # the chunk is the checkpoint unit: its cache entries land
                    # atomically in one statement and one commit
                    with span("chunk.cache_update"):
                        self.db.conn.executemany(
                            "UPDATE shape_search_cache SET searched_distance = ? WHERE hash_id = ?",
                            [(search_threshold, h) for h in chunk_files],
                        )
                        self.db.commit()
                if chunk_timing:
                    seconds = {
                        part: chunk_span.child_seconds(f"chunk.{part}")
                        for part in ("fetch", "search", "mark", "cache_update")
                    }
                    # not rich's print: it reads the tag as markup and drops it
                    builtins.print(
                        f"[chunk-timing] rows {k0}..{k0 + len(chunk_files)}: "
                        f"fetch {seconds['fetch']:.1f}s search {seconds['search']:.1f}s "
                        f"mark {seconds['mark']:.1f}s ({len(hits)} hits) "
                        f"cache-update {seconds['cache_update']:.1f}s",
                        flush=True,
                    )
                rows_done += len(chunk_row_ids)
                search_bar.n = int(100 * rows_done / len(row_ids)) if len(row_ids) else 100
                search_bar.refresh()
            search_bar.n = 100
            search_bar.refresh()
        if self.update_progress_callback:
            self.update_progress_callback(
                SearchingForDuplicatesProgress(complete=len(row_ids), total=len(row_ids))
            )
        return num_similar_pairs // 2
