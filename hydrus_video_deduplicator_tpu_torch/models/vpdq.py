"""Video-level hashing on the GPU: decode-parallel, device-batched VPDQ
(counterpart of the JAX package's ``TpuVideoHasher``).

    files -> [decode pool: N threads] -> frames batched across videos in a
          pinned staging buffer [B, 3, 512, 512] -> non-blocking H2D copy
          -> PDQ filter kernel + PyTorch tail -> (hash words, quality)
          -> regroup by video, quality-filter, pack -> VpdqHash per file

Frames from many videos share device batches, so the batch stays full
whatever the video lengths. One batch is in flight on the device while the
host fills the other staging buffer: a batch's H2D copy, kernel, tail and
D2H copy of its words and quality into pinned host buffers are queued on
the stream behind one event, and the host waits on batch N-1's event only
after it has queued batch N. A video that fails to
decode yields a typed failure and never poisons a batch. The kernel takes
runtime sizes, so a partial flush goes to the device at its real size.

Over a mesh (``parallel.mesh``) each batch splits into one contiguous slab
per member, as the JAX hasher shards its batch axis: each slab is copied
from its slice of the pinned buffer to its member's device, hashed there on
the member's stream and copied back behind one event per member.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from collections.abc import Callable, Iterable
from dataclasses import dataclass

import numpy as np
import torch

from ..decode import extract_frames
from ..ops.pdq_filter import pdq_hash_batch_fused
from ..parallel.mesh import Mesh, resolve_mesh, row_slabs
from ..vpdq import VpdqHash
from ..vpdq import pdq_math as pm
from .pdq import words_to_blobs

#: device batch (frames) on CUDA, and on the CPU (the tests' plain path)
BATCH = 512
BATCH_CPU = 16
#: decode worker threads feeding the device when the caller gives no count
DECODE_WORKERS = 4
#: decoded frames buffered ahead of the batch loop, per device batch:
#: decode keeps filling while a full batch is on the device
FRAME_BUFFER_BATCHES = 2


class _ConsumerAborted(Exception):
    """Internal: the batch consumer died; decode workers must exit."""


@dataclass
class VideoResult:
    key: object
    phash: VpdqHash | None
    error: Exception | None = None
    #: frames decoded and hashed for this video, quality-dropped ones
    #: included (they cost decode and H2D all the same)
    n_frames: int = 0


class GpuVideoHasher:
    """Batched hashing of many videos on one device or over a mesh.

    Usage: ``results = GpuVideoHasher().hash_videos(items)`` where items
    yields (key, video_bytes_or_path); results keep the input order.
    ``stats`` accumulates over calls: frames, batches, the seconds spent
    in ``hash_videos``, and the seconds its batch loop waited on decode and
    on the device.
    """

    def __init__(
        self,
        batch_size: int | None = None,
        decode_workers: int | None = None,
        quality_min: int = pm.QUALITY_MIN_KEEP,
        sampling: str = "uniform",
        device: "str | torch.device | None" = None,
        mesh: Mesh | None = None,
    ):
        """decode_workers follows the reference's job-count convention:
        n > 0 explicit, 0 or None -> DECODE_WORKERS, negative -> cores + 1
        + n (so -1 = all cores, -2 = all but one).

        device: None is CUDA, and raises without it; "cpu" runs the plain
        PyTorch filter (the tests). mesh (exclusive with device): each
        batch is sharded over its members, and batch_size rounds up to a
        multiple of the mesh size."""
        if decode_workers is None or decode_workers == 0:
            decode_workers = DECODE_WORKERS
        elif decode_workers < 0:
            decode_workers = max(1, (os.cpu_count() or 2) + 1 + decode_workers)
        self.mesh = resolve_mesh(device, mesh)
        self.device = self.mesh.devices[0]
        if batch_size is None:
            batch_size = BATCH if self.device.type == "cuda" else BATCH_CPU
        n = self.mesh.size
        self.batch_size = -(-batch_size // n) * n
        self.decode_workers = decode_workers
        self.quality_min = quality_min
        self.sampling = sampling
        self.stats = {
            "frames": 0, "batches": 0, "hash_s": 0.0, "decode_wait_s": 0.0, "device_wait_s": 0.0
        }
        self._staging: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def _staging_buffers(self) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Two sets of host buffers (frames in; words and quality out), made
        at first use and kept; pinned when the device is CUDA, so the copies
        both ways run beside the host's work."""
        if not self._staging:
            b, pin = self.batch_size, self.device.type == "cuda"
            self._staging = [
                (
                    torch.empty((b, 3, pm.FRAME_DIM, pm.FRAME_DIM), dtype=torch.uint8, pin_memory=pin),
                    torch.empty((b, pm.DCT_DIM), dtype=torch.int32, pin_memory=pin),
                    torch.empty((b,), dtype=torch.int32, pin_memory=pin),
                )
                for _ in range(2)
            ]
        return self._staging

    # -- decode stage -----------------------------------------------------

    @staticmethod
    def _abortable_put(out: "queue.Queue", item, abort: threading.Event) -> None:
        """Bounded-queue put that gives up when the consumer aborted, so a
        device failure never leaves workers blocked on a full queue."""
        while True:
            try:
                out.put(item, timeout=0.25)
                return
            except queue.Full:
                if abort.is_set():
                    raise _ConsumerAborted()

    def _decode_worker(self, jobs: "queue.Queue", out: "queue.Queue", abort) -> None:
        """Streams ('frame', idx, frame_no, planar) messages through the
        frame-bounded queue, then one ('done', idx, n_frames, error) per
        video."""
        while True:
            item = jobs.get()
            if item is None:
                return
            idx, _key, video = item
            n = 0
            try:
                for f in extract_frames(video, sampling=self.sampling):
                    self._abortable_put(
                        out, ("frame", idx, n, np.ascontiguousarray(f.transpose(2, 0, 1))), abort
                    )
                    n += 1
                self._abortable_put(out, ("done", idx, n, None), abort)
            except _ConsumerAborted:
                return
            except Exception as exc:  # typed failure, never poisons the batch
                try:
                    self._abortable_put(out, ("done", idx, n, exc), abort)
                except _ConsumerAborted:
                    return

    # -- main pipeline -----------------------------------------------------

    def hash_videos(
        self,
        items: Iterable[tuple[object, bytes | str]],
        progress: Callable[[int, int], None] | None = None,
    ) -> list[VideoResult]:
        t_start = time.perf_counter()
        items = list(items)
        errors: dict[int, Exception] = {}

        jobs: "queue.Queue" = queue.Queue()
        decoded: "queue.Queue" = queue.Queue(maxsize=FRAME_BUFFER_BATCHES * self.batch_size)
        abort = threading.Event()
        for idx, (key, video) in enumerate(items):
            jobs.put((idx, key, video))
        workers = []
        for _ in range(min(self.decode_workers, max(1, len(items)))):
            jobs.put(None)
            t = threading.Thread(
                target=self._decode_worker, args=(jobs, decoded, abort), daemon=True
            )
            t.start()
            workers.append(t)

        hashes_per_video: dict[int, list[tuple[int, bytes]]] = {i: [] for i in range(len(items))}
        # two buffer sets: the batch loop fills one while the other's batch
        # is on the device; a set is refilled only after its batch drained
        staging = self._staging_buffers()
        host = [frames.numpy() for frames, _, _ in staging]
        cur, fill = 0, 0
        owners: list[tuple[int, int]] = []  # (video idx, frame_no) per slot
        inflight: deque = deque()

        def drain_one():
            words, qual, done, batch_owners = inflight.popleft()
            t0 = time.perf_counter()
            for event in done:
                event.synchronize()  # this batch only; the next stays queued
            self.stats["device_wait_s"] += time.perf_counter() - t0
            words, qual = words.numpy(), qual.numpy()
            for (owner, frame_no), blob, q in zip(batch_owners, words_to_blobs(words), qual):
                hashes_per_video[owner].append((frame_no, blob if q >= self.quality_min else b""))

        def flush():
            nonlocal cur, fill, owners
            if fill == 0:
                return
            frames, words, qual = (t[:fill] for t in staging[cur])
            # a partial flush splits at its real size: the kernel takes
            # runtime sizes, so the JAX hasher's padding of a flush to a
            # mesh multiple (its _pad_target) has no counterpart here
            done = []
            for k, (s0, s1) in enumerate(row_slabs(fill, self.mesh)):
                if s0 == s1:
                    continue
                dev = self.mesh.devices[k]
                with self.mesh.member(k):
                    words_dev, qual_dev = pdq_hash_batch_fused(
                        frames[s0:s1].to(dev, non_blocking=True)
                    )
                    words[s0:s1].copy_(words_dev, non_blocking=True)
                    qual[s0:s1].copy_(qual_dev, non_blocking=True)
                    if dev.type == "cuda":
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(dev))
                        done.append(event)
            inflight.append((words, qual, done, owners))
            self.stats["frames"] += fill
            self.stats["batches"] += 1
            cur, fill, owners = 1 - cur, 0, []
            while len(inflight) > 1:  # frees the set the next batch fills
                drain_one()

        done_decoding = 0
        try:
            while done_decoding < len(items):
                t0 = time.perf_counter()
                msg = decoded.get()
                self.stats["decode_wait_s"] += time.perf_counter() - t0
                if msg[0] == "frame":
                    _, idx, frame_no, frame = msg
                    host[cur][fill] = frame
                    owners.append((idx, frame_no))
                    fill += 1
                    if fill == self.batch_size:
                        flush()
                else:  # ("done", idx, n_frames, error)
                    _, idx, _n, exc = msg
                    done_decoding += 1
                    if exc is not None:
                        errors[idx] = exc
                    if progress:
                        progress(done_decoding, len(items))
            flush()
            while inflight:
                drain_one()
        except BaseException:
            # device or hash failure (or CTRL+C): release workers blocked on
            # the bounded queue before propagating, or they leak
            abort.set()
            while True:
                try:
                    decoded.get_nowait()
                except queue.Empty:
                    break
            for t in workers:
                t.join(timeout=5.0)
            raise
        for t in workers:
            t.join()

        out: list[VideoResult] = []
        for idx, (key, _video) in enumerate(items):
            if idx in errors:  # decode failure: drop any partial hashes
                out.append(VideoResult(key, None, errors[idx]))
                continue
            parts = sorted(hashes_per_video[idx])
            blob = b"".join(b for _, b in parts)
            out.append(VideoResult(key, VpdqHash(blob), n_frames=len(parts)))
        self.stats["hash_s"] += time.perf_counter() - t_start
        return out
