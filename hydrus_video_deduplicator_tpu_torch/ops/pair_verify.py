"""Batched exact verification of candidate video pairs (counterpart of the
JAX package's ``ops/pair_verify.py``).

Stage B of the pruned search: for each candidate (row, col) pair from the
existence sweep, the exact reference similarity — min of the two
directional match fractions at tolerance 31, identical to native
``matchHashBytes``.

The host side (``_split``) settles pairs of identical blobs (self-pairs,
exact duplicate files) as 100 in one pass over the candidates, and gathers
each distinct video of the other pairs once into one packed frame array,
with a pair table of frame offsets and counts into it (NumPy, no loop a
pair).

On CUDA the whole call is one upload of that table and those frames and
one launch of ``csrc/pair_verify.cu`` (a block per pair, the frame
distances on the tensor cores), then one copy of the int32 similarities
back. On the CPU the pairs bucket by padded frame count (32..512) and each
chunk of a bucket is one batched float32 ±1 product [P, F, 256] x
[P, 256, F] (``_verify_chunk``), the reference the kernel is held to.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import count, debug_timing, span
from . import similarity as ops_sim
from .similarity import BYTES, LANES, MATCH_DOT

#: frame-count buckets of the CPU path (videos pad up to the next bucket);
#: callers route videos longer than the last bucket to the host path
PADS = (32, 64, 128, 256, 512)
MAX_PAD = PADS[-1]

#: kernel launches by wrapper name: the wrapper adds one where it launches
#: its kernel (a run reads it to show its path went through the kernel);
#: the running total, over calls, of what the span count ``verify.chunks``
#: counts a call on CUDA
LAUNCHES = {"pair_verify": 0}


def pairs_per_chunk(pad: int) -> int:
    """Pairs per batched product of the CPU path: bounds the [P, pad, pad]
    product to 8 MB of int32-sized entries."""
    return max(8, (1 << 21) // (pad * pad))


def _verify_chunk(a_words, a_cnt, b_words, b_cnt, pad: int) -> torch.Tensor:
    """Exact per-pair similarity for one bucket chunk.

    a_words/b_words: [P, pad, 8] int32 bit-packed frames; a_cnt/b_cnt: [P]
    int32 true frame counts (0 = empty/padding pair). Returns [P] int32
    similarity, identical to int(matchHashBytes(a, b, 31)). The ±1
    operands are float16 on CUDA (every partial sum is an integer of
    magnitude <= 256 < 2048, so fp16 products and sums are exact) and
    float32 on the CPU.
    """
    dtype = torch.float16 if a_words.is_cuda else torch.float32
    frame = torch.arange(pad, device=a_words.device)
    va = (frame[None, :] < a_cnt[:, None]).unsqueeze(-1).to(dtype)  # [P, pad, 1]
    vb = (frame[None, :] < b_cnt[:, None]).unsqueeze(-1).to(dtype)
    a = ops_sim.unpack_pm1(a_words, dtype) * va  # zero rows past the count
    b = ops_sim.unpack_pm1(b_words, dtype) * vb
    dot = torch.bmm(a, b.transpose(1, 2))  # [P, pad, pad]
    matched = dot >= MATCH_DOT  # zero rows dot at 0 < MATCH_DOT: never match
    ma = matched.any(dim=2).sum(dim=1, dtype=torch.int32)
    mb = matched.any(dim=1).sum(dim=1, dtype=torch.int32)
    fa = torch.clamp(a_cnt, min=1)
    fb = torch.clamp(b_cnt, min=1)
    sim = torch.minimum((100 * ma) // fa, (100 * mb) // fb)
    return torch.where((a_cnt > 0) & (b_cnt > 0), sim, torch.zeros_like(sim))


@dataclass
class _Split:
    """A call's candidates after the host side.

    ``identical``: the (i, j, 100) triples of the candidates of identical
    blobs;
    ``dev`` [P, 2] int64: the other (row, col) pairs; ``table`` [P, 4]
    int32: each of those pairs' frame offset and count of its row video,
    then of its column video, into the frames of ``videos``, the distinct
    videos' blobs (row videos first) joined in their order."""

    identical: list
    dev: np.ndarray
    table: np.ndarray
    videos: list


def _split(pairs, row_blob, col_blob) -> _Split:
    """Identical blobs settled, and every distinct video of the other pairs
    looked up once (see ``_Split``).

    Raises AssertionError for an empty video in a pair of two different
    blobs, and ValueError for one longer than MAX_PAD frames."""
    identical: list[tuple[int, int, int]] = []
    dev_pairs = []
    # one loop over the candidates, the triples built as it goes: measured
    # faster than C-level passes (map, compress) that need a second pass
    # for the triples. The same object (a self-pair at corpus scale)
    # compares equal in O(1), blobs of unequal length at once.
    for pair in pairs:
        i, j = pair
        if row_blob[i] == col_blob[j]:
            identical.append((i, j, 100))
        else:
            dev_pairs.append(pair)
    dev = np.array(dev_pairs, dtype=np.int64).reshape(-1, 2)
    a_used, a_slot = np.unique(dev[:, 0], return_inverse=True)
    b_used, b_slot = np.unique(dev[:, 1], return_inverse=True)
    videos = [*map(row_blob.__getitem__, a_used.tolist()),
              *map(col_blob.__getitem__, b_used.tolist())]
    frames = np.fromiter(map(len, videos), dtype=np.int64, count=len(videos)) // BYTES
    start = np.cumsum(frames) - frames
    na, nb = frames[a_slot], frames[len(a_used) + b_slot]
    empty = np.flatnonzero((na == 0) | (nb == 0))
    assert not len(empty), tuple(dev[empty[0]].tolist())
    if len(dev) and max(na.max(), nb.max()) > MAX_PAD:
        raise ValueError(f"video of {max(na.max(), nb.max())} frames exceeds pair-verify MAX_PAD")
    table = np.stack([start[a_slot], na, start[len(a_used) + b_slot], nb], axis=1)
    return _Split(identical, dev, table.astype(np.int32).reshape(-1, 4), videos)


def _pack(split: _Split) -> tuple[torch.Tensor, np.ndarray]:
    """The kernel's input in pinned host memory, as one int32 tensor: the
    pair table, longer video first and the largest pairs first, then the
    frames; and the order: row k of the packed table is pair ``order[k]``
    of ``split.dev``."""
    table = split.table
    swap = table[:, 3] > table[:, 1]  # the similarity is symmetric in its videos
    table = np.where(swap[:, None], table[:, [2, 3, 0, 1]], table)
    order = np.argsort(-(table[:, 1].astype(np.int64) * table[:, 3]), kind="stable")
    words = sum(map(len, split.videos)) // 4
    host = torch.empty(table.size + words, dtype=torch.int32, pin_memory=True)
    view = host.numpy()
    view[: table.size] = table[order].reshape(-1)
    # each blob copied once, straight into the pinned buffer
    np.concatenate([np.frombuffer(v, dtype=np.int32) for v in split.videos], out=view[table.size :])
    return host, order


def _launch(buf: torch.Tensor, n_pairs: int) -> torch.Tensor:
    """[n_pairs] int32 similarities of the pairs in ``buf`` (``_pack``'s
    layout) from ``csrc/pair_verify.cu``, on the current stream."""
    from . import _build

    out = torch.empty(n_pairs, dtype=torch.int32, device=buf.device)
    lib = _build.load_library("pair_verify")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.hvd_pair_verify(
            buf.data_ptr(), buf.data_ptr() + 16 * n_pairs, out.data_ptr(), n_pairs, stream
        )
    if err != 0:
        msg = ctypes.string_at(lib.hvd_cuda_error_string(err)).decode()
        raise RuntimeError(f"pair_verify launch failed: CUDA error {err} ({msg})")
    LAUNCHES["pair_verify"] += 1
    return out


def _packed(words: np.ndarray, off: np.ndarray, cnt: np.ndarray, pad: int) -> np.ndarray:
    """[len(off), pad, 8] uint32: each video's frames from ``words``,
    zeros past its count."""
    frame = np.arange(pad)
    real = frame[None, :] < cnt[:, None]
    return np.where(real[:, :, None], words[np.where(real, off[:, None] + frame, 0)], 0)


def _verify_plain(split: _Split, device: torch.device) -> np.ndarray:
    """The plain version of the kernel over ``split.dev``: bucket chunks of
    ``_verify_chunk`` on ``device`` (the CPU path; on CUDA the float16
    chain the kernel replaced), each bucket's results drained in one copy.
    Spans ``verify.pack``, ``verify.dispatch``, ``verify.drain``."""
    table = split.table
    sims = np.zeros(len(table), dtype=np.int32)
    with span("verify.pack"):
        words = np.frombuffer(b"".join(split.videos), dtype=np.uint32).reshape(-1, LANES)
    pads = np.searchsorted(PADS, np.maximum(table[:, 1], table[:, 3]))
    for pad_at in np.unique(pads).tolist():
        pad = PADS[pad_at]
        items = np.flatnonzero(pads == pad_at)
        got = []
        step = pairs_per_chunk(pad)
        for k0 in range(0, len(items), step):
            chunk = table[items[k0 : k0 + step]]
            with span("verify.pack"):
                a = _packed(words, chunk[:, 0], chunk[:, 1], pad)
                b = _packed(words, chunk[:, 2], chunk[:, 3], pad)
            with span("verify.dispatch"):
                got.append(_verify_chunk(
                    ops_sim.to_words(a, device), torch.from_numpy(chunk[:, 1].copy()).to(device),
                    ops_sim.to_words(b, device), torch.from_numpy(chunk[:, 3].copy()).to(device),
                    pad,
                ))
            count("verify.chunks")
        with span("verify.drain"):
            sims[items] = torch.cat(got).cpu().numpy()
    return sims


def verify_pairs(
    pairs: "list[tuple[int, int]]",
    row_blob,
    col_blob,
    min_sim: int,
    device: torch.device,
    progress=None,
) -> "list[tuple[int, int, int]]":
    """Exact similarities for candidate (row_index, col_index) pairs.

    row_blob/col_blob: mappings index -> packed hash blob. Returns the
    (i, j, sim) triples with sim >= min_sim, in no particular order; a pair
    of identical blobs gives (i, j, 100). Both sides of every other pair
    must have 1..MAX_PAD frames (the engine routes other videos to the
    complement sweeps). ``progress(done, total)`` is called once, at the
    end.

    The call is the span ``verify``, with the children ``verify.bucket``
    (the host side, ``_split``), ``verify.pack``, ``verify.dispatch`` and
    ``verify.drain``, and the counts ``verify.chunks`` (the call's batched
    scoring calls: its one kernel launch on CUDA, its ``_verify_chunk``
    bucket chunks on the CPU), ``verify.device_pairs`` (pairs scored) and
    ``verify.host_pairs`` (settled as identical). On CUDA the
    pack is the frames' copy into pinned memory, the dispatch the upload
    and the launch, the drain the copy back (which waits on the device) and
    the filter. With ``HVD_DEBUG_TIMING`` set it prints the JAX package's
    ``[verify-timing]`` line on stderr from them.
    """
    timing = debug_timing()
    with span("verify") as call:
        with span("verify.bucket"):
            split = _split(pairs, row_blob, col_blob)
            out = split.identical
        count("verify.host_pairs", len(out))
        count("verify.device_pairs", len(split.dev))
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        sims = np.zeros(len(split.dev), dtype=np.int32)
        if len(split.dev) and device.type == "cpu":
            sims = _verify_plain(split, device)
        elif len(split.dev):
            with span("verify.pack"):
                host, order = _pack(split)
            with span("verify.dispatch"):
                sims_dev = _launch(host.to(device, non_blocking=True), len(order))
            count("verify.chunks")
            with span("verify.drain"):
                sims[order] = sims_dev.cpu().numpy()
        with span("verify.drain"):
            keep = sims >= min_sim
            hit = split.dev[keep]
            out += zip(hit[:, 0].tolist(), hit[:, 1].tolist(), sims[keep].tolist())
        if progress is not None:
            progress(len(pairs), len(pairs))
    if timing:
        parts = {
            name: call.child_seconds(f"verify.{name}")
            for name in ("bucket", "pack", "dispatch", "drain")
        }
        print(
            "[verify-timing] bucket {bucket:.1f}s pack {pack:.1f}s dispatch "
            "{dispatch:.1f}s drain {drain:.1f}s over {n} device chunks".format(
                **parts, n=call.counts.get("verify.chunks", 0)
            ),
            file=sys.stderr,
            flush=True,
        )
    return out
