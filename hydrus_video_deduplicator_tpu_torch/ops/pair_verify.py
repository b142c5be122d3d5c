"""Batched exact verification of candidate video pairs (counterpart of the
JAX package's ``ops/pair_verify.py``).

Stage B of the pruned search: for each candidate (row, col) pair from the
existence sweep, the exact reference similarity — min of the two
directional match fractions at tolerance 31, identical to native
``matchHashBytes``. Pairs bucket by padded frame count (32..512); each
chunk of a bucket is one batched ±1 product [P, F, 256] x [P, 256, F].

On CUDA the ±1 operands are fp16: every partial sum is an integer of
magnitude <= 256 < 2048, so fp16 products and even fp16 reduction are
exact. On the CPU they are float32.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..utils.profiling import count, debug_timing, span
from . import similarity as ops_sim
from .similarity import BYTES, LANES, MATCH_DOT

#: frame-count buckets (videos pad up to the next bucket; callers route
#: videos longer than the last bucket to the host path)
PADS = (32, 64, 128, 256, 512)
MAX_PAD = PADS[-1]


def pairs_per_chunk(pad: int) -> int:
    """Pairs per batched product: bounds the [P, pad, pad] product to 8 MB
    of int32-sized entries."""
    return max(8, (1 << 21) // (pad * pad))


def _verify_chunk(a_words, a_cnt, b_words, b_cnt, pad: int) -> torch.Tensor:
    """Exact per-pair similarity for one bucket chunk.

    a_words/b_words: [P, pad, 8] int32 bit-packed frames; a_cnt/b_cnt: [P]
    int32 true frame counts (0 = empty/padding pair). Returns [P] int32
    similarity, identical to int(matchHashBytes(a, b, 31)).
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


def _bucket_of(n_frames: int) -> int:
    for p in PADS:
        if n_frames <= p:
            return p
    raise ValueError(f"video of {n_frames} frames exceeds pair-verify MAX_PAD")


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
    (i, j, sim) triples with sim >= min_sim, in no particular order. Both
    sides of every pair must have 1..MAX_PAD frames (the engine routes
    other videos to the complement sweeps). Each bucket's results come
    back to the host in one transfer.

    The call is the span ``verify``, with the children ``verify.bucket``,
    ``verify.pack``, ``verify.dispatch`` and ``verify.drain`` and the count
    ``verify.chunks``. With ``HVD_DEBUG_TIMING`` set it prints the JAX
    package's ``[verify-timing]`` line on stderr from them: the host
    seconds of bucketing the pairs, packing the chunks, dispatching them
    (the copies to the device and the product) and draining the results
    (the copy to the host, which waits on the device), over the number of
    device chunks.
    """
    timing = debug_timing()
    with span("verify") as call:
        out: list[tuple[int, int, int]] = []
        buckets: dict[int, list[tuple[int, int, int, int]]] = {}
        with span("verify.bucket"):
            for i, j in pairs:
                a = row_blob[i]
                b = col_blob[j]
                if a == b:
                    # identical blobs (self-pairs, exact duplicate files) are always
                    # similarity 100; CPython compares identical objects in O(1)
                    out.append((i, j, 100))
                    continue
                na = len(a) // BYTES
                nb = len(b) // BYTES
                assert na > 0 and nb > 0, (i, j)
                buckets.setdefault(_bucket_of(max(na, nb)), []).append((i, j, na, nb))
        done = len(out)
        total = len(pairs)
        for pad, items in sorted(buckets.items()):
            p_chunk = pairs_per_chunk(pad)
            sims_dev = []
            for k0 in range(0, len(items), p_chunk):
                chunk = items[k0 : k0 + p_chunk]
                with span("verify.pack"):
                    a_packed = np.zeros((len(chunk), pad, LANES), dtype=np.uint32)
                    b_packed = np.zeros((len(chunk), pad, LANES), dtype=np.uint32)
                    a_cnt = np.zeros(len(chunk), dtype=np.int32)
                    b_cnt = np.zeros(len(chunk), dtype=np.int32)
                    for k, (i, j, na, nb) in enumerate(chunk):
                        a_packed[k, :na] = ops_sim.blobs_to_packed(row_blob[i])
                        b_packed[k, :nb] = ops_sim.blobs_to_packed(col_blob[j])
                        a_cnt[k] = na
                        b_cnt[k] = nb
                with span("verify.dispatch"):
                    sims_dev.append(
                        _verify_chunk(
                            ops_sim.to_words(a_packed, device),
                            torch.from_numpy(a_cnt).to(device),
                            ops_sim.to_words(b_packed, device),
                            torch.from_numpy(b_cnt).to(device),
                            pad,
                        )
                    )
                count("verify.chunks")
            with span("verify.drain"):
                sims = torch.cat(sims_dev).cpu().numpy()
            for (i, j, _, _), s in zip(items, sims.tolist()):
                if s >= min_sim:
                    out.append((i, j, s))
            done += len(items)
            if progress is not None:
                progress(done, total)
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

