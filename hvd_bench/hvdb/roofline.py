"""The least time the card could take for a kernel's call, from the work
its unpadded inputs hold and the peaks in ``hvd_bench/peaks.json``.

A Hamming-threshold kernel's call compares every real row frame with every
real column frame of its valid column steps: each such frame pair is one
256-deep binary product. Its bytes are each input read once and the output
written once. Its bound is the larger of the bytes over the HBM rate and
the frame pairs over the binary tensor cores' rate.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _live_frame_pairs(slot_a, slot_b, valid):
    """Real row frames times the real column frames of the valid steps, as
    a device scalar (read after the window)."""
    live_b = (slot_b.view(valid.shape[0], -1) >= 0) & (valid[:, None] != 0)
    return (slot_a >= 0).sum() * live_b.sum()


def sweep_work(args, out):
    """exists_mask_sweep(a_words, slot_a, b_words, slot_b, valid, tol)."""
    a_words, slot_a, b_words, slot_b, valid = args[:5]
    return (
        _live_frame_pairs(slot_a, slot_b, valid),
        tensor_bytes(a_words, slot_a, b_words, slot_b, valid, out),
    )


def segments_work(args, out):
    """similarity_segments(a_words, slot_a, counts_a, b_words, slot_b,
    counts_b, valid, min_sim)."""
    a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid = args[:7]
    return (
        _live_frame_pairs(slot_a, slot_b, valid),
        tensor_bytes(a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid, out),
    )


def bound_seconds(frame_pairs: int, n_bytes: int) -> float:
    p = peaks()
    return max(n_bytes / p["hbm_bytes_per_s"], frame_pairs / p["b1_frame_pairs_per_s"])


def share_percent(totals) -> float | None:
    """A kernel's share of its roofline in percent, from
    ``Spans.kernel_totals``: its bound over its device time."""
    if totals is None:
        return None
    _launches, seconds, pairs, n_bytes = totals
    if seconds <= 0:
        return None
    return 100.0 * bound_seconds(pairs, n_bytes) / seconds
