"""Scene-representative extraction for the exact pruned search route.

The reference's VP-tree prunes its search with the triangle inequality
over sphere radii (upstream src/hydrusvideodeduplicator/db/
vptree.py:754-777). This module is that idea rebuilt flat and TPU-first:
instead of a pointer tree descended per query, each video's frames are
greedily clustered into a handful of *representative frames* (scene
leaders), and the corpus-level candidate filter becomes one dense
MXU sweep over representatives (parallel/engine.py pruned route).

Clustering (native hvd_cluster_reps, numpy fallback below): frames scan
the video's leaders in creation order and join the first one within
RADIUS_CAP Hamming distance; otherwise they become a new leader. The
representatives ARE frames of the video, so they reuse every packed-blob
code path.

Exactness (the prune theorem): for frames a in A, b in B with leaders
c_a, c_b, the triangle inequality on Hamming distance gives

    d(a, b) >= d(c_a, c_b) - d(a, c_a) - d(b, c_b)
            >= d(c_a, c_b) - 2 * RADIUS_CAP.

So if EVERY leader pair of (A, B) has d > TOL + 2 * RADIUS_CAP, then
every frame pair has d > TOL: similarity is exactly 0 and the video pair
cannot reach any positive threshold. The engine therefore sweeps leaders
at the inflated tolerance TOL + 2 * RADIUS_CAP for *existence* of a
leader-pair match, and exactly verifies the survivors on their full
frames (ops/pair_verify.py). No false negatives by construction; false
positives only cost verification work.

Worst-case degradation is graceful: frames that cluster poorly (random,
unrelated) become their own leaders, the "rep corpus" equals the frame
corpus, and the pruned route's cost approaches the brute-force sweep it
replaces — never worse asymptotically, ~(F/k)^2 cheaper when videos have
k scenes of F frames.

RADIUS_CAP trades rep count against filter selectivity: the existence
sweep's random-pair pass rate is P[Binom(256, 1/2) <= TOL + 2*cap]
(~7e-10 at cap 24, ~3e-7 at cap 28, ~2e-5 at cap 32 — the margin decays
a factor ~8 per +1 sigma = 8 bits of cap). 24 keeps false candidates
negligible at 10^13-pair scale while one leader still covers a typical
multi-second shot's drift.
"""

from __future__ import annotations

import numpy as np

from ..vpdq import pdq_math as pm

BYTES = pm.BYTES_PER_HASH

#: default leader radius (Hamming bits); see module docstring
RADIUS_CAP = 24

#: the inflated existence tolerance the engine must use with these reps
def prune_tolerance(radius_cap: int = RADIUS_CAP, tol: int = pm.DEFAULT_DISTANCE_TOLERANCE) -> int:
    return tol + 2 * radius_cap


_POPCNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _cluster_one_numpy(frames: np.ndarray, radius_cap: int) -> np.ndarray:
    """Greedy leader indices for one video's [n, 32] uint8 frames.

    Identical order/semantics to native hvd_cluster_reps (first leader
    within radius wins, scan in creation order).
    """
    leaders: list[int] = []
    if len(frames) == 0:
        return np.zeros(0, dtype=np.int32)
    lead_arr = np.zeros((0, BYTES), dtype=np.uint8)
    for i in range(len(frames)):
        if len(leaders):
            d = _POPCNT8[lead_arr ^ frames[i][None, :]].sum(axis=1)
            if (d <= radius_cap).any():
                continue
        leaders.append(i)
        lead_arr = np.concatenate([lead_arr, frames[i][None, :]])
    return np.asarray(leaders, dtype=np.int32)


def extract_reps_arrays(
    frames: np.ndarray, offsets: np.ndarray, radius_cap: int = RADIUS_CAP
) -> tuple[np.ndarray, np.ndarray]:
    """Corpus-scale rep extraction.

    frames: [N, 32] uint8 — every video's frame hashes concatenated;
    offsets: int64 [n_videos + 1] frame offsets delimiting each video.
    Returns (rep_frames [K, 32] uint8, rep_offsets int64 [n_videos + 1]).
    """
    from .. import native

    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if native.is_available():
        leaders, counts = native.cluster_reps_batch(frames, offsets, radius_cap)
    else:
        lead_list = []
        counts = np.zeros(len(offsets) - 1, dtype=np.int32)
        for v in range(len(offsets) - 1):
            f0, f1 = int(offsets[v]), int(offsets[v + 1])
            idx = _cluster_one_numpy(frames[f0:f1], radius_cap)
            lead_list.append(idx + f0)
            counts[v] = len(idx)
        leaders = (
            np.concatenate(lead_list) if lead_list else np.zeros(0, dtype=np.int32)
        )
    rep_offsets = np.zeros(len(offsets), dtype=np.int64)
    np.cumsum(counts, out=rep_offsets[1:])
    return frames[leaders], rep_offsets


def extract_reps(phashes: "list[bytes]", radius_cap: int = RADIUS_CAP) -> "list[bytes]":
    """Per-video representative blobs (packed, subset of each video's frames).

    Empty hashes stay empty (they match nothing, including themselves).
    """
    counts = np.asarray([len(b) // BYTES for b in phashes], dtype=np.int64)
    offsets = np.zeros(len(phashes) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    if len(phashes) == 0 or offsets[-1] == 0:
        return [b"" for _ in phashes]
    frames = np.frombuffer(b"".join(phashes), dtype=np.uint8).reshape(-1, BYTES)
    rep_frames, rep_offsets = extract_reps_arrays(frames, offsets, radius_cap)
    return [
        rep_frames[rep_offsets[v] : rep_offsets[v + 1]].tobytes()
        for v in range(len(phashes))
    ]
