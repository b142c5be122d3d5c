"""Hashing facade — the same thin API the reference exposes.

Reference: upstream src/hydrusvideodeduplicator/hashing.py (compute_phash,
encode_phash_to_str, decode_phash_from_str, get_phash_similarity).
"""

from __future__ import annotations

from pathlib import Path

from .decode import extract_frames
from .vpdq import VideoHasher, VpdqHash, matchHash
from .vpdq import pdq_math as pm


def compute_phash(
    video: Path | str | bytes, num_threads: int = 0, sampling: str = "uniform"
) -> VpdqHash:
    """Perceptually hash a video (path or raw bytes) -> VpdqHash.

    Streams decoded 1 fps-sampled 512x512 frames through the threaded native
    hasher (bounded queue backpressure), mirroring the reference's
    Vpdq.computeHash (vpdqpy.py:104-119). sampling="scene" is the opt-in
    shot-boundary mode (see decode.extract_frames).
    """
    hasher = VideoHasher(1, pm.FRAME_DIM, pm.FRAME_DIM, num_threads)
    for frame in extract_frames(video, sampling=sampling):
        hasher.hash_frame(frame.tobytes())
    return hasher.finish()


def encode_phash_to_str(phash: VpdqHash) -> str:
    """Hex-encode a perceptual hash."""
    return str(phash)


def decode_phash_from_str(phash_str: str) -> VpdqHash:
    """Decode a hex-encoded perceptual hash."""
    return VpdqHash.from_string(phash_str)


def get_phash_similarity(hash_a: VpdqHash, hash_b: VpdqHash) -> float:
    """Similarity of two video hashes in [0, 100]."""
    similarity = matchHash(hash_a, hash_b)
    assert 0.0 <= similarity <= 100.0
    return similarity
