"""VPDQ perceptual-hash subsystem: value type, oracle, and dispatching API.

API parity with the reference's native ``hvdaccelerators.vpdq`` module
(observable surface documented in SURVEY.md §2.1; call sites:
upstream src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py:49-119,
dedup.py:77-83, hashing.py:30-40, db/vptree.py:28-31):

- :class:`VpdqHash` — packed sequence of 32-byte PDQ frame hashes.
- :class:`VideoHasher` — streaming per-frame hasher with a bounded queue and
  worker threads (C++ native when built, numpy fallback otherwise).
- :func:`matchHash` / :func:`matchHashBytes` — similarity in [0, 100].
"""

from __future__ import annotations

from . import pdq_math
from .pdq_math import BYTES_PER_HASH, DEFAULT_DISTANCE_TOLERANCE


class VpdqHash:
    """A video perceptual hash: N concatenated 32-byte PDQ frame hashes.

    Mirrors the reference native type's surface: ``.bytes``,
    ``bytesPerPdqHash``, ``from_string`` / ``str()`` hex round-trip,
    ``==``, and ``len()`` = frame count.
    """

    bytesPerPdqHash = BYTES_PER_HASH

    __slots__ = ("_data",)

    def __init__(self, data: bytes = b""):
        data = bytes(data)
        if len(data) % self.bytesPerPdqHash != 0:
            raise ValueError(
                f"VpdqHash length {len(data)} is not a multiple of {self.bytesPerPdqHash}"
            )
        self._data = data

    @property
    def bytes(self) -> bytes:
        return self._data

    @classmethod
    def from_string(cls, s: str) -> "VpdqHash":
        s = s.strip()
        return cls(bytes.fromhex(s))

    def __str__(self) -> str:
        return self._data.hex()

    def __repr__(self) -> str:
        return f"VpdqHash({len(self)} frames)"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, VpdqHash):
            return self._data == other._data
        if isinstance(other, (bytes, bytearray)):
            return self._data == bytes(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._data)

    def __len__(self) -> int:
        return len(self._data) // self.bytesPerPdqHash

    def frame_hashes(self) -> list[bytes]:
        k = self.bytesPerPdqHash
        return [self._data[i : i + k] for i in range(0, len(self._data), k)]


def matchHashBytes(a: bytes, b: bytes, tolerance: int = DEFAULT_DISTANCE_TOLERANCE) -> float:
    """Similarity in [0, 100] over raw packed blobs (VP-tree distance input).

    Uses the C++ native implementation when available, numpy otherwise.
    """
    from .. import native

    if native.is_available():
        return native.match_hash_bytes(a, b, tolerance)
    from . import python_ref

    return python_ref.match_hash_bytes(a, b, tolerance)


def matchHash(
    query: VpdqHash, target: VpdqHash, distance_tolerance: int = DEFAULT_DISTANCE_TOLERANCE
) -> float:
    """Similarity in [0, 100] of two video hashes (see matchHashBytes)."""
    return matchHashBytes(query.bytes, target.bytes, distance_tolerance)


class VideoHasher:
    """Streaming video hasher: push pre-scaled 512x512 rgb24 frames, collect a VpdqHash.

    Same constructor/usage contract as the reference native hasher
    (vpdqpy.py:113-119): ``hash_frame`` blocks when the internal queue is
    full (decode->hash backpressure), ``finish`` drops frames with PDQ
    quality < 31 and returns the packed hash. ``average_fps`` only feeds
    discarded timestamps in the reference and is accepted for parity.
    """

    def __init__(self, average_fps: int = 1, width: int = pdq_math.FRAME_DIM,
                 height: int = pdq_math.FRAME_DIM, num_threads: int = 0):
        from .. import native

        self.width = width
        self.height = height
        self._impl = None
        if native.is_available():
            self._impl = native.NativeVideoHasher(width, height, num_threads)
        else:
            self._frames: list[bytes] = []

    def hash_frame(self, frame_bytes: bytes) -> None:
        expected = self.width * self.height * 3
        if len(frame_bytes) != expected:
            raise ValueError(f"frame byte length {len(frame_bytes)} != {expected}")
        if self._impl is not None:
            self._impl.push_frame(frame_bytes)
        else:
            self._frames.append(bytes(frame_bytes))

    def finish(self) -> VpdqHash:
        if self._impl is not None:
            return VpdqHash(self._impl.finish())
        import numpy as np

        from . import python_ref

        frames = [
            np.frombuffer(f, dtype=np.uint8).reshape(self.height, self.width, 3)
            for f in self._frames
        ]
        self._frames = []
        return VpdqHash(python_ref.vpdq_hash_frames(frames))


__all__ = [
    "VpdqHash",
    "VideoHasher",
    "matchHash",
    "matchHashBytes",
    "pdq_math",
    "BYTES_PER_HASH",
    "DEFAULT_DISTANCE_TOLERANCE",
]
