"""Frame extraction and sampling (backend-independent logic)."""

from __future__ import annotations

import os
from collections.abc import Iterator
from fractions import Fraction
from pathlib import Path

import numpy as np

from ..vpdq import pdq_math as pm


class DecodeError(Exception):
    """Raised when a video cannot be decoded (no stream, corrupt data, ...)."""


def resize_nearest_512(img: np.ndarray) -> np.ndarray:
    """Nearest-neighbor rescale of [H, W, 3] uint8 to [512, 512, 3].

    Center-based sampling: src index = floor((i + 0.5) * src / 512). This is
    the deterministic, backend-independent replacement for the reference's
    swscale POINT rescale (vpdqpy.py:90-95); all our hash implementations see
    identical pixels regardless of the decode backend.
    """
    h, w = img.shape[:2]
    if (h, w) == (pm.FRAME_DIM, pm.FRAME_DIM):
        return np.ascontiguousarray(img)
    n = pm.FRAME_DIM
    ri = ((2 * np.arange(n) + 1) * h) // (2 * n)
    ci = ((2 * np.arange(n) + 1) * w) // (2 * n)
    return np.ascontiguousarray(img[ri][:, ci])


def effective_sample_step(average_fps: float | Fraction | None) -> int:
    """The reference's sampling rule (vpdqpy.py:71-77): hash frames where
    frame_index % round(average_fps) == 0; unknown or sub-1 fps -> every
    frame (step 1). Python round() (banker's) matches the reference."""
    if average_fps is None:
        return 1
    try:
        if average_fps != average_fps or average_fps < 1:  # NaN or < 1
            return 1
    except TypeError:
        return 1
    return max(1, round(average_fps))


def sample_indices(n_frames: int, average_fps: float | None) -> list[int]:
    """Which frame indices of an n-frame stream get hashed."""
    step = effective_sample_step(average_fps)
    return list(range(0, n_frames, step))


#: scene sampling: keep a frame when its mean abs luma diff (on an 8x
#: decimated grid, 0-255 scale) vs the last kept frame exceeds this.
SCENE_DIFF_THRESHOLD = 12.0


def _scene_signature(frame512: np.ndarray) -> np.ndarray:
    """Cheap [64, 64] int16 luma signature for scene-change detection."""
    small = frame512[4::8, 4::8]
    return (
        small[:, :, 0].astype(np.int16)
        + 2 * small[:, :, 1].astype(np.int16)
        + small[:, :, 2].astype(np.int16)
    ) >> 2


def extract_frames(
    video: bytes | str | Path,
    sampling: str = "uniform",
    scene_threshold: float = SCENE_DIFF_THRESHOLD,
    decode_backend: str | None = None,
) -> Iterator[np.ndarray]:
    """Decode + sample + rescale: yields [512, 512, 3] uint8 rgb frames.

    Accepts raw bytes or a filesystem path, mirroring the reference's
    "bytes in, frames out" contract (vpdqpy.py:59, 104-119). By default the
    native libav backend decodes, samples, and rescales exactly like the
    reference's PyAV path; other formats/environments fall back to the
    legacy content-sniffed chain (see backends module docstring).

    sampling:
      - "uniform" (default, reference parity): ~1 frame/sec via the
        round(average_fps) stride.
      - "scene": among the 1 fps candidates, keep a frame only when it
        differs visually from the last kept frame (mean abs luma diff on a
        decimated grid > scene_threshold). The first candidate is always
        kept, so every video that hashes under "uniform" also hashes here.
        Opt-in (changes hashes' frame sets; don't mix modes in one DB).

    decode_backend: "auto" | "libav" | "legacy" (default: HVD_DECODE_BACKEND
    env var, else "auto").
    """
    if sampling not in ("uniform", "scene"):
        raise DecodeError(f"unknown sampling mode: {sampling!r}")
    from . import backends

    data: bytes
    src_path: Path | None = None
    if isinstance(video, (str, Path)):
        src_path = Path(video)
        if not src_path.is_file():
            raise DecodeError(f"video does not exist: {src_path}")
        data = src_path.read_bytes()
    elif isinstance(video, (bytes, bytearray)):
        data = bytes(video)
    else:
        raise DecodeError(f"unsupported video source type: {type(video)!r}")

    backend = backends.choose_backend(data, decode_backend)
    stream = _sampled_512_stream(backend, data, src_path)
    if backend.emits_sampled_512:
        # "auto" falls back to the legacy chain when libav cannot open the
        # stream at all (e.g. a format only Pillow handles).
        mode = decode_backend or os.environ.get(backends.DECODE_BACKEND_ENV, "auto") or "auto"
        try:
            first = next(stream, None)
        except DecodeError:
            if mode != "auto":
                raise
            backend = backends.choose_legacy_backend(data)
            stream = _sampled_512_stream(backend, data, src_path)
            first = next(stream, None)
        stream = _chain_first(first, stream)

    last_sig: np.ndarray | None = None
    n = 0
    for frame in stream:
        if sampling == "scene":
            sig = _scene_signature(frame)
            if last_sig is not None:
                diff = float(np.abs(sig - last_sig).mean())
                if diff <= scene_threshold:
                    continue
            last_sig = sig
        n += 1
        yield frame
    if n == 0:
        # the first 1 fps candidate is always kept in scene mode, so n == 0
        # means the stream produced no frames at all in either mode
        raise DecodeError("no decodable frames found")


def _chain_first(first, rest: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
    if first is not None:
        yield first
    yield from rest


def _sampled_512_stream(backend, data: bytes, src_path: Path | None) -> Iterator[np.ndarray]:
    """Uniform 1 fps candidates at 512x512 from any backend."""
    if backend.emits_sampled_512:
        for frame, _fps in backend.decode(data, src_path):
            yield frame
        return
    step_known = False
    step = 1
    index = 0
    got_any = False
    for raw_frame, fps in backend.decode(data, src_path):
        got_any = True
        if not step_known:
            step = effective_sample_step(fps)
            step_known = True
        if index % step == 0:
            yield resize_nearest_512(raw_frame)
        index += 1
    if not got_any:
        raise DecodeError("no decodable frames found")
