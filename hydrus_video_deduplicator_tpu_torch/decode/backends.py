"""Decode backends: native libav (default), OpenCV, Pillow, YUV4MPEG2.

Each backend's ``decode(data, src_path)`` yields ``(rgb_frame, average_fps)``
tuples. For most backends rgb_frame is [H, W, 3] uint8 at native resolution
and the caller samples + rescales; the libav backend instead emits frames
already sampled and rescaled to 512x512 (``emits_sampled_512 = True``) —
exactly the reference's PyAV pipeline (vpdqpy.py:59-101), since it calls the
same libavformat/libavcodec/libswscale the reference's PyAV wraps (see
native/decode.cpp for the semantics contract). Bad frames mid-stream are
tolerated (vpdqpy.py:99-101); streams with no frames raise DecodeError at
the caller.

Backend selection (``HVD_DECODE_BACKEND`` env var or the ``decode_backend``
argument):
  - ``auto`` (default): libav for everything it can open — the reference
    routes every format through PyAV/ffmpeg — with two exceptions: animated
    webp goes to Pillow (libavcodec cannot decode webp animation), and
    anything libav fails to open falls back to the legacy content-sniffed
    chain.
  - ``libav``: libav only, no fallback.
  - ``legacy``: the round-1 content-sniffed chain (y4m/Pillow/OpenCV).
"""

from __future__ import annotations

import io
import logging
import os
import tempfile
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from .frames import DecodeError

log = logging.getLogger("decode")

DECODE_BACKEND_ENV = "HVD_DECODE_BACKEND"
DECODE_BACKEND_MODES = ("auto", "libav", "legacy")


class Backend:
    name = "base"
    #: True when decode() yields frames already sampled (1 fps rule) and
    #: rescaled to [512, 512, 3]; the caller skips its own sample/rescale.
    emits_sampled_512 = False

    def decode(self, data: bytes, src_path: Path | None) -> Iterator[tuple[np.ndarray, float | None]]:
        raise NotImplementedError


class LibavBackend(Backend):
    """Reference decode path: libavformat/avcodec/swscale via native/decode.cpp.

    Emits sampled, SWS_POINT-rescaled 512x512 rgb24 frames — the same bytes
    PyAV's frame.reformat produces in the reference (vpdqpy.py:86-96).
    """

    name = "libav"
    emits_sampled_512 = True

    def decode(self, data, src_path):
        from ..native import decode as nd

        try:
            dec = nd.LibavDecoder(data)
        except nd.LibavDecodeError as exc:
            raise DecodeError(f"libav could not open stream: {exc}") from exc
        with dec:
            rate = dec.average_rate
            fps = float(rate) if rate is not None else None
            try:
                for frame in dec:
                    yield frame, fps
            except nd.LibavDecodeError as exc:
                raise DecodeError(f"libav decode error: {exc}") from exc


def libav_available() -> bool:
    from ..native import decode as nd

    return nd.is_available()


class PillowBackend(Backend):
    """Animated images: gif, apng, webp (and single-frame images)."""

    name = "pillow"

    def decode(self, data, src_path):
        from PIL import Image, UnidentifiedImageError

        try:
            img = Image.open(io.BytesIO(data))
        except UnidentifiedImageError as exc:
            raise DecodeError(f"Pillow could not open stream: {exc}") from exc

        # truncated/corrupt animations can raise OSError anywhere in the
        # metadata scan (n_frames forces a full-stream parse)
        try:
            n_frames = getattr(img, "n_frames", 1)
        except (OSError, SyntaxError) as exc:
            raise DecodeError(f"Pillow could not parse animation: {exc}") from exc
        # average fps from per-frame durations (ms); missing/zero -> unknown
        total_ms = 0.0
        try:
            for i in range(n_frames):
                img.seek(i)
                total_ms += float(img.info.get("duration", 0) or 0)
        except (EOFError, OSError, SyntaxError):
            pass
        fps = (1000.0 * n_frames / total_ms) if total_ms > 0 else None

        for i in range(n_frames):
            try:
                img.seek(i)
                frame = np.asarray(img.convert("RGB"), dtype=np.uint8)
            except EOFError:
                break
            except OSError as exc:  # truncated/corrupt frame: skip like the reference
                log.warning("skipping bad frame %d: %s", i, exc)
                continue
            yield frame, fps


class Y4MBackend(Backend):
    """YUV4MPEG2 parser (fully deterministic, used for golden corpora).

    Supports C420 (JPEG chroma siting), C444 and Cmono. BT.601 full-range
    YUV -> RGB with exact integer rounding so every platform decodes
    identical pixels.
    """

    name = "y4m"

    def decode(self, data, src_path):
        if not data.startswith(b"YUV4MPEG2"):
            raise DecodeError("not a y4m stream")
        header_end = data.index(b"\n")
        header = data[:header_end].decode("ascii", "replace").split(" ")
        width = height = None
        fps = None
        colorspace = "420"
        for tok in header[1:]:
            if tok.startswith("W"):
                width = int(tok[1:])
            elif tok.startswith("H"):
                height = int(tok[1:])
            elif tok.startswith("F"):
                num, den = tok[1:].split(":")
                fps = int(num) / int(den) if int(den) else None
            elif tok.startswith("C"):
                colorspace = tok[1:]
        if not width or not height:
            raise DecodeError("y4m missing dimensions")

        if colorspace.startswith("420"):
            frame_len = width * height * 3 // 2
        elif colorspace.startswith("444"):
            frame_len = width * height * 3
        elif colorspace.startswith("mono"):
            frame_len = width * height
        else:
            raise DecodeError(f"unsupported y4m colorspace {colorspace}")

        pos = header_end + 1
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0 or not data[pos:nl].startswith(b"FRAME"):
                break
            start = nl + 1
            chunk = data[start : start + frame_len]
            if len(chunk) < frame_len:
                break
            yield self._to_rgb(chunk, width, height, colorspace), fps
            pos = start + frame_len

    @staticmethod
    def _to_rgb(chunk: bytes, w: int, h: int, colorspace: str) -> np.ndarray:
        buf = np.frombuffer(chunk, dtype=np.uint8)
        if colorspace.startswith("mono"):
            y = buf.reshape(h, w)
            return np.repeat(y[:, :, None], 3, axis=2)
        y = buf[: w * h].reshape(h, w).astype(np.int32)
        if colorspace.startswith("420"):
            cw, ch = w // 2, h // 2
            u = buf[w * h : w * h + cw * ch].reshape(ch, cw)
            v = buf[w * h + cw * ch :].reshape(ch, cw)
            u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(np.int32)
            v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(np.int32)
        else:  # 444
            u = buf[w * h : 2 * w * h].reshape(h, w).astype(np.int32)
            v = buf[2 * w * h :].reshape(h, w).astype(np.int32)
        # BT.601 full-range, fixed-point (x1000) with round-half-up: exact and
        # platform-independent.
        cu, cv = u - 128, v - 128
        r = y * 1000 + 1402 * cv
        g = y * 1000 - 344 * cu - 714 * cv
        b = y * 1000 + 1772 * cu
        rgb = np.stack([r, g, b], axis=-1)
        rgb = (rgb + 500) // 1000
        return np.clip(rgb, 0, 255).astype(np.uint8)


class OpenCVBackend(Backend):
    """Container formats via OpenCV's bundled ffmpeg (mp4, avi, mkv, ...)."""

    name = "opencv"

    def decode(self, data, src_path):
        try:
            import cv2
        except ImportError as exc:  # pragma: no cover - cv2 is present in CI
            raise DecodeError(f"OpenCV unavailable: {exc}") from exc

        # cv2.VideoCapture needs a file path; spill bytes if needed.
        tmp_path = None
        if src_path is not None and src_path.is_file():
            path = str(src_path)
        else:
            fd, tmp_path = tempfile.mkstemp(suffix=".video")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            path = tmp_path
        try:
            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise DecodeError("OpenCV could not open video stream")
            fps = cap.get(cv2.CAP_PROP_FPS)
            if not fps or fps != fps or fps <= 0:
                fps = None
            while True:
                ok, frame_bgr = cap.read()
                if not ok:
                    break
                yield frame_bgr[:, :, ::-1], fps  # BGR -> RGB
            cap.release()
        finally:
            if tmp_path is not None:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass


_PILLOW_MAGICS = (b"GIF87a", b"GIF89a", b"\x89PNG")


def _is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def choose_legacy_backend(data: bytes) -> Backend:
    """The round-1 content-sniffed chain (no libav)."""
    if data.startswith(b"YUV4MPEG2"):
        return Y4MBackend()
    if data.startswith(_PILLOW_MAGICS):
        return PillowBackend()
    if _is_webp(data):
        return PillowBackend()
    return OpenCVBackend()


def choose_backend(data: bytes, mode: str | None = None) -> Backend:
    """Pick a decode backend (see module docstring for the mode semantics)."""
    if mode is None:
        mode = os.environ.get(DECODE_BACKEND_ENV, "auto") or "auto"
    if mode not in DECODE_BACKEND_MODES:
        raise DecodeError(f"unknown decode backend mode: {mode!r}")
    if mode == "libav":
        return LibavBackend()
    if mode == "auto" and libav_available() and not _is_webp(data):
        return LibavBackend()
    return choose_legacy_backend(data)
