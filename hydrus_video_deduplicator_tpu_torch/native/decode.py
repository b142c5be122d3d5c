"""ctypes loader + wrappers for the native libav decode module (libhvdecode.so).

The module reproduces the reference's PyAV decode path (vpdqpy.py:59-101)
with direct libavformat/libavcodec/libswscale calls — see decode.cpp for the
semantics contract. Built on demand with ``make decode``; when the FFmpeg
dev libraries are unavailable the framework falls back to the OpenCV/Pillow
backends (decode/backends.py). The build goes into ``native/build/``, safe
across processes (``native.make_library``).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from fractions import Fraction
from pathlib import Path

import numpy as np

from . import BUILD_DIR, make_library

log = logging.getLogger("native.decode")

_SONAME = BUILD_DIR / "libhvdecode.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False

FRAME_BYTES = 512 * 512 * 3


def _build() -> bool:
    return make_library(_SONAME.name, "DECODE_SONAME")


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hvdd_abi_version.restype = ctypes.c_int
    lib.hvdd_round_rate.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.hvdd_round_rate.restype = ctypes.c_int64
    lib.hvdd_open.argtypes = [u8p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    lib.hvdd_open.restype = ctypes.c_void_p
    lib.hvdd_avg_rate.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.hvdd_step.argtypes = [ctypes.c_void_p]
    lib.hvdd_step.restype = ctypes.c_int
    lib.hvdd_frames_seen.argtypes = [ctypes.c_void_p]
    lib.hvdd_frames_seen.restype = ctypes.c_int64
    lib.hvdd_frames_sampled.argtypes = [ctypes.c_void_p]
    lib.hvdd_frames_sampled.restype = ctypes.c_int64
    lib.hvdd_errmsg.argtypes = [ctypes.c_void_p]
    lib.hvdd_errmsg.restype = ctypes.c_char_p
    lib.hvdd_next.argtypes = [ctypes.c_void_p, u8p]
    lib.hvdd_next.restype = ctypes.c_int
    lib.hvdd_close.argtypes = [ctypes.c_void_p]
    lib.hvdd_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.hvdd_encode.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        # always invoke make (a no-op when up to date): an existing .so
        # built from older sources must be rebuilt, not loaded silently
        if not _build() and not _SONAME.exists():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_SONAME))
            _declare(lib)
            if lib.hvdd_abi_version() != 1:
                raise OSError("decode ABI version mismatch")
            _lib = lib
        except OSError as exc:
            log.warning("failed to load %s: %s", _SONAME, exc)
            _load_failed = True
            return None
    return _lib


def is_available() -> bool:
    return get_lib() is not None


def round_rate(num: int, den: int) -> int:
    """Python round() on the exact rational (test hook for the C impl)."""
    lib = get_lib()
    assert lib is not None
    return int(lib.hvdd_round_rate(num, den))


class LibavDecodeError(Exception):
    pass


class LibavDecoder:
    """Iterates the sampled, 512x512 rgb24 frames of a video held in memory.

    One instance = one pass over the stream (like the reference's decode
    generator). Use as a context manager or rely on __del__.
    """

    def __init__(self, data: bytes):
        lib = get_lib()
        if lib is None:
            raise LibavDecodeError("native decode library unavailable")
        self._lib = lib
        errbuf = ctypes.create_string_buffer(512)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._handle = lib.hvdd_open(buf, len(data), errbuf, len(errbuf))
        if not self._handle:
            raise LibavDecodeError(errbuf.value.decode("utf-8", "replace"))

    def _live_handle(self):
        """The open handle; raising beats handing the C side a NULL."""
        handle = getattr(self, "_handle", None)
        if not handle:
            raise LibavDecodeError("decoder is closed")
        return handle

    @property
    def average_rate(self) -> Fraction | None:
        """The stream's avg_frame_rate (None when unknown, like PyAV)."""
        num = ctypes.c_int64(0)
        den = ctypes.c_int64(0)
        self._lib.hvdd_avg_rate(self._live_handle(), ctypes.byref(num), ctypes.byref(den))
        if num.value <= 0 or den.value <= 0:
            return None
        return Fraction(num.value, den.value)

    @property
    def step(self) -> int:
        return int(self._lib.hvdd_step(self._live_handle()))

    @property
    def frames_seen(self) -> int:
        return int(self._lib.hvdd_frames_seen(self._live_handle()))

    def __iter__(self):
        out = np.empty((512, 512, 3), dtype=np.uint8)
        u8p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            ret = self._lib.hvdd_next(self._live_handle(), u8p)
            if ret == 0:
                return
            if ret < 0:
                msg = self._lib.hvdd_errmsg(self._live_handle())
                raise LibavDecodeError(msg.decode("utf-8", "replace") if msg else "decode error")
            yield out.copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hvdd_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def encode_video(
    path: str | Path,
    codec: str,
    frames: "np.ndarray | list[np.ndarray]",
    fps_num: int = 5,
    fps_den: int = 1,
    pts_ms: list[int] | None = None,
    gop_size: int = 0,
    max_b_frames: int = -1,
) -> None:
    """Encode [N, H, W, 3] uint8 rgb frames (corpus generation only).

    gop_size > 0 / max_b_frames >= 0 override the encoder defaults —
    long-GOP B-frame-heavy streams exercise reordered decode."""
    lib = get_lib()
    if lib is None:
        raise LibavDecodeError("native decode library unavailable")
    arr = np.ascontiguousarray(np.stack(list(frames)).astype(np.uint8))
    n, h, w, _ = arr.shape
    if pts_ms is not None and len(pts_ms) != n:
        raise ValueError(f"pts_ms has {len(pts_ms)} entries for {n} frames")
    pts = (ctypes.c_int64 * n)(*pts_ms) if pts_ms is not None else None
    errbuf = ctypes.create_string_buffer(512)
    ret = lib.hvdd_encode(
        str(path).encode(), codec.encode(), w, h, fps_num, fps_den,
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, pts,
        int(gop_size), int(max_b_frames),
        errbuf, len(errbuf),
    )
    if ret != 0:
        raise LibavDecodeError(errbuf.value.decode("utf-8", "replace"))
