"""ctypes loader for the native PDQ/VPDQ library (libhvdaccel.so).

The library is built on demand with ``make`` (g++) the first time it is
needed, into ``native/build/``; the build is a single translation unit and
takes ~1 s. A wheel ships it prebuilt there (``setup.py``), and the loader
takes that copy where ``make`` cannot run or ``build/`` cannot be written.
If neither works the framework transparently falls back to the numpy
oracle (slower, bit-identical results).

Builds are safe across processes (``make_library``): pytest-xdist workers,
or several programs started together on a fresh checkout, take turns on a
file lock, and each library is built to a temporary name and moved into
place, so no process ever loads half a file.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("native")

_DIR = Path(__file__).parent
BUILD_DIR = _DIR / "build"
_SONAME = BUILD_DIR / "libhvdaccel.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def make_library(name: str, variable: str) -> bool:
    """Bring ``build/<name>`` up to date with the Makefile's rule for it.

    ``variable`` is the Makefile variable that names the library (SONAME
    or DECODE_SONAME). Under an exclusive lock on ``build/.lock``: when
    ``make -q`` finds the library newer than its sources nothing runs;
    otherwise make builds it under a temporary name that ``os.replace``
    moves into place. False (with the compiler's output logged) when the
    build fails, ``make`` cannot run or ``build/`` cannot be created or
    written: the caller then loads what ``build/`` holds, if anything.
    """
    target = Path(BUILD_DIR.name) / name  # relative to the Makefile
    tmp = target.with_name(f"{name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            fresh = subprocess.run(
                ["make", "-q", f"{variable}={target}", str(target)],
                cwd=_DIR, capture_output=True, timeout=60,
            )
            if fresh.returncode == 0:
                return True
            proc = subprocess.run(
                ["make", "-s", f"{variable}={tmp}", str(tmp)],
                cwd=_DIR, capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                (_DIR / tmp).unlink(missing_ok=True)
                log.warning("native build of %s failed:\n%s\n%s", name, proc.stdout, proc.stderr)
                return False
            os.replace(_DIR / tmp, _DIR / target)
            return True
    except (OSError, subprocess.TimeoutExpired) as exc:
        with contextlib.suppress(OSError):  # build/ may not exist or be writable
            (_DIR / tmp).unlink()
        log.warning("native build of %s failed: %s", name, exc)
        return False


def _build() -> bool:
    return make_library(_SONAME.name, "SONAME")


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.hvd_abi_version.restype = ctypes.c_int
    lib.hvd_pdq_hash_frame.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, i32p]
    lib.hvd_pdq_hash_frame_debug.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, i32p, f32p, f32p]
    lib.hvd_pdq_hash_frames.argtypes = [u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, u8p, i32p]
    lib.hvd_match_hash_bytes.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, ctypes.c_int]
    lib.hvd_match_hash_bytes.restype = ctypes.c_double
    lib.hvd_hamming_matrix.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, i32p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hvd_cluster_reps.argtypes = [u8p, ctypes.c_long, ctypes.c_int, i32p]
    lib.hvd_cluster_reps.restype = ctypes.c_long
    lib.hvd_cluster_reps_batch.argtypes = [
        u8p, i64p, ctypes.c_long, ctypes.c_int, i32p, i32p,
    ]
    lib.hvd_hasher_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hvd_hasher_create.restype = ctypes.c_void_p
    lib.hvd_hasher_push.argtypes = [ctypes.c_void_p, u8p]
    lib.hvd_hasher_finish.argtypes = [ctypes.c_void_p]
    lib.hvd_hasher_finish.restype = ctypes.c_long
    lib.hvd_hasher_copy.argtypes = [ctypes.c_void_p, u8p]
    lib.hvd_hasher_destroy.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None on failure."""
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
            if lib.hvd_abi_version() != 1:
                raise OSError("ABI version mismatch")
            _lib = lib
        except OSError as exc:
            log.error("failed to load %s: %s", _SONAME, exc)
            _load_failed = True
            return None
    return _lib


def is_available() -> bool:
    return get_lib() is not None


def _u8p(buf) -> "ctypes.POINTER(ctypes.c_uint8)":
    return ctypes.cast(ctypes.c_char_p(bytes(buf)), ctypes.POINTER(ctypes.c_uint8))


def pdq_hash_frame(rgb: bytes, w: int, h: int) -> tuple[bytes, int]:
    """Hash one interleaved rgb24 frame -> (32-byte hash, quality)."""
    lib = get_lib()
    assert lib is not None
    out = (ctypes.c_uint8 * 32)()
    q = ctypes.c_int32(0)
    lib.hvd_pdq_hash_frame(_u8p(rgb), w, h, out, ctypes.byref(q))
    return bytes(out), q.value


def pdq_hash_frames(rgb_batch: bytes, n: int, w: int, h: int) -> tuple[bytes, list[int]]:
    """Hash a batch of n frames (concatenated rgb24) single-threaded."""
    lib = get_lib()
    assert lib is not None
    out = (ctypes.c_uint8 * (32 * n))()
    qs = (ctypes.c_int32 * n)()
    lib.hvd_pdq_hash_frames(_u8p(rgb_batch), n, w, h, out, qs)
    return bytes(out), list(qs)


def pdq_hash_frame_debug(rgb: bytes, w: int, h: int):
    """(hash, quality, buf64 [64,64] f32, dct [16,16] f32) for exactness tests."""
    import numpy as np

    lib = get_lib()
    assert lib is not None
    out = (ctypes.c_uint8 * 32)()
    q = ctypes.c_int32(0)
    buf64 = np.zeros((64, 64), dtype=np.float32)
    dct = np.zeros((16, 16), dtype=np.float32)
    lib.hvd_pdq_hash_frame_debug(
        _u8p(rgb), w, h, out, ctypes.byref(q),
        buf64.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dct.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return bytes(out), q.value, buf64, dct


def match_hash_bytes(a: bytes, b: bytes, tolerance: int = 31) -> float:
    lib = get_lib()
    assert lib is not None
    return float(
        lib.hvd_match_hash_bytes(_u8p(a), len(a), _u8p(b), len(b), int(tolerance))
    )


def cluster_reps_batch(blob_all, offsets, radius_cap: int):
    """Greedy leader clustering over a whole corpus in one call.

    blob_all: every video's packed frames concatenated; offsets: int64
    [n_videos+1] frame offsets delimiting each video. Returns
    (leaders [total_k] int32 global frame indices, counts [n_videos]
    int32). Invariant: every frame is within radius_cap Hamming of its
    video's leader frame — the exactness contract of ops/reps.py.
    """
    import numpy as np

    lib = get_lib()
    assert lib is not None
    if isinstance(blob_all, np.ndarray):  # zero-copy for corpus-scale arrays
        blob_p = np.ascontiguousarray(blob_all, dtype=np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)
        )
    else:
        blob_p = _u8p(blob_all)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_videos = len(offsets) - 1
    n_frames = int(offsets[-1])
    leaders = np.zeros(max(n_frames, 1), dtype=np.int32)
    counts = np.zeros(max(n_videos, 1), dtype=np.int32)
    if n_videos:
        lib.hvd_cluster_reps_batch(
            blob_p,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_videos,
            int(radius_cap),
            leaders.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    total = int(counts.sum())
    return leaders[:total].copy(), counts[:n_videos]


def hamming_matrix(a: bytes, b: bytes):
    """All-pairs frame Hamming distances over two packed blobs -> [na,nb] int32."""
    import numpy as np

    lib = get_lib()
    assert lib is not None
    na, nb = len(a) // 32, len(b) // 32
    out = np.zeros((na, nb), dtype=np.int32)
    lib.hvd_hamming_matrix(
        _u8p(a), na, _u8p(b), nb, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    return out


class NativeVideoHasher:
    """Threaded streaming hasher (bounded queue, in-order results)."""

    def __init__(self, width: int, height: int, num_threads: int = 0, quality_min: int = 31):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._w, self._h = width, height
        self._handle = lib.hvd_hasher_create(width, height, num_threads, quality_min)

    def push_frame(self, rgb: bytes) -> None:
        self._lib.hvd_hasher_push(self._handle, _u8p(rgb))

    def finish(self) -> bytes:
        n = self._lib.hvd_hasher_finish(self._handle)
        out = (ctypes.c_uint8 * n)()
        if n:
            self._lib.hvd_hasher_copy(self._handle, out)
        return bytes(out)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.hvd_hasher_destroy(self._handle)
            self._handle = None
