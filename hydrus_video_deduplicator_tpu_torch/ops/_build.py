"""Builds and loads the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into a shared
library of its own with a plain C interface, which ``ctypes`` loads. Each
library lands in ``build_dir()`` (``csrc/build/`` unless ``set_build_dir``
chose another directory) under a name keyed on a hash of its source, of
every ``csrc`` header it includes (``#include "..."``, followed
recursively) and of its compiler flags, so an edited source or header
builds anew and a checkout builds on its first call. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the directory set_build_dir() chose; None keeps default_build_dir()
_build_dir: Path | None = None

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_ptr = ctypes.c_void_p
_int = ctypes.c_int

#: library name -> (extra nvcc flags, {C function: argtypes}); every
#: function returns an int (a cudaError_t, 0 on success). The PDQ filter
#: is bit-exact only if no multiply and add contract into an FMA.
KERNELS: dict[str, tuple[list[str], dict[str, list]]] = {
    "exists_mask_sweep": (
        [],
        {"hvd_exists_mask_sweep": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _ptr]},
    ),
    "pair_verify": (
        [],
        {"hvd_pair_verify": [_ptr, _ptr, _ptr, _int, _ptr]},
    ),
    "pdq_filter": (
        ["--fmad=false"],
        {"hvd_pdq_filter": [_ptr, _ptr, _ptr, _int, _ptr]},
    ),
    "similarity_segments": (
        [],
        {"hvd_similarity_segments": [_ptr] * 8 + [_int] * 5 + [_ptr, _int, _ptr]},
    ),
    "similarity_block": (
        [],
        {"hvd_similarity_block": [_ptr] * 5 + [_int] * 4 + [_ptr]},
    ),
}


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def cuda_tool(name: str) -> str:
    """Path of the CUDA toolkit's program ``name`` (nvcc, cuobjdump):
    on PATH, else under $CUDA_HOME, $CUDA_PATH or /usr/local/cuda."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / name
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to build csrc/*.cu")


def default_build_dir() -> Path:
    """``csrc/build/`` beside the sources."""
    return CSRC / "build"


def build_dir() -> Path:
    """The directory the kernel libraries are built into and loaded from."""
    return _build_dir or default_build_dir()


def set_build_dir(path: Path | None) -> None:
    """Build and load the kernel libraries in ``path`` from now on (None:
    ``default_build_dir()``). It moves only where a library is stored."""
    global _build_dir
    _build_dir = None if path is None else Path(path)


def is_writable(path: Path) -> bool:
    """Whether directory ``path`` exists or can be created, and a file can
    be written in it."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            return True
    except OSError:
        return False


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes, found
    beside the including file and followed recursively, each once.

    Raises FileNotFoundError for a missing file: nvcc would fail on it, and
    the library's name would no longer name its sources."""
    found: list[Path] = []
    todo = [(CSRC / f"{name}.cu", None)]
    while todo:
        path, included_by = todo.pop(0)
        if path in found:
            continue
        if not path.is_file():
            where = f", included by {included_by}" if included_by else ""
            raise FileNotFoundError(f"kernel source {path} is missing{where}")
        found.append(path)
        todo += [(path.parent / inc.decode(), path) for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def nvcc_flags(name: str) -> list[str]:
    """The nvcc flags of kernel library ``name``: the command's and the
    digest's, so the two cannot drift apart."""
    return [*NVCC_FLAGS, *KERNELS[name][0]]


def library_name(name: str) -> str:
    """File name of kernel library ``name``: keyed on its sources (the .cu
    and its headers) and its nvcc flags."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(nvcc_flags(name)).encode())
    return f"libhvd_{name}_{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Path of kernel library ``name``, compiling ``csrc/<name>.cu`` first
    when absent.

    Raises with the compiler's output when nvcc is missing or fails, and
    when ``build_dir()`` cannot be created or written (a read-only
    install, unless ``set_build_dir`` chose another directory). The
    compiler's report (registers, shared memory, spills from -Xptxas=-v)
    is kept beside the library as ``<library>.log``.
    """
    source = CSRC / f"{name}.cu"
    so = build_dir() / library_name(name)
    if so.is_file():
        return so
    if not is_writable(so.parent):
        raise RuntimeError(
            f"cannot build {so.name}: the kernel build directory {so.parent} cannot be created"
            " or written. The CLI builds the kernels in <dedup database dir>/.cuda_cache/"
            f" where {default_build_dir()} cannot be written; outside it, call"
            " ops._build.set_build_dir() with a writable directory"
        )
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cuda_tool("nvcc"), *nvcc_flags(name), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    so.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def check_same_device(out, **inputs) -> None:
    """Raise ValueError, before a launch, for any input tensor (by keyword
    name) on another device than the launch's output ``out``: the C
    interfaces take raw pointers, and ``ctypes`` would pass one from
    another card unchecked."""
    for name, t in inputs.items():
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, the output on {out.device}")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, with every C signature declared."""
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in KERNELS[name][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_void_p
    return lib
