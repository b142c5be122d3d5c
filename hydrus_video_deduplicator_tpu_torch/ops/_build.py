"""Builds and loads the port's CUDA kernels.

``nvcc`` compiles ``csrc/exists_mask_sweep.cu`` for sm_90a into a shared
library with a plain C interface, which ``ctypes`` loads. The library lands
in ``csrc/build/`` under a name keyed on a hash of the source, so an edited
source builds anew and a checkout builds on its first call. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "exists_mask_sweep.cu"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build csrc/*.cu")


def library_path() -> Path:
    """Path of the built library, compiling it first when absent.

    Raises with the compiler's output when nvcc is missing or fails. The
    compiler's report (registers, shared memory, spills from -Xptxas=-v)
    is kept beside the library as ``<name>.log``.
    """
    key = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libhvd_exists_mask_sweep_{key}.so"
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    so.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, with every C signature declared."""
    lib = ctypes.CDLL(str(library_path()))
    ptr = ctypes.c_void_p
    lib.hvd_exists_mask_sweep.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
    ]
    lib.hvd_exists_mask_sweep.restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_void_p
    return lib
