"""The kernel build: one library per ``csrc/*.cu``, keyed on its source,
the ``csrc`` headers it includes and its flags, built by ``nvcc`` (a
stand-in script here: this machine has no CUDA toolkit) and moved into
place atomically; and the JAX package's native libraries, built once
before its test modules load them."""

from __future__ import annotations

import fcntl
import os
import shutil
import stat
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from hydrus_video_deduplicator_tpu_torch import entrypoint, native
from hydrus_video_deduplicator_tpu_torch.native import decode as native_decode
from hydrus_video_deduplicator_tpu_torch.ops import _build

JAX_NATIVE = Path(__file__).resolve().parents[1] / "hydrus_video_deduplicator_tpu" / "native"
JAX_NATIVE_TARGETS = ((), ("decode",))


def _build_jax_native() -> dict[str, str]:
    """Run the JAX package's ``make -s`` and ``make -s decode`` under one
    file lock: {target: "" on success, else what went wrong}.

    pytest collects this module before ``tests/unit_tests`` (entries in
    name order), and each xdist worker collects every module, so this runs
    in every worker before any of them imports that package's native
    loaders. Those run ``make`` at import and write the library in place;
    a worker that loaded a half-written one skipped its module's native
    tests. Under the lock the first worker builds and the others find the
    libraries up to date. A failure is kept for the test below, not raised
    here."""
    results = {}
    with open(Path(tempfile.gettempdir()) / "hvd_jax_native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for target in JAX_NATIVE_TARGETS:
            name = " ".join(("make", "-s", *target))
            try:
                proc = subprocess.run(
                    ["make", "-s", *target], cwd=JAX_NATIVE, capture_output=True, text=True,
                    timeout=300,
                )
                results[name] = "" if proc.returncode == 0 else proc.stdout + proc.stderr
            except (OSError, subprocess.TimeoutExpired) as exc:
                results[name] = repr(exc)
    return results


_JAX_NATIVE_BUILD = _build_jax_native()


def _ffmpeg_dev_libraries() -> bool:
    """Whether pkg-config finds the FFmpeg libraries the decoder links."""
    if shutil.which("pkg-config") is None:
        return False
    libs = ["libavformat", "libavcodec", "libswscale", "libavutil"]
    return subprocess.run(["pkg-config", "--exists", *libs]).returncode == 0


def test_the_jax_native_libraries_build_before_their_tests_load_them():
    """Every worker's locked build before collection leaves the JAX
    package's native hasher loadable (its three native-gated test modules
    then run instead of skipping), and its libav decoder too where g++ and
    the FFmpeg libraries are there."""
    from hydrus_video_deduplicator_tpu import native
    from hydrus_video_deduplicator_tpu.native import decode

    assert _JAX_NATIVE_BUILD["make -s"] == "", _JAX_NATIVE_BUILD
    assert native.is_available()
    if shutil.which("g++") and _ffmpeg_dev_libraries():
        assert _JAX_NATIVE_BUILD["make -s decode"] == "", _JAX_NATIVE_BUILD
        assert decode.is_available()

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if "FAIL" in open(args[-1]).read():
    sys.stderr.write("error: no such intrinsic\\n")
    sys.exit(2)
out = args[args.index("-o") + 1]
open(out, "w").write(" ".join(args))
sys.stderr.write("ptxas info    : Used 40 registers, 40960 bytes smem\\n")
"""


@pytest.fixture()
def fake_toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_build_dir", None)
    return csrc


def test_every_source_has_a_library_and_every_library_a_source():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.KERNELS) == {
        "exists_mask_sweep", "pair_verify", "pdq_filter", "similarity_block",
        "similarity_segments",
    }


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_each_source_builds_its_own_library_with_its_flags(fake_toolkit, name):
    so = _build.library_path(name)
    assert so.parent == fake_toolkit / "build" and so.name.startswith(f"libhvd_{name}_")
    cmd = so.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith(f"{name}.cu")
    assert ("--fmad=false" in cmd) == (name == "pdq_filter")
    assert "registers" in so.with_suffix(".log").read_text()
    assert not list(so.parent.glob("*.tmp"))
    assert _build.library_path(name) == so  # built once, then found
    # an edited source builds a new library beside the old one
    src = fake_toolkit / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) != so


def test_a_failed_build_raises_with_the_compiler_output(fake_toolkit):
    (fake_toolkit / "pdq_filter.cu").write_text("FAIL")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.library_path("pdq_filter")
    assert not list((fake_toolkit / "build").glob("*"))


#: the kernels whose frame pairs run on the shared tensor-core header
MMA_KERNELS = ("exists_mask_sweep", "pair_verify", "similarity_block", "similarity_segments")


def test_sources_follow_quoted_includes():
    for name in _build.KERNELS:
        names = [p.name for p in _build.sources(name)]
        assert names[0] == f"{name}.cu"
        assert ("hamming_mma.cuh" in names) == (name in MMA_KERNELS)


def test_an_edited_header_renames_the_libraries_that_include_it(fake_toolkit):
    """No nvcc needed: the library's name is the digest of its sources."""
    before = {name: _build.library_name(name) for name in _build.KERNELS}
    header = fake_toolkit / "hamming_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_name(name) for name in _build.KERNELS}
    for name in _build.KERNELS:
        assert (after[name] != before[name]) == (name in MMA_KERNELS), name
    # a header included from a header counts too
    (fake_toolkit / "inner.cuh").write_text("// v1\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    nested = _build.library_name("similarity_block")
    (fake_toolkit / "inner.cuh").write_text("// v2\n")
    assert _build.library_name("similarity_block") != nested


def test_a_new_flag_renames_the_library_and_reaches_the_command(fake_toolkit, monkeypatch):
    before = _build.library_name("similarity_block")
    extra, functions = _build.KERNELS["similarity_block"]
    monkeypatch.setitem(
        _build.KERNELS, "similarity_block", ([*extra, "-I/usr/local/cutlass/include"], functions)
    )
    assert _build.library_name("similarity_block") != before
    cmd = _build.library_path("similarity_block").read_text().split()
    assert cmd[: len(_build.nvcc_flags("similarity_block"))] == _build.nvcc_flags("similarity_block")


def test_sources_raise_on_a_missing_quoted_include(fake_toolkit):
    """A header that is not there stops the name and the build alike,
    instead of naming the library after the sources it could find."""
    (fake_toolkit / "hamming_mma.cuh").unlink()
    for name in MMA_KERNELS:
        with pytest.raises(FileNotFoundError, match="hamming_mma.cuh.*included by"):
            _build.sources(name)
        with pytest.raises(FileNotFoundError, match="hamming_mma.cuh"):
            _build.library_path(name)
    assert [p.name for p in _build.sources("pdq_filter")] == ["pdq_filter.cu"]
    assert not (fake_toolkit / "build").exists()


def test_the_kernel_build_cache_moves_exactly_when_csrc_build_cannot_be_created(
    fake_toolkit, tmp_path
):
    """``csrc/build/`` where it can be created and written; else the CLI's
    choice, ``<db_dir>/.cuda_cache/``, holds the libraries. Outside the
    CLI such a build raises, naming both directories."""
    db_dir = tmp_path / "db"
    entrypoint._enable_kernel_build_cache(db_dir)
    assert _build.build_dir() == fake_toolkit / "build"
    assert _build.library_path("pdq_filter").parent == fake_toolkit / "build"

    shutil.rmtree(fake_toolkit / "build")
    (fake_toolkit / "build").write_text("a file where the directory would go")
    _build.set_build_dir(None)
    with pytest.raises(RuntimeError, match=r"csrc/build.*\.cuda_cache"):
        _build.library_path("pdq_filter")
    entrypoint._enable_kernel_build_cache(db_dir)
    assert _build.build_dir() == db_dir / ".cuda_cache"
    so = _build.library_path("pdq_filter")
    assert so.parent == db_dir / ".cuda_cache" and so.name == _build.library_name("pdq_filter")
    # a failed build still raises from the cache
    (fake_toolkit / "similarity_block.cu").write_text("FAIL")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.library_path("similarity_block")


@pytest.fixture()
def native_dir(tmp_path, monkeypatch):
    """Point the port's native loaders at ``tmp_path/native`` (not built
    yet), with no library loaded; returns that directory."""
    root = tmp_path / "native"
    for module in (native, native_decode):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_load_failed", False)
    monkeypatch.setattr(native, "_DIR", root)
    monkeypatch.setattr(native, "BUILD_DIR", root / "build")
    monkeypatch.setattr(native, "_SONAME", root / "build" / "libhvdaccel.so")
    monkeypatch.setattr(native_decode, "_SONAME", root / "build" / "libhvdecode.so")
    return root


def test_native_loaders_do_not_raise_where_build_cannot_be_created(native_dir):
    """The build directory under a regular file (so this holds as root as
    well): no build, no library, no exception; the callers fall back."""
    native_dir.write_text("a regular file, not a directory")
    assert native.make_library("libhvdaccel.so", "SONAME") is False
    assert native.get_lib() is None and not native.is_available()
    assert native_decode.get_lib() is None


@pytest.mark.parametrize("broken", ["no make", "no compiler"])
def test_native_loader_takes_the_prebuilt_library_where_it_cannot_build(
    native_dir, monkeypatch, broken
):
    """A wheel's prebuilt library in ``build/``, older than its sources
    (pip may install it so): where ``make`` cannot run, or runs but cannot
    compile, the loader takes that library instead of failing."""
    native_dir.mkdir()
    for name in ("Makefile", "pdq.cpp", "pdq_tables.h"):
        shutil.copy2(Path(native.__file__).parent / name, native_dir / name)
    assert native.make_library("libhvdaccel.so", "SONAME"), "the prebuilt library did not build"
    os.utime(native_dir / "build" / "libhvdaccel.so", (1, 1))  # stale for make
    if broken == "no make":
        empty = native_dir.parent / "empty_path"
        empty.mkdir()
        monkeypatch.setenv("PATH", str(empty))
    else:
        monkeypatch.setenv("CXX", "false")
    assert native.make_library("libhvdaccel.so", "SONAME") is False
    lib = native.get_lib()
    assert lib is not None and lib.hvd_abi_version() == 1
    assert native._lib._name == str(native_dir / "build" / "libhvdaccel.so")
    assert not list((native_dir / "build").glob("*.tmp"))
