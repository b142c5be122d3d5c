"""The port as users install it: a wheel built from a copy of the sources
(``pip wheel --no-deps --no-build-isolation``; ``setup.py`` writes its
native libraries into the tree it runs from, so never this checkout),
installed with ``pip install --no-deps --no-index --target``, then run in
fresh interpreters from outside the repository. No GPU, nvcc or network.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from hydrus_video_deduplicator_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
PORT = "hydrus_video_deduplicator_tpu_torch"
SCRIPT = "hydrus-video-deduplicator-tpu-torch"
#: what the wheel is built from: the packages and the packaging files
SOURCES = (
    "hydrus_video_deduplicator_tpu", PORT, "hydrusvideodeduplicator",
    "setup.py", "pyproject.toml", "README.md",
)
#: build outputs of a checkout, which a copy of the sources leaves out
BUILD_OUTPUTS = shutil.ignore_patterns("__pycache__", "build", "_build", "*.so", "*.o")
#: pip without the network: no index, no version check
PIP_OFFLINE = ("--no-index", "--disable-pip-version-check", "-q")


def _run(cmd, **kwargs) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kwargs)
    assert proc.returncode == 0, f"{cmd}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"
    return proc


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(the wheel, the --target directory, a working directory outside
    the repository)."""
    root = tmp_path_factory.mktemp("wheel")
    src = root / "src"
    src.mkdir()
    for name in SOURCES:
        path = REPO / name
        if path.is_dir():
            shutil.copytree(path, src / name, ignore=BUILD_OUTPUTS)
        else:
            shutil.copy2(path, src / name)
    _run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
          *PIP_OFFLINE, "-w", str(root / "dist"), str(src)], cwd=root)
    (wheel,) = (root / "dist").glob("*.whl")
    site = root / "site"
    _run([sys.executable, "-m", "pip", "install", "--no-deps", *PIP_OFFLINE, "--target",
          str(site), str(wheel)], cwd=root)
    outside = root / "cwd"
    outside.mkdir()
    return wheel, site, outside


def _fresh_env(site: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(site)
    return env


@pytest.fixture(scope="module")
def installed_report(installed):
    """What a fresh interpreter on the installed copy reports: where the
    port imports from, each kernel's library name, and the native
    library it loads."""
    _wheel, site, outside = installed
    code = "\n".join([
        "import json",
        f"import {PORT} as port",
        f"from {PORT} import native",
        f"from {PORT}.ops import _build",
        "lib = native.get_lib()",
        "print(json.dumps({'port': port.__file__,"
        " 'names': {k: _build.library_name(k) for k in _build.KERNELS},"
        " 'native': lib and lib._name}))",
    ])
    proc = _run([sys.executable, "-c", code], cwd=outside, env=_fresh_env(site))
    return json.loads(proc.stdout.splitlines()[-1])


def test_the_wheel_holds_every_kernel_source(installed):
    """Every file ``_build.sources`` follows, headers included."""
    wheel, _site, _outside = installed
    names = set(zipfile.ZipFile(wheel).namelist())
    needed = {
        f"{PORT}/{path.relative_to(_build.CSRC.parent).as_posix()}"
        for kernel in _build.KERNELS for path in _build.sources(kernel)
    }
    assert f"{PORT}/csrc/hamming_mma.cuh" in needed
    assert needed <= names, sorted(needed - names)


def test_the_installed_copy_names_each_kernel_library_as_the_checkout_does(
    installed, installed_report
):
    _wheel, site, _outside = installed
    assert Path(installed_report["port"]).parent == site / PORT
    assert installed_report["names"] == {k: _build.library_name(k) for k in _build.KERNELS}


def test_the_wheel_names_the_console_script(installed):
    wheel, _site, _outside = installed
    with zipfile.ZipFile(wheel) as zf:
        (entry_points,) = [n for n in zf.namelist() if n.endswith(".dist-info/entry_points.txt")]
        text = zf.read(entry_points).decode()
    assert f"{SCRIPT} = {PORT}.entrypoint:run_main_cli" in text


def test_the_wheel_carries_the_ports_prebuilt_native_library(installed, installed_report):
    """Where g++ is present the wheel ships the port's native library, and
    the installed copy loads that one."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the wheel ships no native library and the loader falls back")
    wheel, site, _outside = installed
    assert f"{PORT}/native/build/libhvdaccel.so" in zipfile.ZipFile(wheel).namelist()
    assert installed_report["native"] == str(site / PORT / "native" / "build" / "libhvdaccel.so")


def test_the_console_script_runs_the_installed_copy(installed):
    """``<target>/bin/hydrus-video-deduplicator-tpu-torch --help`` in a fresh
    interpreter from a directory outside the repository: the interpreter's
    verbose import log shows the port's modules coming from the target."""
    _wheel, site, outside = installed
    env = _fresh_env(site) | {"PYTHONVERBOSE": "1"}
    proc = _run([str(site / "bin" / SCRIPT), "--help"], cwd=outside, env=env)
    assert f"Usage: {SCRIPT} [OPTIONS]" in proc.stdout
    assert "--search-backend [auto|tree|gpu]" in proc.stdout
    assert str(site / PORT / "entrypoint.py") in proc.stderr
    assert str(REPO / PORT) not in proc.stderr
