"""The port imports without JAX and without the JAX package, builds
nothing at import, and starts."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "hydrus_video_deduplicator_tpu_torch"
JAX_PACKAGE = "hydrus_video_deduplicator_tpu"


def _is_reference(module: str) -> bool:
    """jax, or the JAX package or one of its modules."""
    return any(module == top or module.startswith(top + ".") for top in ("jax", JAX_PACKAGE))


def test_port_imports_without_jax_or_a_build():
    """A fresh interpreter (this one already holds jax) imports every module
    of the port: neither jax nor any module of the JAX package enters
    sys.modules, and no kernel or native build ran. ``gui.gui`` imports
    PySide6 at its top, an optional extra: without it that one module is
    left out here (the AST scan below still covers it)."""
    code = "\n".join(
        [
            "import importlib, importlib.util, pkgutil, sys",
            "import hydrus_video_deduplicator_tpu_torch as port",
            "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]",
            "skip = set() if importlib.util.find_spec('PySide6') else {port.__name__ + '.gui.gui'}",
            "for m in names: m in skip or importlib.import_module(m)",
            "from hydrus_video_deduplicator_tpu_torch import native",
            "from hydrus_video_deduplicator_tpu_torch.ops import _build",
            "ref = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            f" or m == {JAX_PACKAGE!r} or m.startswith({JAX_PACKAGE + '.'!r}))",
            "print(len(names), ref, native._lib is None, _build.load_library.cache_info().misses)",
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, rest = proc.stdout.split(maxsplit=1)
    # the port's own modules, its host layer, the rerank tower, the profiling
    # helpers and the GUI with its Windows entry points
    assert int(n_modules) >= 48
    assert rest.split() == ["[]", "True", "0"], proc.stdout


def _imports(path: Path) -> list[str]:
    """Absolute module names a file imports (import statements, and
    importlib.import_module / runpy.run_module / __import__ of a string)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "run_module", "__import__"):
                found.append(str(node.args[0].value))
    return found


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    """An AST scan of every module of the port, of the port's scripts at the
    root (chip_smoke.py, the benchmarks bench_torch.py and
    bench_search_torch.py, mma_rates.py) and of the tests of the installed
    port, which need no JAX either."""
    scripts = ("chip_smoke.py", "bench_torch.py", "bench_search_torch.py", "mma_rates.py")
    files = sorted(PORT.rglob("*.py")) + [REPO / name for name in scripts] + [
        REPO / "tests" / "test_torch_packaging.py"
    ]
    assert len(files) >= 40
    bad = {
        str(f.relative_to(REPO)): [m for m in _imports(f) if _is_reference(m)] for f in files
    }
    assert not {f: m for f, m in bad.items() if m}


def test_cli_help_lists_the_gpu_backend():
    proc = subprocess.run(
        [sys.executable, "-m", "hydrus_video_deduplicator_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--search-backend [auto|tree|gpu]" in proc.stdout
    assert "--search-prefilter" in proc.stdout
    assert "--hash-backend [auto|native|gpu]" in proc.stdout
    for flag in ("--rerank [none|clip]", "--rerank-weights", "--rerank-threshold", "--gui / --no-gui"):
        assert flag in proc.stdout, flag


def test_device_helper_never_falls_back_to_the_cpu(monkeypatch):
    from hydrus_video_deduplicator_tpu_torch._device import resolve_device
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GpuSearchEngine()
    assert resolve_device("cpu") == torch.device("cpu")
    assert GpuSearchEngine(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
