"""The port imports without JAX, builds nothing at import, and starts."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "hydrus_video_deduplicator_tpu_torch",
    "hydrus_video_deduplicator_tpu_torch._device",
    "hydrus_video_deduplicator_tpu_torch.ops",
    "hydrus_video_deduplicator_tpu_torch.ops._build",
    "hydrus_video_deduplicator_tpu_torch.models",
    "hydrus_video_deduplicator_tpu_torch.models.pdq",
    "hydrus_video_deduplicator_tpu_torch.models.vpdq",
    "hydrus_video_deduplicator_tpu_torch.ops.pdq_filter",
    "hydrus_video_deduplicator_tpu_torch.ops.similarity",
    "hydrus_video_deduplicator_tpu_torch.ops.similarity_segments",
    "hydrus_video_deduplicator_tpu_torch.ops.pair_verify",
    "hydrus_video_deduplicator_tpu_torch.parallel",
    "hydrus_video_deduplicator_tpu_torch.parallel.engine",
    "hydrus_video_deduplicator_tpu_torch.dedup",
    "hydrus_video_deduplicator_tpu_torch.entrypoint",
    "hydrus_video_deduplicator_tpu_torch.__main__",
]


def test_port_imports_without_jax_or_a_build():
    """A fresh interpreter (this one already holds jax) imports every module
    of the port: jax stays out of sys.modules and no kernel build ran."""
    code = "\n".join(
        [
            "import importlib, sys",
            f"for m in {MODULES!r}: importlib.import_module(m)",
            "from hydrus_video_deduplicator_tpu_torch.ops import _build",
            "print('jax' in sys.modules, _build.load_library.cache_info().misses)",
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-2:] == ["False", "0"], proc.stdout


def test_cli_help_lists_the_gpu_backend():
    proc = subprocess.run(
        [sys.executable, "-m", "hydrus_video_deduplicator_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--search-backend [auto|tree|gpu]" in proc.stdout
    assert "--search-prefilter" in proc.stdout
    assert "--hash-backend [auto|native|gpu]" in proc.stdout


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
