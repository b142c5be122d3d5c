"""``GpuVideoHasher`` on the CPU (the plain PyTorch filter) against the
reference hasher ``hashing.compute_phash`` (the native C++ hasher, or the
numpy oracle where the native library is absent: both are bit-exact) and
against the JAX package's ``TpuVideoHasher`` (XLA-CPU, at the JAX suite's
own CPU tolerance: see ``test_torch_pdq.py``)."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu import hashing
from hydrus_video_deduplicator_tpu.models.vpdq import TpuVideoHasher
from hydrus_video_deduplicator_tpu_torch.decode import DecodeError
from hydrus_video_deduplicator_tpu_torch.models.vpdq import GpuVideoHasher
from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
from hydrus_video_deduplicator_tpu_torch.vpdq import pdq_math as pm

from .make_corpus import write_y4m
from .test_torch_orchestrator import _subset_store
from .test_torch_pdq import hamming


def _items():
    return sorted(_subset_store().items())


def test_hasher_equals_compute_phash_for_every_file():
    items = _items()
    hasher = GpuVideoHasher(device="cpu", decode_workers=3)
    results = hasher.hash_videos(items)
    assert [r.key for r in results] == [k for k, _ in items]
    n_frames = 0
    for (key, data), r in zip(items, results):
        assert r.error is None, (key, r.error)
        want = hashing.compute_phash(data)
        assert r.phash.bytes == want.bytes, key
        assert r.n_frames >= len(want)
        n_frames += r.n_frames
    assert hasher.stats["frames"] == n_frames
    # several device batches, the last one partial
    assert hasher.stats["batches"] == -(-n_frames // hasher.batch_size) > 1


def test_hasher_equals_the_jax_hasher_at_its_cpu_tolerance():
    items = _items()[:3]
    got = GpuVideoHasher(device="cpu").hash_videos(items)
    want = TpuVideoHasher().hash_videos(items)
    for g, w in zip(got, want):
        assert g.key == w.key and g.n_frames == w.n_frames and g.error is w.error is None
        a, b = g.phash.frame_hashes(), w.phash.frame_hashes()
        assert len(a) == len(b) > 0
        assert all(hamming(x, y) <= 4 for x, y in zip(a, b))


def test_a_corrupt_file_is_a_typed_failure_and_order_holds():
    items = _items()[:4]
    items.insert(2, ("corrupt", b"\x00not a video" * 64))
    results = GpuVideoHasher(device="cpu", batch_size=5).hash_videos(items)
    assert [r.key for r in results] == [k for k, _ in items]
    bad = results[2]
    assert bad.phash is None and isinstance(bad.error, DecodeError)
    for (key, data), r in zip(items, results):
        if key != "corrupt":
            assert r.error is None and r.phash.bytes == hashing.compute_phash(data).bytes


def test_quality_filter_drops_frames_to_an_empty_hash():
    """A constant-colour video hashes to b"" (every frame is below the
    quality floor); a quality floor of 0 keeps every frame."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flat.y4m"
        write_y4m(path, [np.full((64, 64, 3), 128, np.uint8)] * 3, fps_num=1)
        data = path.read_bytes()
    (dropped,) = GpuVideoHasher(device="cpu").hash_videos([("flat", data)])
    (kept,) = GpuVideoHasher(device="cpu", quality_min=0).hash_videos([("flat", data)])
    assert dropped.phash.bytes == b"" and dropped.n_frames == 3
    assert len(kept.phash.bytes) == 3 * pm.BYTES_PER_HASH


def test_hasher_refuses_to_leave_the_device_on_its_own(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GpuVideoHasher()
    assert GpuVideoHasher(device="cpu").batch_size == 16


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hasher_on_cuda_equals_compute_phash(cuda_device):
    """On the card the hasher runs the PDQ filter kernel, with a batch that
    splits the corpus into full and partial device batches."""
    items = _items()
    hasher = GpuVideoHasher(device=cuda_device, batch_size=40)
    before = pdq_filter.LAUNCHES["pdq_filter"]
    results = hasher.hash_videos(items)
    assert pdq_filter.LAUNCHES["pdq_filter"] - before == hasher.stats["batches"] > 1
    for (key, data), r in zip(items, results):
        assert r.error is None and r.phash.bytes == hashing.compute_phash(data).bytes, key
