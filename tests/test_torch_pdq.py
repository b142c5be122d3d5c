"""The port's PDQ pipeline against the numpy oracle and the JAX package.

The plain PyTorch path (``models.pdq``, and ``ops.pdq_filter`` on CPU
tensors) runs every f32 add and multiply as its own eager op, so it must
equal the numpy oracle ``vpdq.python_ref`` bit for bit: hash blob,
quality, the decimated buffer and the DCT. XLA-CPU contracts some
multiply-add pairs into FMAs, so against the JAX package the comparison
takes the JAX suite's own CPU tolerance (``test_pdq_jax.py``: quality
within 1, Hamming distance at most 4 where quality >= 31; the filter
buffer within rtol 1e-6 — it is not exact: noise frames differ by one ulp
in some values). The Pallas kernel runs only on a TPU, so the JAX side is
held through its plain reference ``_filter_and_decimate(_luma(x))``,
which ``ops/pdq_pallas.py`` declares equal to it. The CUDA kernel is
compared with the plain version on the card.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.decode import extract_frames
from hydrus_video_deduplicator_tpu.models import pdq as jax_pdq
from hydrus_video_deduplicator_tpu.vpdq import pdq_math as pm
from hydrus_video_deduplicator_tpu.vpdq import python_ref
from hydrus_video_deduplicator_tpu_torch.models import pdq
from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter

VIDEOS = Path(__file__).parent / "corpus" / "videos"
KINDS = ("noise", "smooth", "constant", "zeros", "full", "corpus")


def make_frames(kind: str, seed: int = 0) -> np.ndarray:
    """[n, 512, 512, 3] uint8 frames of one kind, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = 3
    if kind == "noise":
        return rng.integers(0, 256, (n, 512, 512, 3), dtype=np.uint8)
    if kind == "smooth":
        x = np.linspace(0, 255, 512)
        base = np.add.outer(x, x) / 2
        return np.stack(
            [np.stack([np.roll(base, 11 * i + 3, axis=i % 2)] * 3, -1) for i in range(n)]
        ).astype(np.uint8)
    if kind == "constant":
        return np.stack([np.full((512, 512, 3), v, np.uint8) for v in (1, 90, 254)])
    if kind == "zeros":
        return np.zeros((2, 512, 512, 3), np.uint8)
    if kind == "full":
        return np.full((2, 512, 512, 3), 255, np.uint8)
    if kind == "corpus":
        a = list(extract_frames(VIDEOS / "scene_a" / "S01_master.y4m"))
        c = list(extract_frames(VIDEOS / "scene_c" / "S03_master.y4m"))
        return np.stack([a[0], a[len(a) // 2], c[1]])
    raise ValueError(kind)


def planar(frames: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


def hamming(a: bytes, b: bytes) -> int:
    return bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1")


@pytest.mark.parametrize("kind", KINDS)
def test_plain_hash_equals_the_numpy_oracle_bit_for_bit(kind):
    frames = make_frames(kind)
    words, quality = pdq.pdq_hash_batch(torch.from_numpy(frames))
    fused_words, fused_quality = pdq_filter.pdq_hash_batch_fused(planar(frames))
    assert words.dtype == quality.dtype == torch.int32
    assert torch.equal(words, fused_words) and torch.equal(quality, fused_quality)
    blobs = pdq.words_to_blobs(words.numpy())
    for i, frame in enumerate(frames):
        want_blob, want_q = python_ref.pdq_hash_frame(frame)
        assert blobs[i] == want_blob, f"{kind}[{i}]: hash differs"
        assert int(quality[i]) == want_q, f"{kind}[{i}]: quality differs"


@pytest.mark.parametrize("kind", ("noise", "smooth", "corpus"))
def test_buffer_and_dct_equal_the_oracle_intermediates(kind):
    frames = make_frames(kind)
    buf64 = pdq_filter.pdq_filter_batch(planar(frames))
    dct = pdq._dct16(buf64)
    for i, frame in enumerate(frames):
        want = python_ref.decimate(python_ref.jarosz_filter(python_ref.luma_milli_f32(frame)))
        assert np.array_equal(buf64[i].numpy().view(np.int32), want.view(np.int32))
        want_dct = python_ref.dct16(want)
        assert np.array_equal(dct[i].numpy().view(np.int32), want_dct.view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_port_equals_the_jax_xla_path_at_its_cpu_tolerance(kind):
    frames = make_frames(kind, seed=1)
    words, quality = pdq.pdq_hash_batch(torch.from_numpy(frames))
    jwords, jquality = jax_pdq.pdq_hash_batch_jit(jnp.asarray(frames))
    got = pdq.words_to_blobs(words.numpy())
    want = jax_pdq.words_to_blobs(np.asarray(jwords))
    for i in range(len(frames)):
        assert abs(int(quality[i]) - int(jquality[i])) <= 1, f"{kind}[{i}]: quality drift"
        if int(jquality[i]) >= pm.QUALITY_MIN_KEEP:
            assert hamming(got[i], want[i]) <= 4, f"{kind}[{i}]: drifted too far"


@pytest.mark.parametrize("kind", ("noise", "smooth", "corpus"))
def test_plain_filter_equals_the_jax_filter_reference(kind):
    frames = make_frames(kind, seed=2)
    got = pdq_filter.pdq_filter_batch_plain(planar(frames)).numpy()
    want = np.asarray(
        jax.jit(lambda f: jax_pdq._filter_and_decimate(jax_pdq._luma(f)))(jnp.asarray(frames))
    )
    assert got.shape == want.shape == (len(frames), 64, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_words_blobs_roundtrip_and_equal_jax(rng):
    words = rng.integers(0, 1 << 16, (7, 16)).astype(np.int32)
    blobs = pdq.words_to_blobs(words)
    assert blobs == jax_pdq.words_to_blobs(words)
    assert all(len(b) == pm.BYTES_PER_HASH for b in blobs)
    back = pdq.blobs_to_words(blobs)
    assert back.dtype == np.uint16 and np.array_equal(back, words)
    assert np.array_equal(back, jax_pdq.blobs_to_words(blobs))
    with pytest.raises(ValueError):
        pdq.blobs_to_words([b"\x00" * 31])


def test_wrapper_validates_before_either_path():
    good = torch.zeros((2, 3, 512, 512), dtype=torch.uint8)
    before = pdq_filter.LAUNCHES["pdq_filter"]
    assert pdq_filter.pdq_filter_batch(good).shape == (2, 64, 64)
    assert pdq_filter.LAUNCHES["pdq_filter"] == before  # the CPU runs no kernel
    with pytest.raises(ValueError, match="uint8"):
        pdq_filter.pdq_filter_batch(good.to(torch.int16))
    with pytest.raises(ValueError, match=r"\[B, 3, 512, 512\]"):
        pdq_filter.pdq_filter_batch(good[:, :, :256])
    with pytest.raises(ValueError, match=r"\[B, 3, 512, 512\]"):
        pdq_filter.pdq_filter_batch(good.permute(0, 2, 3, 1).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pdq_filter.pdq_filter_batch(good.transpose(2, 3))
    with pytest.raises(ValueError, match="device"):
        pdq_filter.pdq_filter_batch(good.to("meta"))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device, monkeypatch):
    """The CUDA kernel is bit-equal to the plain version on edge frames, a
    CUDA tensor never reaches the plain version inside the wrapper, and
    the wrapper refuses what the kernel does not take."""
    frames = np.concatenate([make_frames(k) for k in KINDS])
    x = planar(frames).to(cuda_device)
    want = pdq_filter.pdq_filter_batch_plain(x)

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(pdq_filter, "pdq_filter_batch_plain", refuse)
    before = pdq_filter.LAUNCHES["pdq_filter"]
    got = pdq_filter.pdq_filter_batch(x)
    torch.cuda.synchronize()
    assert pdq_filter.LAUNCHES["pdq_filter"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    words, quality = pdq_filter.pdq_hash_batch_fused(x)
    blobs = pdq.words_to_blobs(words.cpu().numpy())
    for i, frame in enumerate(frames):
        assert (blobs[i], int(quality[i])) == python_ref.pdq_hash_frame(frame)
    with pytest.raises(ValueError, match="uint8"):
        pdq_filter.pdq_filter_batch(x.to(torch.int32))
    with pytest.raises(ValueError, match=r"\[B, 3, 512, 512\]"):
        pdq_filter.pdq_filter_batch(x[:, :2].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
        pdq_filter.pdq_filter_batch(flat[1:].view(x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 513])
def test_kernel_matches_plain_at_ragged_batches_on_cuda(cuda_device, batch):
    """Batches that are no multiple of the kernel's warps per block or of
    its grid's warps: every band of every frame lands where the plain
    version puts it."""
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.integers(0, 256, (batch, 3, 512, 512), dtype=np.uint8))
    x = x.to(cuda_device)
    got = pdq_filter.pdq_filter_batch(x)
    want = pdq_filter.pdq_filter_batch_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
