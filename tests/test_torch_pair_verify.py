"""The port's exact pair verification against the JAX package and the
native matchHashBytes oracle."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.ops import pair_verify as jax_verify
from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes
from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim

from .unit_tests.test_pruned_search import _mixed_corpus

CPU = torch.device("cpu")


def test_pair_verify_matches_jax_and_native(rng):
    blobs = _mixed_corpus(rng)
    nonempty = [i for i, b in enumerate(blobs) if 0 < len(b) // 32 <= 512]
    pairs = [(i, j) for i in nonempty for j in rng.choice(nonempty, size=4, replace=False)]
    got = sorted(pair_verify.verify_pairs(pairs, blobs, blobs, 1, CPU))
    want = sorted(jax_verify.verify_pairs(pairs, blobs, blobs, 1))
    assert got == want
    by_pair = {(i, j): s for i, j, s in got}
    for i, j in pairs:
        assert by_pair.get((i, j), 0) == int(matchHashBytes(blobs[i], blobs[j]))


def test_pair_verify_rejects_below_min(rng):
    a = rng.integers(0, 256, (4, 32), dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, (4, 32), dtype=np.uint8).tobytes()
    assert pair_verify.verify_pairs([(0, 1)], [a, b], [a, b], 1, CPU) == []
    assert jax_verify.verify_pairs([(0, 1)], [a, b], [a, b], 1) == []


def test_pair_verify_shortcut_and_empty_guard(rng):
    a = rng.integers(0, 256, (5, 32), dtype=np.uint8).tobytes()
    assert pair_verify.verify_pairs([(0, 0)], [a], [a], 100, CPU) == [(0, 0, 100)]
    with pytest.raises(AssertionError):
        pair_verify.verify_pairs([(0, 1)], [a, b""], [a, b""], 1, CPU)


@pytest.mark.parametrize("pad", [32, 512])
def test_verify_chunk_matches_jax(rng, pad):
    """One bucket chunk, element for element, with ragged counts, empty
    pairs and all-zero-bit real frames."""
    p = 24
    a = rng.integers(0, 2**32, (p, pad, 8), dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    flips = rng.integers(0, 2**32, (p, pad, 8), dtype=np.uint64).astype(np.uint32)
    b[p // 2 :] ^= flips[p // 2 :] & flips[: p - p // 2] & 0x01010101  # near copies
    a[0] = 0
    b[0, :4] = 0
    a_cnt = rng.integers(0, pad + 1, p).astype(np.int32)
    b_cnt = rng.integers(0, pad + 1, p).astype(np.int32)
    a_cnt[:2] = pad
    b_cnt[:2] = pad
    for k in range(p):  # zero rows past each count, as the packer leaves them
        a[k, a_cnt[k] :] = 0
        b[k, b_cnt[k] :] = 0
    got = pair_verify._verify_chunk(
        ops_sim.to_words(a, CPU), torch.from_numpy(a_cnt),
        ops_sim.to_words(b, CPU), torch.from_numpy(b_cnt), pad,
    ).numpy()
    want = np.asarray(
        jax_verify._verify_chunk(
            jnp.asarray(a), jnp.asarray(a_cnt), jnp.asarray(b), jnp.asarray(b_cnt), pad
        )
    )
    assert np.array_equal(got, want)
    assert got.max() > 0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pair_verify_fp16_on_cuda_equals_cpu(rng, cuda_device):
    blobs = _mixed_corpus(rng, long_video=True)
    ok = [i for i, b in enumerate(blobs) if 0 < len(b) // 32 <= 512]
    pairs = [(i, j) for i in ok for j in ok]
    assert sorted(pair_verify.verify_pairs(pairs, blobs, blobs, 1, cuda_device)) == sorted(
        pair_verify.verify_pairs(pairs, blobs, blobs, 1, CPU)
    )
