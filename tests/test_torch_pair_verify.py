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
from hydrus_video_deduplicator_tpu_torch.utils import profiling

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


# ---------------------------------------------------------------------------
# The vectorised host side and the CUDA kernel, against a per-pair loop
# ---------------------------------------------------------------------------

#: frame counts at and around each pad edge of the CPU path's buckets
EDGES = (1, 32, 33, 64, 65, 128, 129, 256, 257, 511, 512)


def _flipped(rng, v: np.ndarray, bits: int) -> np.ndarray:
    """``v`` ([N, 32] uint8 frames) with exactly ``bits`` of each frame's
    256 bits flipped."""
    pick = np.argsort(rng.random((len(v), 256)), axis=1)[:, :bits]
    mask = np.zeros((len(v), 256), dtype=bool)
    np.put_along_axis(mask, pick, True, axis=1)
    return v ^ np.packbits(mask, axis=1)


def _frames(rng, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _ragged(rng, sizes) -> list[bytes]:
    """One video a size: near copies of one base video's first frames,
    every third frame drawn anew, so that pairs score between 0 and 100."""
    base = _frames(rng, max(sizes))
    out = []
    for n in sizes:
        v = _flipped(rng, base[:n], int(rng.integers(0, 24)))
        v[::3] = _frames(rng, len(v[::3]))
        out.append(v.tobytes())
    return out


def _case(rng, name: str, sizes=EDGES):
    """(row blobs, column blobs, pairs) of one case of the kernel's tests."""
    if name == "pad_edges":
        blobs = _ragged(rng, sizes)
        return blobs, blobs, [(i, j) for i in range(len(blobs)) for j in range(len(blobs))]
    if name == "distance_31_32":
        a = _frames(rng, 40)
        b = a.copy()
        b[0::2] = _flipped(rng, a[0::2], 31)  # match
        b[1::2] = _flipped(rng, a[1::2], 32)  # no match
        c = _flipped(rng, a, 32)
        blobs = [v.tobytes() for v in (a, b, c)]
        return blobs, blobs, [(0, 1), (1, 0), (0, 2), (2, 1)]
    if name == "all_zero":
        zero = np.zeros((7, 32), dtype=np.uint8)
        mixed = _frames(rng, 9)
        mixed[::2] = 0
        near = _flipped(rng, np.zeros((5, 32), dtype=np.uint8), 31)
        far = _flipped(rng, np.zeros((6, 32), dtype=np.uint8), 32)
        blobs = [v.tobytes() for v in (zero, mixed, near, far)]
        return blobs, blobs, [(i, j) for i in range(4) for j in range(4) if i != j]
    if name == "identical_blobs":
        blobs = _ragged(rng, (40, 3, 300))
        # equal content, other objects, at other indices and on either side
        rows = blobs + [bytes(bytearray(b)) for b in blobs]
        cols = {j: bytes(bytearray(rows[j % 6])) for j in range(6)}
        return rows, cols, [(0, 3), (3, 0), (2, 5), (1, 1), (0, 1), (4, 2), (5, 0)]
    if name == "one_video_many_pairs":
        blobs = _ragged(rng, [int(n) for n in rng.integers(1, 513, 60)])
        pairs = [(0, j) for j in range(1, 60)] + [(i, 0) for i in range(1, 60, 2)]
        return blobs, blobs, pairs
    if name == "no_device_pairs":
        blobs = _ragged(rng, (5, 70, 200))
        copies = [bytes(bytearray(b)) for b in blobs]
        return blobs, copies, [(0, 0), (1, 1), (2, 2), (1, 1)]
    raise ValueError(name)


CASES = (
    "pad_edges", "distance_31_32", "all_zero", "identical_blobs", "one_video_many_pairs",
    "no_device_pairs",
)


def _per_pair(pairs, row_blob, col_blob, min_sim: int) -> list:
    """verify_pairs written out pair by pair: identical blobs score 100,
    the rest the JAX package's native matchHashBytes."""
    out = []
    for i, j in pairs:
        a, b = row_blob[i], col_blob[j]
        s = 100 if a == b else int(matchHashBytes(a, b))
        if s >= min_sim:
            out.append((i, j, s))
    return sorted(out)


@pytest.fixture()
def recorder(monkeypatch):
    """The span recorder on and empty, then off and empty again."""
    monkeypatch.delenv(profiling.DEBUG_TIMING_ENV, raising=False)
    profiling.debug_timing()
    profiling.enable(True)
    profiling.clear()
    yield profiling
    profiling.enable(False)
    profiling.clear()


def _verify_counts(recorder) -> dict:
    (call,) = [r for r in recorder.records() if r.name == "verify"]
    recorder.clear()
    return call.counts


@pytest.mark.parametrize("min_sim", [0, 1, 60])
@pytest.mark.parametrize("name", CASES)
def test_host_side_equals_a_per_pair_loop(rng, recorder, name, min_sim):
    """The CPU path (the vectorised shortcut, gather, offsets and min_sim
    filter around _verify_chunk) gives the per-pair loop's triples and the
    JAX package's verify_pairs', and counts each pair once as host- or
    device-settled."""
    rows, cols, pairs = _case(rng, name, sizes=(1, 32, 33, 64, 65, 128, 129))
    got = pair_verify.verify_pairs(pairs, rows, cols, min_sim, CPU)
    assert sorted(got) == _per_pair(pairs, rows, cols, min_sim)
    assert sorted(got) == sorted(jax_verify.verify_pairs(pairs, rows, cols, min_sim))
    counts = _verify_counts(recorder)
    identical = sum(rows[i] == cols[j] for i, j in pairs)
    assert counts["verify.host_pairs"] == identical
    assert counts["verify.device_pairs"] == len(pairs) - identical


def test_host_side_refuses_what_the_kernel_cannot_take(rng):
    a = _frames(rng, 513).tobytes()
    b = _frames(rng, 3).tobytes()
    with pytest.raises(ValueError, match="MAX_PAD"):
        pair_verify.verify_pairs([(0, 1)], [a, b], [a, b], 1, CPU)
    assert pair_verify.verify_pairs([(0, 0)], [a], [a], 1, CPU) == [(0, 0, 100)]
    assert pair_verify.verify_pairs([], [a], [a], 1, CPU) == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_verify_chunk_and_native(rng, recorder, cuda_device, monkeypatch, name):
    """Every similarity of the kernel (min_sim 0) equals the CPU
    _verify_chunk path's, native matchHashBytes' and the JAX package's
    verify_pairs' (JAX on the host's CPU); one launch a call with device
    pairs, none without, and no bucket chunk on CUDA."""
    rows, cols, pairs = _case(rng, name)
    want = sorted(pair_verify.verify_pairs(pairs, rows, cols, 0, CPU))
    assert want == _per_pair(pairs, rows, cols, 0)
    assert want == sorted(jax_verify.verify_pairs(pairs, rows, cols, 0))
    recorder.clear()
    monkeypatch.setattr(pair_verify, "_verify_chunk", lambda *a: pytest.fail("bmm chain on CUDA"))
    before = pair_verify.LAUNCHES["pair_verify"]
    got = sorted(pair_verify.verify_pairs(pairs, rows, cols, 0, cuda_device))
    assert got == want
    counts = _verify_counts(recorder)
    launches = pair_verify.LAUNCHES["pair_verify"] - before
    # one batched call at most, so never more than the call's pad classes
    assert counts.get("verify.chunks", 0) == launches == int(counts["verify.device_pairs"] > 0)
    assert (launches == 0) == (name == "no_device_pairs")
