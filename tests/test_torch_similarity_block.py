"""The port's bucketed similarity block (TPU kernel 5) against the JAX
package.

``similarity_block_plain`` must equal, integer for integer, the JAX
package's ``similarity_block_xla`` (the XLA twin of the Pallas kernel, fed
``unpack_pm1_host`` rows: the way the JAX suite reaches the kernel on the
CPU) and the JAX engine's ``_tile_similarity`` at the bucket pairs the
bucketed route sees, both directions. Inputs are bit-packed and
numpy-seeded; counts include 0, 1, pad - 1 and pad; padding frames are all
zero, and each side holds a real all-zero frame, which only an exclusion by
count keeps apart from the padding. The CUDA kernel is compared with the
plain version on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.ops.similarity_pallas import (
    similarity_block_xla,
    unpack_pm1_host,
)
from hydrus_video_deduplicator_tpu.parallel.engine import _tile_similarity
from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb

#: (pa, pb): both sides small, long rows against column pads 1, 8, 64, 512
#: and 1024 (counts 1, pb - 1 and pb each), and the long-column direction
PADS = [(4, 4), (1024, 1), (1024, 8), (1024, 64), (1024, 512), (64, 1024), (1024, 1024)]


def _side(rng, pad: int) -> tuple[np.ndarray, np.ndarray]:
    """[V, pad, 8] uint32 random frames and the counts {0, 1, pad // 2,
    pad - 1, pad} and pad again: video 1 has one frame, the last pad."""
    counts = sorted({0, 1, max(pad // 2, 1), max(pad - 1, 1), pad})
    counts = np.asarray(counts + [pad], np.int32)
    words = rng.integers(0, 1 << 32, (len(counts), pad, 8), dtype=np.uint32)
    return words, counts


def _inputs(pa: int, pb: int):
    """Row and column tiles with near copies across the two sides (about
    16 flipped bits a frame: most match at tolerance 31), an exact one-frame
    duplicate (similarity 100), and a real all-zero frame on each side."""
    rng = np.random.default_rng(1000 * pa + pb)
    a, ca = _side(rng, pa)
    b, cb = _side(rng, pb)
    n = min(pa, pb)
    for j in range(len(cb)):
        i = (j + 2) % len(ca)
        noise = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
        for _ in range(3):
            noise &= rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
        b[j, :n] = a[i, :n] ^ noise
    b[1, 0] = a[1, 0]  # both one-frame videos: a duplicate scoring 100
    a[-1, 0] = 0  # a real all-zero frame (video of pa frames)
    b[-1, pb - 1] = 0  # and one at the last frame of the pb-frame video
    a[np.arange(pa)[None, :] >= ca[:, None]] = 0  # padding: all-zero words
    b[np.arange(pb)[None, :] >= cb[:, None]] = 0
    return a, ca, b, cb


def _jax_reference(a, ca, b, cb, pa, pb):
    xla = similarity_block_xla(
        jnp.asarray(unpack_pm1_host(a, ca)), jnp.asarray(ca[:, None]),
        jnp.asarray(unpack_pm1_host(b, cb)), jnp.asarray(cb[:, None]), pa, pb,
    )
    tile = _tile_similarity(
        jnp.asarray(a), jnp.asarray(ca), jnp.asarray(b), jnp.asarray(cb), pa, pb
    )
    return np.asarray(xla), np.asarray(tile)


def _torch_args(a, ca, b, cb, device):
    return (
        torch.from_numpy(a.view(np.int32)).to(device),
        torch.from_numpy(ca).to(device),
        torch.from_numpy(b.view(np.int32)).to(device),
        torch.from_numpy(cb).to(device),
    )


@pytest.mark.parametrize("pa, pb", PADS)
def test_plain_equals_the_jax_twin_and_tile(pa, pb):
    a, ca, b, cb = _inputs(pa, pb)
    xla, tile = _jax_reference(a, ca, b, cb, pa, pb)
    args = _torch_args(a, ca, b, cb, "cpu")
    got = sb.similarity_block_plain(*args, pa, pb)
    assert got.dtype == torch.int32 and got.shape == (len(ca), len(cb))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), tile)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = sb.LAUNCHES["similarity_block"]
    assert torch.equal(sb.similarity_block(*args, pa, pb), got)
    assert sb.LAUNCHES["similarity_block"] == before
    sims = got.numpy()
    assert sims[1, 1] == 100  # the one-frame duplicate
    assert (sims[0] == 0).all() and (sims[:, 0] == 0).all()  # empty videos
    if pa > 1 and pb > 1:
        assert ((sims > 0) & (sims < 100)).any()


def test_plain_in_column_chunks_is_the_same_block(monkeypatch):
    """The plain version materialises its products in column chunks; one
    video per chunk gives the same block."""
    a, ca, b, cb = _inputs(64, 1024)
    args = _torch_args(a, ca, b, cb, "cpu")
    whole = sb.similarity_block_plain(*args, 64, 1024)
    monkeypatch.setattr(sb, "PLAIN_CHUNK_ENTRIES", 1)
    assert torch.equal(sb.similarity_block_plain(*args, 64, 1024), whole)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, ca, b, cb = _inputs(4, 4)
    args = _torch_args(a, ca, b, cb, "cpu")
    with pytest.raises(ValueError, match="pads"):
        sb.similarity_block(*args, 4, 2048)
    with pytest.raises(ValueError, match="rows must be"):
        sb.similarity_block(*args, 8, 4)
    with pytest.raises(TypeError):
        sb.similarity_block(args[0].to(torch.int64), *args[1:], 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        sb.similarity_block(args[0], args[1], args[2].transpose(0, 1), args[3], 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        sb.similarity_block(*(t.to("meta") for t in args), 4, 4)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the similarity block kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pa, pb", PADS)
def test_kernel_equals_plain_on_cuda(cuda_device, pa, pb):
    """On the card: one launch per call, bit-equal to the plain version in
    both directions (pb > pa runs with the long side as the kernel's rows)."""
    a, ca, b, cb = _inputs(pa, pb)
    args = _torch_args(a, ca, b, cb, cuda_device)
    before = sb.LAUNCHES["similarity_block"]
    got = sb.similarity_block(*args, pa, pb)
    torch.cuda.synchronize()
    assert sb.LAUNCHES["similarity_block"] == before + 1
    assert torch.equal(got, sb.similarity_block_plain(*args, pa, pb))
    np.testing.assert_array_equal(got.cpu().numpy(), _jax_reference(a, ca, b, cb, pa, pb)[0])


def _flip(frame: np.ndarray, bits) -> np.ndarray:
    """A [8] uint32 frame with the given bit positions flipped."""
    out = frame.copy()
    for p in bits:
        out[p // 32] ^= np.uint32(1 << (p % 32))
    return out


def _edge_case(name: str):
    """(a, ca, b, cb, pa, pb, {(row, column): similarity}) of the cases a
    tiled product can get wrong."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rnd = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint32)  # noqa: E731
    if name == "distance":  # tol and tol + 1, in the first and the last k-step
        x = rnd(1, 1, 8)
        b = np.stack([
            _flip(x[0, 0], range(d) if first else range(256 - d, 256))[None]
            for first in (True, False) for d in (31, 32)
        ])
        return x, np.ones(1, np.int32), b, np.ones(4, np.int32), 1, 1, {
            (0, 0): 100, (0, 1): 0, (0, 2): 100, (0, 3): 0
        }
    if name == "last_element":
        # row frame 63 (row tile 0's last) equals frame 7 of column videos
        # 15 and 31: columns 127 and 255 of the B tile, the last of its two
        # halves; each is its tile's only match
        a, b = rnd(1, 64, 8), rnd(40, 8, 8)
        b[15, 7] = b[31, 7] = a[0, 63]
        return a, np.full(1, 64, np.int32), b, np.full(40, 8, np.int32), 64, 8, {
            (0, 15): 1, (0, 31): 1, (0, 16): 0
        }
    if name == "padding_beside_zero":
        # a real all-zero frame at the B tile's frame 99; frames 100..255 are
        # padding, the half 128..255 all of it; the row's real all-zero frame
        # matches the one, never the padding
        a, b = rnd(1, 16, 8), rnd(1, 256, 8)
        a[0, 3] = 0
        a[0, 10:] = 0
        b[0, 99:] = 0
        return a, np.full(1, 10, np.int32), b, np.full(1, 100, np.int32), 16, 256, {(0, 0): 1}
    raise KeyError(name)


EDGE_CASES = ["distance", "last_element", "padding_beside_zero"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_at_the_edge_cases(name):
    a, ca, b, cb, pa, pb, want = _edge_case(name)
    got = sb.similarity_block_plain(*_torch_args(a, ca, b, cb, "cpu"), pa, pb).numpy()
    np.testing.assert_array_equal(got, _jax_reference(a, ca, b, cb, pa, pb)[0])
    assert {k: int(got[k]) for k in want} == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_kernel_equals_plain_at_the_edge_cases_on_cuda(cuda_device, name):
    a, ca, b, cb, pa, pb, want = _edge_case(name)
    args = _torch_args(a, ca, b, cb, cuda_device)
    got = sb.similarity_block(*args, pa, pb)
    torch.cuda.synchronize()
    assert torch.equal(got, sb.similarity_block_plain(*args, pa, pb))
    assert {k: int(got[k]) for k in want} == want
