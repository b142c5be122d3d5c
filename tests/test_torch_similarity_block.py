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

#: (pa, pb): both sides small, long rows against each column size the
#: route sees, the long-column direction, and long against long
PADS = [(4, 4), (1024, 1), (1024, 64), (64, 1024), (1024, 1024)]


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
