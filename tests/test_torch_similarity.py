"""The port's segment similarity kernel (TPU kernels 3 and 6) and kernel
2's counterpart against the JAX package.

The plain PyTorch versions must equal the JAX package's XLA twins exactly
(the way the JAX suite reaches those kernels on the CPU: the Pallas
kernels run only on a TPU): the similarities against
``similarity_segments_xla``, the counts against ``make_exists_kernel_xla``,
the every-step existence masks against ``make_exists_mask_kernel_xla``,
each with its invalid steps zeroed. The mask mode must equal the
thresholded, row-packed similarities, and agree with native
``matchHashBytes`` pair for pair. The CUDA kernels are compared with the
plain versions on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.ops import similarity_segments as jseg
from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes
from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel.engine import decode_mask_hits

from .test_torch_segments import _ragged_items

CPU = torch.device("cpu")
#: corpus positions of three one-frame probe videos: X, X at distance
#: exactly 31 (a match) and X at distance exactly 32 (none)
PROBE = 100


def _flip_bits(frame: np.ndarray, positions) -> np.ndarray:
    out = frame.copy()
    for p in positions:
        out[p // 8] ^= np.uint8(1 << (p % 8))
    return out


@pytest.fixture(scope="module")
def inputs():
    """Two row blocks (the first 200 videos) against three column steps of
    the whole 400-video corpus, step 1 invalid: ragged videos of 1-24
    frames, partial near copies (similarities across 0..100), an all-zero
    real video, an all-zero real frame, the distance-31/32 probes, padding
    frames and empty slots."""
    rng = np.random.default_rng(31)
    vids = [
        np.frombuffer(b, np.uint8).reshape(-1, 32).copy() for _, b in _ragged_items(rng, 400, 24)
    ]
    vids[5][:] = 0
    vids[9][0] = 0
    for k in range(0, 380, 4):  # video k+1 shares a prefix of k's frames
        n = int(rng.integers(1, min(len(vids[k]), len(vids[k + 1])) + 1))
        for f in range(n):
            flips = rng.choice(256, int(rng.integers(0, 13)), replace=False)
            vids[k + 1][f] = _flip_bits(vids[k][f], flips)
    x = rng.integers(0, 256, (1, 32), dtype=np.uint8)
    pos = rng.permutation(256)
    vids[PROBE : PROBE + 3] = [
        x, _flip_bits(x[0], pos[:31])[None], _flip_bits(x[0], pos[31:63])[None]
    ]
    items = [(i, v.tobytes()) for i, v in enumerate(vids)]

    n_steps = 3
    rblocks = seg.pack_blocks(items[:200], seg.ROW_FRAMES, seg.ROW_SLOTS)
    cblocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    assert len(rblocks) == 2 and 2 * seg.N_SPLIT < len(cblocks) <= n_steps * seg.N_SPLIT
    rp, ri, rc, rmap = seg.stack_blocks(rblocks, 2, seg.ROW_FRAMES, seg.ROW_SLOTS)
    cp, ci, cc, cmap = seg.stack_blocks(
        cblocks, n_steps * seg.N_SPLIT, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
    )
    valid = np.ones(n_steps, dtype=np.int32)
    valid[1] = 0
    return {
        "np": (rp, ri, rc, cp, ci, cc, valid),
        "maps": (rmap, cmap),
        "blobs": [b for _, b in items],
    }


def _torch_args(inputs, device):
    rp, ri, rc, cp, ci, cc, valid = inputs["np"]
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).reshape(x.shape[0])).to(device)

    return (
        ops_sim.to_words(rp, device), t(ri), t(rc),
        ops_sim.to_words(cp, device), t(ci), t(cc), t(valid),
    )


def _zero_invalid(x: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[rows, steps * STEP_SLOTS] with the invalid steps' columns zeroed."""
    x = x.reshape(x.shape[0], len(valid), seg.STEP_SLOTS).copy()
    x[:, valid == 0] = 0
    return x.reshape(x.shape[0], -1)


def _pack_rows(hit: np.ndarray) -> np.ndarray:
    """[rows, cols] bool -> row-packed int32 words: bit b of [w, c] is
    hit[32w+b, c]."""
    bits = hit.reshape(-1, 32, hit.shape[1]).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)[:, None]).sum(axis=1)
    return words.astype(np.uint32).view(np.int32)


def _jax_pm1(inputs):
    rp, ri, _, cp, ci, _, _ = inputs["np"]
    return (
        jseg.unpack_blocks_pm1(jnp.asarray(rp), jnp.asarray(ri)),
        jseg.unpack_blocks_pm1(jnp.asarray(cp), jnp.asarray(ci)),
    )


@pytest.fixture(scope="module")
def jax_sims(inputs):
    """The JAX package's XLA twin of kernel 3, invalid steps zeroed."""
    _, ri, rc, _, ci, cc, valid = inputs["np"]
    rf, cf = _jax_pm1(inputs)
    sims = jseg.similarity_segments_xla(
        rf, jnp.asarray(ri), jnp.asarray(rc), cf, jnp.asarray(ci), jnp.asarray(cc)
    )
    return _zero_invalid(np.asarray(sims), valid)


@pytest.fixture(scope="module")
def plain_sims(inputs):
    return seg.similarity_segments_plain(*_torch_args(inputs, CPU)).numpy()


def test_plain_sims_match_xla_twin(plain_sims, jax_sims):
    assert plain_sims.shape == (2 * seg.ROW_SLOTS, 3 * seg.STEP_SLOTS)
    assert np.array_equal(plain_sims, jax_sims)
    assert (plain_sims == 100).sum() > 150  # self pairs (empty slots stay 0)
    assert ((plain_sims > 0) & (plain_sims < 100)).sum() > 20  # partial copies
    assert not plain_sims[:, seg.STEP_SLOTS : 2 * seg.STEP_SLOTS].any()  # invalid step


def _slot(slot_map: np.ndarray, video: int) -> int:
    (pos,) = np.nonzero(slot_map == video)
    return int(pos[0])


def test_distance_31_matches_and_32_does_not(inputs, plain_sims, jax_sims):
    rmap, cmap = inputs["maps"]
    blobs = inputs["blobs"]
    x = _slot(rmap, PROBE)
    at31, at32 = _slot(cmap, PROBE + 1), _slot(cmap, PROBE + 2)
    assert at31 < seg.STEP_SLOTS and at32 < seg.STEP_SLOTS  # in the valid step 0
    assert matchHashBytes(blobs[PROBE], blobs[PROBE + 1]) == 100
    assert matchHashBytes(blobs[PROBE], blobs[PROBE + 2]) == 0
    for sims in (plain_sims, jax_sims):
        assert sims[x, at31] == 100 and sims[x, at32] == 0


@pytest.mark.parametrize("min_sim", [1, 26, 75])
def test_plain_mask_is_the_thresholded_sims(inputs, jax_sims, min_sim):
    got = seg.similarity_mask_plain(*_torch_args(inputs, CPU), min_sim).numpy()
    assert got.shape == (2 * seg.MASK_WORDS, 3 * seg.STEP_SLOTS)
    assert np.array_equal(got, _pack_rows(jax_sims >= min_sim))


@pytest.mark.parametrize("min_sim", [26, 75])
def test_mask_bits_agree_with_match_hash_bytes(inputs, min_sim):
    """Every set bit is a pair whose matchHashBytes similarity reaches
    min_sim, and every such pair of a valid step sets its bit."""
    rmap, cmap = inputs["maps"]
    blobs = inputs["blobs"]
    valid = inputs["np"][-1]
    mask = seg.similarity_mask_plain(*_torch_args(inputs, CPU), min_sim).numpy()
    w, c = np.nonzero(mask)
    rows, cols = decode_mask_hits(w, c, mask[w, c])
    got = set(zip(rmap[rows].tolist(), cmap[cols].tolist()))
    live_cols = [int(j) for k, j in enumerate(cmap) if j >= 0 and valid[k // seg.STEP_SLOTS]]
    want = {
        (i, j)
        for i in rmap[rmap >= 0].tolist()
        for j in live_cols
        if matchHashBytes(blobs[i], blobs[j]) >= min_sim
    }
    assert got == want
    assert len({(i, j) for i, j in want if i != j}) >= 10


@pytest.mark.parametrize("tol", [31, 79])
def test_plain_counts_match_xla_twin(inputs, tol):
    _, ri, _, _, ci, _, valid = inputs["np"]
    a, sa, _, b, sb, _, v = _torch_args(inputs, CPU)
    got = seg.exists_counts_plain(a, sa, b, sb, v, tol).numpy()
    rf, cf = _jax_pm1(inputs)
    dummy = jnp.zeros((1, 1), jnp.int32)
    twin = jseg.make_exists_kernel_xla(tol)
    want = twin(rf, jnp.asarray(ri), dummy, cf, jnp.asarray(ci), dummy)
    want = _zero_invalid(np.asarray(want), valid)
    assert np.array_equal(got, want)
    assert (got > 1).sum() > 20  # several row frames of one slot match


def test_exists_mask_kernel_matches_xla_twin_with_every_step_valid(inputs):
    """Kernel 2's counterpart: the sweep with no invalid step."""
    _, ri, _, _, ci, _, _ = inputs["np"]
    a, sa, _, b, sb, _, _ = _torch_args(inputs, CPU)
    before = seg.LAUNCHES["exists_mask_kernel"]
    got = seg.exists_mask_kernel(a, sa, b, sb, 79).numpy()
    assert seg.LAUNCHES["exists_mask_kernel"] == before  # the plain version ran
    rf, cf = _jax_pm1(inputs)
    dummy = jnp.zeros((1, 1), jnp.int32)
    twin = jseg.make_exists_mask_kernel_xla(79)
    want = twin(rf, jnp.asarray(ri), dummy, cf, jnp.asarray(ci), dummy)
    assert np.array_equal(got, np.asarray(want).view(np.int32))
    assert got[:, seg.STEP_SLOTS : 2 * seg.STEP_SLOTS].any()  # step 1 is swept too


def test_wrappers_take_the_plain_versions_for_cpu_tensors(inputs, plain_sims):
    args = _torch_args(inputs, CPU)
    a, sa, _, b, sb, _, v = args
    before = dict(seg.LAUNCHES)
    assert np.array_equal(seg.similarity_segments(*args).numpy(), plain_sims)
    assert torch.equal(seg.similarity_segments(*args, 75), seg.similarity_mask_plain(*args, 75))
    assert torch.equal(seg.exists_counts(a, sa, b, sb, v, 31), seg.exists_counts_plain(a, sa, b, sb, v, 31))
    assert seg.LAUNCHES == before  # no kernel ran


def test_wrappers_reject_what_the_kernel_does_not_take(inputs):
    a, sa, ca, b, sb, cb, v = _torch_args(inputs, CPU)
    with pytest.raises(ValueError, match="min_sim"):
        seg.similarity_segments(a, sa, ca, b, sb, cb, v, 0)
    with pytest.raises(ValueError, match="tolerance"):
        seg.exists_counts(a, sa, b, sb, v, 128)
    with pytest.raises(ValueError, match="frame count per slot"):
        seg.similarity_segments(a, sa, ca[:100], b, sb, cb, v)
    with pytest.raises(ValueError, match="missing"):
        seg.similarity_segments(a, sa, None, b, sb, cb, v)
    with pytest.raises(TypeError):
        seg.similarity_segments(a, sa, ca, b, sb, cb.to(torch.int64), v, 75)
    with pytest.raises(ValueError, match="contiguous"):
        seg.similarity_segments(a, sa, ca, b.T.contiguous().T, sb, cb, v)
    with pytest.raises(ValueError, match="one flag per column step"):
        seg.similarity_segments(a, sa, ca, b, sb, cb, v[:2])
    with pytest.raises(ValueError, match="b_words"):
        seg.exists_mask_kernel(a, sa, b[: seg.STEP_FRAMES * 2 + 8], sb, 79)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


#: mode -> (wrapper and its launch counter, plain version, the call's last args)
CUDA_MODES = {
    "sims": ("similarity_segments", "similarity_segments_plain", ()),
    "mask1": ("similarity_segments", "similarity_mask_plain", (1,)),
    "mask75": ("similarity_segments", "similarity_mask_plain", (75,)),
    "counts31": ("exists_counts", "exists_counts_plain", (31,)),
    "counts79": ("exists_counts", "exists_counts_plain", (79,)),
    "exists_mask_kernel": ("exists_mask_kernel", "exists_mask_kernel_plain", (79,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(CUDA_MODES))
def test_kernel_matches_plain_on_cuda(inputs, cuda_device, mode, monkeypatch):
    """Each mode of the CUDA kernels is bit-equal to its plain version, and
    a CUDA tensor never reaches the plain version inside the wrapper."""
    wrapper, plain, extra = CUDA_MODES[mode]
    a, sa, ca, b, sb, cb, v = _torch_args(inputs, cuda_device)
    if wrapper == "similarity_segments":
        args = (a, sa, ca, b, sb, cb, v, *extra)
    elif wrapper == "exists_counts":
        args = (a, sa, b, sb, v, *extra)
    else:
        args = (a, sa, b, sb, *extra)
    want = getattr(seg, plain)(*args)

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(seg, plain, refuse)
    monkeypatch.setattr(seg, "exists_mask_sweep_plain", refuse)
    before = seg.LAUNCHES[wrapper]
    got = getattr(seg, wrapper)(*args)
    torch.cuda.synchronize()
    assert seg.LAUNCHES[wrapper] == before + 1
    assert torch.equal(got, want)
