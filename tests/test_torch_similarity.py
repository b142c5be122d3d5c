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

from hydrus_video_deduplicator_tpu.ops import similarity as jsim
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


def _records(hits: torch.Tensor) -> tuple[int, np.ndarray]:
    """A hit list's count and its records (those written), sorted by row
    slot then column slot."""
    n = int(seg.hit_count(hits))
    rec = hits[1 : 1 + min(n, hits.shape[0] - 1)].cpu().numpy()
    return n, rec[np.lexsort((rec[:, 1], rec[:, 0]))]


def _assert_hit_list(hits: torch.Tensor, sims: np.ndarray, min_sim: int) -> None:
    """The hit list holds exactly the positions and values of sims >= min_sim."""
    n, rec = _records(hits)
    want = np.argwhere(sims >= min_sim)  # row-major: sorted as _records sorts
    assert n == len(want) > 0
    assert np.array_equal(rec[:, :2], want)
    assert np.array_equal(rec[:, 2], sims[want[:, 0], want[:, 1]])


@pytest.mark.parametrize("min_sim", [1, 26, 75])
def test_plain_hit_list_is_the_thresholded_sims(inputs, plain_sims, min_sim):
    """The plain mask mode's hit list: every slot pair at or above min_sim
    once, with its similarity, the invalid step's none; the mask as
    without a list."""
    args = _torch_args(inputs, CPU)
    hits = seg.hit_list(plain_sims.size, CPU)
    mask = seg.similarity_segments(*args, min_sim, hits)
    assert torch.equal(mask, seg.similarity_mask_plain(*args, min_sim))
    _assert_hit_list(hits, plain_sims, min_sim)


def test_plain_hit_list_counts_past_its_capacity(inputs, plain_sims):
    """A list shorter than the hits: the count is every hit, the records
    written fill the capacity with distinct hits, nothing lies past it."""
    args = _torch_args(inputs, CPU)
    want = {tuple(p) for p in np.argwhere(plain_sims >= 1).tolist()}
    store = torch.full((len(want) + 1, 3), -7, dtype=torch.int32)
    cap = len(want) // 3
    seg.similarity_segments(*args, 1, store[: cap + 1])
    n, rec = _records(store[: cap + 1])
    assert n == len(want) and len(rec) == cap
    assert len({tuple(r) for r in rec[:, :2].tolist()}) == cap
    assert {tuple(r) for r in rec[:, :2].tolist()} <= want
    assert (store[cap + 1 :] == -7).all()


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
    with pytest.raises(ValueError, match="mask mode"):
        seg.similarity_segments(a, sa, ca, b, sb, cb, v, None, seg.hit_list(4, CPU))
    with pytest.raises(TypeError):
        seg.similarity_segments(a, sa, ca, b, sb, cb, v, 75, seg.hit_list(4, CPU).long())
    with pytest.raises(ValueError, match="capacity"):
        seg.similarity_segments(a, sa, ca, b, sb, cb, v, 75, torch.zeros(5, 4, dtype=torch.int32))


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


@pytest.mark.cuda
@pytest.mark.parametrize("min_sim", [1, 75])
def test_kernel_hit_list_is_the_thresholded_sims_on_cuda(inputs, cuda_device, min_sim):
    """Kernel 3's hit list in mask mode, sorted: the positions and values
    of its own sims mode at or above min_sim (the plain version's too),
    and its mask bit-equal to the mask without a list."""
    args = _torch_args(inputs, cuda_device)
    sims = seg.similarity_segments(*args)
    hits = seg.hit_list(sims.numel(), cuda_device)
    mask = seg.similarity_segments(*args, min_sim, hits)
    torch.cuda.synchronize()
    assert torch.equal(mask, seg.similarity_segments(*args, min_sim))
    sims = sims.cpu().numpy()
    assert np.array_equal(sims, seg.similarity_segments_plain(*_torch_args(inputs, CPU)).numpy())
    _assert_hit_list(hits, sims, min_sim)


# ---------------------------------------------------------------------------
# The ±1 identity the tensor-core kernels rest on, and the cases a tiled
# product can get wrong
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_distances(inputs):
    """Hamming distances [row frames, column frames] of the packed inputs by
    popcount of the XOR, the ±1 dots of unpack_blocks_pm1 (zero rows for
    padding) and the frames' liveness."""
    rp, ri, _, cp, ci, _, _ = inputs["np"]
    dist = np.empty((rp.shape[0], cp.shape[0]), np.int32)
    for r0 in range(0, rp.shape[0], 256):
        dist[r0 : r0 + 256] = np.bitwise_count(rp[r0 : r0 + 256, None, :] ^ cp[None]).sum(-1)
    a, sa, _, b, sb, _, _ = _torch_args(inputs, CPU)
    dot = torch.matmul(
        seg.unpack_blocks_pm1(a, sa, torch.float32), seg.unpack_blocks_pm1(b, sb, torch.float32).T
    )
    return dist, dot.to(torch.int32).numpy(), ri >= 0, ci >= 0


@pytest.mark.parametrize("tol", [0, 31, 79, 127])
def test_pm1_dot_threshold_is_the_popcount_match(frame_distances, tol):
    """dot >= 256 - 2*tol of the ±1 rows, padding as zero rows, matches
    exactly the real frame pairs at popcount(xor) <= tol; real all-zero
    frames (all -1, not zero) match like any other frame."""
    dist, dot, live_a, live_b = frame_distances
    want = (dist <= tol) & live_a[:, None] & live_b[None, :]
    assert np.array_equal(dot >= ops_sim.BITS - 2 * tol, want)
    assert want.any() and (want != (dist <= tol)).any()  # padding would match at distance 0


@pytest.fixture(scope="module")
def binary_distances(inputs):
    """The kernels' distance (csrc/hamming_mma.cuh), computed with numpy on
    the packed inputs: popc(a & ~b) + popc(~a & b), where a padding frame
    (slot id -1) has all ones in its words and in their complement."""
    rp, ri, _, cp, ci, _, _ = inputs["np"]
    ones = np.uint32(0xFFFFFFFF)

    def planes(x, slots):
        live = (slots >= 0)[:, None]
        return np.where(live, x, ones), np.where(live, ~x, ones)

    (a, na), (b, nb) = planes(rp, ri), planes(cp, ci)
    out = np.empty((rp.shape[0], cp.shape[0]), np.int32)
    for r0 in range(0, rp.shape[0], 256):
        rs = slice(r0, r0 + 256)
        out[rs] = np.bitwise_count(a[rs, None] & nb[None]).sum(-1, dtype=np.int32)
        out[rs] += np.bitwise_count(na[rs, None] & b[None]).sum(-1, dtype=np.int32)
    return out


@pytest.mark.parametrize("tol", [0, 31, 79, 127])
def test_the_kernels_binary_distance_is_the_popcount_match(frame_distances, binary_distances, tol):
    """popc(a & ~b) + popc(~a & b) - (tol + 1) < 0, the sign the kernels
    vote on, holds exactly for the real pairs within tol: a real pair's
    value is its distance, and padding on either side is at least 256."""
    dist, _, live_a, live_b = frame_distances
    real = live_a[:, None] & live_b[None, :]
    assert np.array_equal(binary_distances[real], dist[real])
    assert binary_distances[~real].min() >= 256
    assert np.array_equal(binary_distances - (tol + 1) < 0, (dist <= tol) & real)


def _flipped(x: np.ndarray, d: int, last: bool) -> np.ndarray:
    """x at distance d, the flipped bits in the first (words 0, 1, ...) or
    the last (words 7, 6, ...) k-steps of the kernels' product."""
    return _flip_bits(x, range(256 - d, 256) if last else range(d))


def _edge_videos(rng):
    """(row videos, column videos, expectations) of the edge cases, each
    video [n, 32] uint8 frames; an expectation is (mode, row video, column
    video, value) on the output."""
    rnd = lambda n: rng.integers(0, 256, (n, 32), dtype=np.uint8)  # noqa: E731
    x = rnd(1)
    rows = [
        x,  # 0: one frame at rows 0, in row tile 0
        rnd(62),  # 1: rows 1..62
        rnd(60),  # 2: rows 63..122, straddling row tile 0 and 1
        np.zeros((1, 32), np.uint8),  # 3: a real all-zero frame, row 123
    ]
    rows.append(rnd(128 - 124))  # 4: rows 124..127, its last frame the last of row tile 1
    cols, want = [], []
    for last in (False, True):  # distance tol and tol + 1 in the first and the last k-step
        for d, at31, at79 in ((31, 1, 1), (32, 0, 1), (79, 0, 1), (80, 0, 0)):
            want += [("counts31", 0, len(cols), at31), ("counts79", 0, len(cols), at79)]
            want += [("sweep31", 0, len(cols), at31), ("sweep79", 0, len(cols), at79)]
            cols.append(_flipped(x[0], d, last)[None])
    # a column video ending at column 127 (the first quarter's last) whose
    # last frame equals row 127 (row tile 1's last): the only match of
    # (row tile 1, quarter 0) is its last element
    last = rnd(128 - len(cols))
    last[-1] = rows[4][-1]
    want += [("counts31", 4, len(cols), 1), ("sweep31", 4, len(cols), 1)]
    cols.append(last)
    # an all-zero real frame at column 128, beside quarters 2 and 3 all
    # padding: it matches the real all-zero row frame, the padding does not
    want += [("counts31", 3, len(cols), 1), ("sims", 3, len(cols), 100)]
    want += [("sweep31", 3, len(cols), 1), ("sweep79", 3, len(cols), 1)]
    cols.append(np.zeros((1, 32), np.uint8))
    # the straddling video's frames on each side of row 64
    want += [("counts31", 2, len(cols), 1), ("counts31", 2, len(cols) + 1, 10)]
    want += [("sweep31", 2, len(cols), 1), ("sweep31", 2, len(cols) + 1, 1)]
    cols += [rows[2][:1], rows[2][50:60]]
    return rows, cols, want


@pytest.fixture(scope="module")
def edge_case():
    """One row block of the edge rows against one column step whose first
    chunk holds the edge columns (140 frames: quarters 2 and 3 padding) and
    whose second chunk holds copies of every row video."""
    rows, cols, want = _edge_videos(np.random.default_rng(5))
    assert sum(len(c) for c in cols) == 140
    ritems = [(k, v.tobytes()) for k, v in enumerate(rows)]
    citems = [(k, v.tobytes()) for k, v in enumerate(cols)]
    citems += [(len(cols) + k, v.tobytes()) for k, v in enumerate(rows)]
    rblocks = seg.pack_blocks(ritems, seg.ROW_FRAMES, seg.ROW_SLOTS)
    chunk0 = seg.pack_blocks(citems[: len(cols)], seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    chunk1 = seg.pack_blocks(citems[len(cols) :], seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    assert len(rblocks) == len(chunk0) == len(chunk1) == 1
    rp, ri, rc, rmap = seg.stack_blocks(rblocks, 1, seg.ROW_FRAMES, seg.ROW_SLOTS)
    cp, ci, cc, cmap = seg.stack_blocks(
        chunk0 + chunk1, seg.N_SPLIT, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
    )
    np_args = (rp, ri, rc, cp, ci, cc, np.ones(1, np.int32))
    return {"np": np_args}, rmap, cmap, want


def _edge_outputs(case, device):
    inputs = case[0]
    a, sa, ca, b, sb, cb, v = _torch_args(inputs, device)
    return {
        "sims": seg.similarity_segments(a, sa, ca, b, sb, cb, v),
        "mask1": seg.similarity_segments(a, sa, ca, b, sb, cb, v, 1),
        "counts31": seg.exists_counts(a, sa, b, sb, v, 31),
        "counts79": seg.exists_counts(a, sa, b, sb, v, 79),
        "sweep31": seg.exists_mask_sweep(a, sa, b, sb, v, 31),
        "sweep79": seg.exists_mask_sweep(a, sa, b, sb, v, 79),
    }


def _at(out: torch.Tensor, mode: str, row_slot: int, col: int) -> int:
    """The output of ``mode`` for (row slot, column): a count or a
    similarity, or the bit of a row-packed mask (sweep, mask)."""
    if mode.startswith(("sweep", "mask")):
        return (int(out[row_slot // 32, col]) >> (row_slot % 32)) & 1
    return int(out[row_slot, col])


def test_plain_versions_at_the_edge_cases(edge_case):
    """The expectations of the edge cases hold on the plain versions, so
    the card's comparison with them tests each case."""
    _, rmap, cmap, want = edge_case
    got = _edge_outputs(edge_case, CPU)
    for mode, i, j, value in want:
        assert _at(got[mode], mode, _slot(rmap, i), _slot(cmap, j)) == value, (mode, i, j)
    n_cols = max(j for _, _, j, _ in want) + 1
    for i in range(5):  # every row video matches its own copy in chunk 1
        assert got["sims"][_slot(rmap, i), _slot(cmap, n_cols + i)] == 100
        assert _at(got["sweep31"], "sweep31", _slot(rmap, i), _slot(cmap, n_cols + i)) == 1
    # the tile of row tile 1 and column quarter 0 holds one match, its last element
    rp, ri, _, cp, ci, _, _ = edge_case[0]["np"]
    dist = np.bitwise_count(rp[64:128, None, :] ^ cp[None, :128]).sum(-1)
    hits = (dist <= 31) & (ri[64:128, None] >= 0) & (ci[None, :128] >= 0)
    assert list(zip(*np.nonzero(hits))) == [(63, 127)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sims", "mask1", "counts31", "counts79", "sweep31", "sweep79"])
def test_kernel_matches_plain_at_the_edge_cases_on_cuda(edge_case, cuda_device, mode):
    """Distance tol and tol + 1 in the first and the last k-step, a row slot
    straddling two 64-row tiles, a tile whose only match is its last
    element, all-padding tiles beside a real all-zero frame."""
    got = _edge_outputs(edge_case, cuda_device)[mode]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _edge_outputs(edge_case, CPU)[mode])


@pytest.fixture(scope="module")
def dense_tile():
    """One row block and one column step holding the same 2,048 frames (256
    row videos, 4 x 64 column videos, 8 frames each), every frame within 24
    bits of one base frame: every frame pair matches at tolerance 31, so
    every fragment of every vote takes the kernels' slow path."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, 32, dtype=np.uint8)
    frames = np.stack(
        [_flip_bits(base, rng.choice(256, int(rng.integers(0, 13)), replace=False)) for _ in range(2048)]
    )
    items = [(k, frames[8 * k : 8 * k + 8].tobytes()) for k in range(256)]
    rblocks = seg.pack_blocks(items, seg.ROW_FRAMES, seg.ROW_SLOTS)
    cblocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    assert len(rblocks) == 1 and len(cblocks) == seg.N_SPLIT
    rp, ri, _, _ = seg.stack_blocks(rblocks, 1, seg.ROW_FRAMES, seg.ROW_SLOTS)
    cp, ci, _, _ = seg.stack_blocks(cblocks, seg.N_SPLIT, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    assert (ri >= 0).all() and (ci >= 0).all()
    return rp, ri, cp, ci


def _dense_args(dense_tile, device):
    """Kernel 3's arguments on the dense tile: 256 row and 256 column
    videos of 8 frames."""
    rp, ri, cp, ci = dense_tile
    eights = torch.full((seg.ROW_SLOTS,), 8, dtype=torch.int32, device=device)
    return (
        ops_sim.to_words(rp, device), torch.from_numpy(ri).to(device), eights,
        ops_sim.to_words(cp, device), torch.from_numpy(ci).to(device), eights.clone(),
        torch.ones(1, dtype=torch.int32, device=device),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("min_sim", [1, 75])
def test_kernel_hit_list_at_the_edge_cases_and_on_a_dense_tile_on_cuda(
    edge_case, dense_tile, cuda_device, min_sim
):
    """The hit list against the sims mode at the edge cases (padding
    quarters beside a real all-zero frame, a tile whose only match is its
    last element, a slot straddling two row tiles) and on the dense
    self-diagonal tile, where every one of the 65,536 slot pairs is a hit
    and every warp of the epilogue reserves its 32 words' hits at once."""
    for args in (_torch_args(edge_case[0], cuda_device), _dense_args(dense_tile, cuda_device)):
        sims = seg.similarity_segments(*args)
        hits = seg.hit_list(sims.numel(), cuda_device)
        seg.similarity_segments(*args, min_sim, hits)
        torch.cuda.synchronize()
        _assert_hit_list(hits, sims.cpu().numpy(), min_sim)
    assert int(seg.hit_count(hits)) == seg.ROW_SLOTS * seg.STEP_SLOTS


@pytest.mark.cuda
def test_kernel_hit_list_counts_past_its_capacity_on_cuda(dense_tile, cuda_device):
    """A list shorter than the dense tile's 65,536 hits: the count is exact,
    the capacity is filled with distinct hits of 100, and nothing is
    written past it; the mask is whole."""
    args = _dense_args(dense_tile, cuda_device)
    n_hits = seg.ROW_SLOTS * seg.STEP_SLOTS
    store = torch.full((n_hits + 1, 3), -7, dtype=torch.int32, device=cuda_device)
    for cap in (0, 1, 1000, n_hits - 1):
        store.fill_(-7)
        mask = seg.similarity_segments(*args, 75, store[: cap + 1])
        torch.cuda.synchronize()
        assert (mask == -1).all()
        n, rec = _records(store[: cap + 1])
        assert n == n_hits and len(rec) == cap
        assert len({tuple(r) for r in rec[:, :2].tolist()}) == cap and (rec[:, 2] == 100).all()
        assert ((rec[:, :2] >= 0) & (rec[:, :2] < seg.ROW_SLOTS)).all()
        assert (store[cap + 1 :] == -7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [31, 79])
def test_sweep_kernel_matches_plain_on_a_dense_tile_on_cuda(dense_tile, cuda_device, tol):
    rp, ri, cp, ci = dense_tile
    args = (
        ops_sim.to_words(rp, cuda_device), torch.from_numpy(ri).to(cuda_device),
        ops_sim.to_words(cp, cuda_device), torch.from_numpy(ci).to(cuda_device),
        torch.ones(1, dtype=torch.int32, device=cuda_device),
    )
    want = seg.exists_mask_sweep_plain(*args, tol)
    assert (want == -1).all()  # every slot pair holds a match
    got = seg.exists_mask_sweep(*args, tol)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The reference functions of ops/similarity.py (test oracles) against the
# JAX package's: exact integer equality on the same numpy inputs
# ---------------------------------------------------------------------------

#: frames per video of the reference inputs: two empty videos (0)
REF_COUNTS_A = [3, 0, 5, 1, 4, 0, 2]
REF_COUNTS_B = [2, 4, 0, 1, 6]
#: padding frames after the real ones, each with the out-of-range video id
REF_PAD = 3


@pytest.fixture(scope="module")
def reference_inputs():
    """Two sides of ragged videos (empty ones included) with padding frames
    carrying the out-of-range video id, and frames of side b at Hamming
    distance exactly 31 and 32 from frames of side a, an all-zero frame on
    each side, and a near copy of one video."""
    rng = np.random.default_rng(67)

    def side(counts):
        frames = rng.integers(0, 256, (sum(counts) + REF_PAD, 32), dtype=np.uint8)
        ids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        return frames, np.concatenate([ids, np.full(REF_PAD, len(counts), np.int32)])

    a, a_ids = side(REF_COUNTS_A)
    b, b_ids = side(REF_COUNTS_B)
    b[0] = _flip_bits(a[0], rng.choice(256, 31, replace=False))  # a0-b0: 31, a match
    b[1] = _flip_bits(a[1], rng.choice(256, 32, replace=False))  # a1-b1: 32, none
    a[3] = 0
    b[6] = 0
    first_a = int(np.flatnonzero(a_ids == 4)[0])
    first_b = int(np.flatnonzero(b_ids == 4)[0])
    for f in range(4):  # b's video 4 starts as a near copy of a's video 4
        b[first_b + f] = _flip_bits(a[first_a + f], rng.choice(256, int(rng.integers(0, 20))))
    return {
        "a": a, "b": b, "a_ids": a_ids, "b_ids": b_ids,
        "a_counts": np.array(REF_COUNTS_A, np.int32), "b_counts": np.array(REF_COUNTS_B, np.int32),
    }


def _reference_distances(ref) -> np.ndarray:
    return np.bitwise_count(ref["a"][:, None, :] ^ ref["b"][None, :, :]).sum(-1).astype(np.int32)


@pytest.mark.parametrize("name", ["hamming_tile", "hamming_tile_packed", "hamming_tile_popcount"])
def test_hamming_tiles_equal_the_jax_package(reference_inputs, name):
    """Each tile function on the ±1 rows or the packed words gives the JAX
    function's int32 distances exactly, and both equal popcount(xor)."""
    a = ops_sim.blobs_to_packed(reference_inputs["a"].tobytes()).copy()
    b = ops_sim.blobs_to_packed(reference_inputs["b"].tobytes()).copy()
    if name == "hamming_tile":
        ours = tuple(ops_sim.unpack_pm1(ops_sim.to_words(x, CPU)) for x in (a, b))
        theirs = (jsim.unpack_pm1(jnp.asarray(a)), jsim.unpack_pm1(jnp.asarray(b)))
    else:
        ours = (ops_sim.to_words(a, CPU), ops_sim.to_words(b, CPU))
        theirs = (jnp.asarray(a), jnp.asarray(b))
    got = getattr(ops_sim, name)(*ours)
    want = np.asarray(getattr(jsim, name)(*theirs))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    dist = _reference_distances(reference_inputs)
    assert np.array_equal(want, dist)
    assert dist[0, 0] == 31 and dist[1, 1] == 32


@pytest.mark.parametrize("tol", [31, 79])
def test_video_pair_similarity_equals_the_jax_package(reference_inputs, tol):
    """The video-level match fractions from one frame tile: equal to the
    JAX function's, 0 for empty videos, and padding frames (the out-of-range
    id) counted nowhere; at tolerance 31 distance 31 matches and 32 does
    not."""
    ref = reference_inputs
    ham = _reference_distances(ref)
    num_a, num_b = len(REF_COUNTS_A), len(REF_COUNTS_B)
    got = ops_sim.video_pair_similarity(
        torch.from_numpy(ham), torch.from_numpy(ref["a_ids"]), torch.from_numpy(ref["b_ids"]),
        torch.from_numpy(ref["a_counts"]), torch.from_numpy(ref["b_counts"]), num_a, num_b, tol,
    )
    want = np.asarray(
        jsim.video_pair_similarity(
            jnp.asarray(ham), jnp.asarray(ref["a_ids"]), jnp.asarray(ref["b_ids"]),
            jnp.asarray(ref["a_counts"]), jnp.asarray(ref["b_counts"]), num_a, num_b, tol,
        )
    )
    assert got.dtype == torch.int32 and got.shape == (num_a, num_b)
    assert np.array_equal(got.numpy(), want)
    empty_a, empty_b = ref["a_counts"] == 0, ref["b_counts"] == 0
    assert (want[empty_a] == 0).all() and (want[:, empty_b] == 0).all()
    assert want.max() > 0
    if tol == 31:
        # a0 (video 0, 3 frames) meets b0 (video 0, 2 frames) at 31 only;
        # a1 (same video) meets b1 at 32, no match
        assert want[0, 0] == min(100 * 1 // 3, 100 * 1 // 2)


def test_int_similarity_to_distance_equals_the_jax_package():
    sims = np.arange(0, 101, dtype=np.int32)
    got = ops_sim.int_similarity_to_distance(torch.from_numpy(sims))
    want = np.asarray(jsim.int_similarity_to_distance(jnp.asarray(sims)))
    assert np.array_equal(got.numpy(), want)
    assert got[0] == 101 and got[100] == 1


@pytest.mark.cuda
def test_reference_functions_on_cuda_equal_the_cpu(reference_inputs, cuda_device):
    """On the card the oracles' integer products go through float64: the
    same integers as on the CPU."""
    ref = reference_inputs
    a = ops_sim.blobs_to_packed(ref["a"].tobytes()).copy()
    b = ops_sim.blobs_to_packed(ref["b"].tobytes()).copy()
    for name in ("hamming_tile_packed", "hamming_tile_popcount"):
        got, want = (
            getattr(ops_sim, name)(ops_sim.to_words(a, dev), ops_sim.to_words(b, dev))
            for dev in (cuda_device, CPU)
        )
        assert torch.equal(got.cpu(), want), name
    args = [ref[k] for k in ("a_ids", "b_ids", "a_counts", "b_counts")]
    ham = torch.from_numpy(_reference_distances(ref))
    sims = {
        dev: ops_sim.video_pair_similarity(
            ham.to(dev), *(torch.from_numpy(x).to(dev) for x in args),
            len(REF_COUNTS_A), len(REF_COUNTS_B),
        )
        for dev in (CPU, cuda_device)
    }
    assert torch.equal(sims[cuda_device].cpu(), sims[CPU])
