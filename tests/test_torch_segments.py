"""The port's segment layout and existence mask sweep against the JAX package.

Packers must be byte-equal. The plain PyTorch sweep must equal the JAX
package's XLA twin ``make_exists_mask_kernel_xla`` (the way the JAX suite
reaches its sweep on the CPU: the Pallas kernel runs only on a TPU), bit
for bit, with invalid steps zeroed as the sweep zeroes them. The CUDA
kernel is compared with the plain version on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.ops import similarity as jax_sim
from hydrus_video_deduplicator_tpu.ops import similarity_pallas as jax_sp
from hydrus_video_deduplicator_tpu.ops import similarity_segments as jseg
from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

CPU = torch.device("cpu")


def _ragged_items(rng, n, max_frames):
    counts = rng.integers(1, max_frames + 1, n)
    return [
        (int(i), rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes())
        for i, c in enumerate(counts)
    ]


@pytest.mark.parametrize(
    "frames,slots,max_frames",
    [
        (seg.ROW_FRAMES, seg.ROW_SLOTS, 40),
        (seg.CHUNK_FRAMES, seg.CHUNK_SLOTS, 9),
        (seg.CHUNK_FRAMES, seg.CHUNK_SLOTS, seg.SEG_MAX_FRAMES),
    ],
)
def test_packers_byte_equal_to_jax(rng, frames, slots, max_frames):
    items = _ragged_items(rng, 150, max_frames)
    got = seg.pack_blocks(items, frames, slots)
    want = jseg.pack_blocks(items, frames, slots)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for field in ("packed", "slot_ids", "counts", "slot_map"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    n = len(got) + 2  # trailing all-padding blocks
    for a, b in zip(seg.stack_blocks(got, n, frames, slots), jseg.stack_blocks(want, n, frames, slots)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    counts = np.asarray([len(b) // 32 for _, b in items])
    for a, b in zip(seg.plan_chunks(counts, frames, slots), jseg.plan_chunks(counts, frames, slots)):
        assert np.array_equal(a, b)
    blob = items[3][1]
    assert seg.blob_to_pm1(blob).tobytes() == jseg.blob_to_pm1(blob).tobytes()
    packed = ops_sim.blobs_to_packed(blob)
    assert packed.tobytes() == jax_sim.blobs_to_packed(blob).tobytes()
    assert ops_sim.packed_to_blobs(packed) == blob


def test_unpack_matches_jax(rng):
    """Device ±1 expansion (int32 words, sign-extending shifts masked) equals
    the JAX package's, padding rows zero; the host unpack is byte-equal."""
    packed = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    packed[:3] = 0xFFFFFFFF  # every shift of a negative int32 word
    packed[3] = 0
    slots = rng.integers(-1, 5, 300).astype(np.int32)
    got = seg.unpack_blocks_pm1(ops_sim.to_words(packed, CPU), torch.from_numpy(slots))
    want = np.asarray(jseg.unpack_blocks_pm1(jnp.asarray(packed), jnp.asarray(slots)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        ops_sim.unpack_pm1(ops_sim.to_words(packed, CPU)).numpy(),
        np.asarray(jax_sim.unpack_pm1(jnp.asarray(packed))),
    )
    v = packed.reshape(30, 10, 8)
    counts = rng.integers(0, 11, 30)
    assert ops_sim.unpack_pm1_host(v, counts).tobytes() == jax_sp.unpack_pm1_host(v, counts).tobytes()


def _sweep_inputs(rng, n_steps=3):
    """A 2-block row tile and n_steps column steps from one ragged corpus,
    with padding frames, all-zero-bit real frames and planted near pairs."""
    items = _ragged_items(rng, 170, 24)
    vids = [np.frombuffer(b, np.uint8).reshape(-1, 32).copy() for _, b in items]
    vids[5][:] = 0  # a real video whose frames have every bit clear
    vids[9][0] = 0
    for k in range(0, 160, 4):  # near copies at distance <= 8
        src = vids[k][0].copy()
        src[int(rng.integers(0, 32))] ^= np.uint8(rng.integers(0, 256))
        vids[k + 1][0] = src
    items = [(i, v.tobytes()) for i, v in enumerate(vids)]
    rp, ri, _, _ = seg.stack_blocks(
        seg.pack_blocks(items[:120], seg.ROW_FRAMES, seg.ROW_SLOTS),
        2, seg.ROW_FRAMES, seg.ROW_SLOTS,
    )
    cblocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    assert len(cblocks) <= n_steps * seg.N_SPLIT
    cp, ci, _, _ = seg.stack_blocks(
        cblocks, n_steps * seg.N_SPLIT, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
    )
    valid = np.ones(n_steps, dtype=np.int32)
    valid[1] = 0
    return rp, ri, cp, ci, valid


@pytest.mark.parametrize("tol", [31, 79])
def test_plain_sweep_matches_xla_twin(rng, tol):
    rp, ri, cp, ci, valid = _sweep_inputs(rng)
    got = seg.exists_mask_sweep_plain(
        ops_sim.to_words(rp, CPU), torch.from_numpy(ri),
        ops_sim.to_words(cp, CPU), torch.from_numpy(ci),
        torch.from_numpy(valid), tol,
    ).numpy()
    twin = jseg.make_exists_mask_kernel_xla(tol)
    rf = jseg.unpack_blocks_pm1(jnp.asarray(rp), jnp.asarray(ri))
    cf = jseg.unpack_blocks_pm1(jnp.asarray(cp), jnp.asarray(ci))
    dummy = jnp.zeros((1, 1), jnp.int32)
    want = np.asarray(twin(rf, jnp.asarray(ri), dummy, cf, jnp.asarray(ci), dummy))
    # the sweep's [W, steps * STEP_SLOTS] layout is the twin's; _mega_sweep_body
    # views it as [T, W, tile slots] tiles, here one step per tile
    want = want.reshape(want.shape[0], len(valid), seg.STEP_SLOTS).copy()
    want[:, valid == 0] = 0
    want = want.reshape(want.shape[0], -1).view(np.int32)
    assert got.shape == (2 * seg.MASK_WORDS, len(valid) * seg.STEP_SLOTS)
    assert np.array_equal(got, want)
    assert (want != 0).sum() > 50  # self matches + planted pairs present
    assert not got[:, seg.STEP_SLOTS : 2 * seg.STEP_SLOTS].any()  # invalid step


def _out_of_range_inputs(rng):
    """Three versions of one sweep's inputs, every step valid: with a row
    frame given slot id 300 and a column frame given slot id 70, each a
    copy of a real frame of the other side that it would match; with those
    two frames padding (-1); and with their real slot ids. The column
    frames are the last two of the corpus, whose videos have no planted
    near copy, so with real ids each sets a bit that nothing else sets."""
    rp, ri, cp, ci, valid = _sweep_inputs(rng)
    valid[:] = 1
    real_c = np.flatnonzero(ci >= 0)
    r_bad = 10
    r_src = int(np.flatnonzero((ri >= 0) & (ri != ri[r_bad]))[0])
    c_bad, c_src = int(real_c[-2]), int(real_c[-1])
    assert ri[r_bad] >= 0
    rp[r_bad] = cp[c_src]
    cp[c_bad] = rp[r_src]
    bad_ri, bad_ci, pad_ri, pad_ci = ri.copy(), ci.copy(), ri.copy(), ci.copy()
    bad_ri[r_bad], bad_ci[c_bad] = 300, 70
    pad_ri[r_bad] = pad_ci[c_bad] = -1
    return [(rp, r, cp, c, valid) for r, c in ((bad_ri, bad_ci), (pad_ri, pad_ci), (ri, ci))]


def _words_args(inputs, device):
    rp, ri, cp, ci, valid = inputs
    return (
        ops_sim.to_words(rp, device), torch.from_numpy(ri).to(device),
        ops_sim.to_words(cp, device), torch.from_numpy(ci).to(device),
        torch.from_numpy(valid).to(device),
    )


@pytest.mark.parametrize("tol", [31, 79])
def test_out_of_range_slot_ids_set_no_bit(rng, tol):
    """A row slot id >= ROW_SLOTS or a column slot id >= CHUNK_SLOTS is
    padding, on frames that would match: the plain sweep equals the same
    inputs with those frames padded, and the JAX package's XLA twin."""
    bad, pad, real = _out_of_range_inputs(rng)
    got = seg.exists_mask_sweep_plain(*_words_args(bad, CPU), tol)
    assert torch.equal(got, seg.exists_mask_sweep_plain(*_words_args(pad, CPU), tol))
    assert not torch.equal(got, seg.exists_mask_sweep_plain(*_words_args(real, CPU), tol))
    rp, ri, cp, ci, _ = bad
    twin = jseg.make_exists_mask_kernel_xla(tol)
    rf = jseg.unpack_blocks_pm1(jnp.asarray(rp), jnp.asarray(ri))
    cf = jseg.unpack_blocks_pm1(jnp.asarray(cp), jnp.asarray(ci))
    dummy = jnp.zeros((1, 1), jnp.int32)
    want = np.asarray(twin(rf, jnp.asarray(ri), dummy, cf, jnp.asarray(ci), dummy))
    assert np.array_equal(got.numpy(), want.view(np.int32))


def test_sweep_wrapper_takes_the_plain_version_for_cpu_tensors(rng):
    rp, ri, cp, ci, valid = _sweep_inputs(rng, n_steps=3)
    args = (
        ops_sim.to_words(rp, CPU), torch.from_numpy(ri),
        ops_sim.to_words(cp, CPU), torch.from_numpy(ci), torch.from_numpy(valid),
    )
    before = seg.LAUNCHES["exists_mask_sweep"]
    assert torch.equal(seg.exists_mask_sweep(*args, 79), seg.exists_mask_sweep_plain(*args, 79))
    assert seg.LAUNCHES["exists_mask_sweep"] == before  # no kernel ran


def test_sweep_rejects_what_the_kernel_does_not_take(rng):
    rp, ri, cp, ci, valid = _sweep_inputs(rng, n_steps=3)
    a, sa = ops_sim.to_words(rp, CPU), torch.from_numpy(ri)
    b, sb, v = ops_sim.to_words(cp, CPU), torch.from_numpy(ci), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="tolerance"):
        seg.exists_mask_sweep(a, sa, b, sb, v, 128)
    with pytest.raises(TypeError):
        seg.exists_mask_sweep(a.to(torch.int64), sa, b, sb, v, 79)
    with pytest.raises(ValueError):
        seg.exists_mask_sweep(a[:100], sa[:100], b, sb, v, 79)
    with pytest.raises(ValueError):
        seg.exists_mask_sweep(a, sa, b, sb, v[:1], 79)
    with pytest.raises(ValueError, match="contiguous"):
        seg.exists_mask_sweep(a, sa, b.T.contiguous().T, sb, v, 79)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [31, 79])
def test_kernel_matches_plain_on_cuda(rng, cuda_device, tol, monkeypatch):
    """The CUDA kernel is bit-equal to the plain version, and a CUDA tensor
    never reaches the plain version inside the wrapper."""
    rp, ri, cp, ci, valid = _sweep_inputs(rng)
    args = (
        ops_sim.to_words(rp, cuda_device), torch.from_numpy(ri).to(cuda_device),
        ops_sim.to_words(cp, cuda_device), torch.from_numpy(ci).to(cuda_device),
        torch.from_numpy(valid).to(cuda_device),
    )
    want = seg.exists_mask_sweep_plain(*args, tol)

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(seg, "exists_mask_sweep_plain", refuse)
    before = seg.LAUNCHES["exists_mask_sweep"]
    got = seg.exists_mask_sweep(*args, tol)
    torch.cuda.synchronize()
    assert seg.LAUNCHES["exists_mask_sweep"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [31, 79])
def test_kernel_matches_plain_on_out_of_range_slot_ids_on_cuda(rng, cuda_device, tol):
    """Slot ids past a block's range (row 300, column 70) on frames that
    would match are padding in the kernel too."""
    bad, _, _ = _out_of_range_inputs(rng)
    args = _words_args(bad, cuda_device)
    got = seg.exists_mask_sweep(*args, tol)
    torch.cuda.synchronize()
    assert torch.equal(got, seg.exists_mask_sweep_plain(*args, tol))
