"""Fixed-shape segment layout and its kernels (counterpart of the JAX
package's ``ops/similarity_segments.py``).

Videos of up to SEG_MAX_FRAMES frames pack greedily into fixed frame
blocks; raggedness lives in DATA (per-frame slot ids, -1 = padding), not
in shapes. The row side packs into ROW_FRAMES-frame blocks of ROW_SLOTS
videos, the column side into CHUNK_FRAMES-frame chunks of CHUNK_SLOTS
videos, N_SPLIT chunks per column step. Every kernel takes one row tile
against the whole stacked column corpus, bit-packed, with a validity flag
per column step.

The existence mask sweep is stage A of the pruned search: per (row slot,
column slot), whether any frame pair lies within a Hamming tolerance, as
row-packed 32-bit words:

    out[i*8 + w, j*256 + s*64 + c], bit b  <=>  row slot 32w+b of row
    block i and column slot c of chunk s of step j have a frame pair at
    distance <= tol; steps with valid[j] == 0 are all zeros.

The segment similarity kernel serves the unpruned search: per slot pair
the integer similarity min(100*ma // max(fa,1), 100*mb // max(fb,1)) at
tolerance TOL, where ma (mb) counts the row (column) slot's frames that
match some frame of the other slot and fa (fb) are the slots' frame
counts; or only whether it reaches min_sim, in the sweep's mask layout, with
optionally each such hit's similarity in a compact hit list (``hit_list``);
or ma alone at any tolerance.

Wrappers and their kernels: ``exists_mask_sweep`` and
``exists_mask_kernel`` (every step valid) launch
``csrc/exists_mask_sweep.cu``; ``similarity_segments`` and
``exists_counts`` launch ``csrc/similarity_segments.cu``. Each runs its
``*_plain`` version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from . import similarity as ops_sim
from .similarity import BITS, LANES, TOL, unpack_pm1, unpack_pm1_host

#: kernel row block: frames x video slots
ROW_FRAMES = 2048
ROW_SLOTS = 256
#: column chunk: frames x local video slots; N_SPLIT chunks per step
CHUNK_FRAMES = 512
CHUNK_SLOTS = 64
N_SPLIT = 4
STEP_FRAMES = N_SPLIT * CHUNK_FRAMES  # 2048
STEP_SLOTS = N_SPLIT * CHUNK_SLOTS  # 256

#: videos longer than one column chunk cannot take the segment route
SEG_MAX_FRAMES = CHUNK_FRAMES

#: mask words per row block: bit b of word w covers row slot w*32+b
MASK_WORDS = ROW_SLOTS // 32

#: kernel launches by wrapper name: each wrapper adds one where it launches
#: its kernel (a run reads them to show its path went through the kernel)
LAUNCHES = {
    "exists_mask_sweep": 0,
    "exists_mask_kernel": 0,
    "similarity_segments": 0,
    "exists_counts": 0,
}


# ---------------------------------------------------------------------------
# Kernel 3's hit list
# ---------------------------------------------------------------------------


def hit_list(capacity: int, device) -> torch.Tensor:
    """An empty hit list of ``capacity`` records for kernel 3's mask mode:
    int32 [capacity + 1, 3]. Row 0 is the header: the launch's hit count as
    one int64 in its first two words (``hit_count``). Rows 1.. hold the
    records (row slot within the launch i*ROW_SLOTS + 32w + b, column slot,
    integer similarity), in no particular order; a launch counts every hit
    and writes at most ``capacity`` records. A prefix ``hits[: c + 1]``
    is a list of capacity c."""
    return torch.empty((capacity + 1, 3), dtype=torch.int32, device=device)


def hit_count(hits: torch.Tensor) -> torch.Tensor:
    """The hit count of a hit list: an int64 tensor of one element, on the
    list's device (reading it waits for the launch)."""
    return hits[0, :2].view(torch.int64)


def _check_hits(hits: torch.Tensor, device) -> int:
    """A hit list's capacity; raises on what the kernel does not take."""
    if hits.device != device:
        raise ValueError(f"hits is on {hits.device}, a_words on {device}")
    if hits.dtype != torch.int32:
        raise TypeError(f"hits must be {torch.int32}, got {hits.dtype}")
    if hits.dim() != 2 or hits.shape[0] < 1 or hits.shape[1] != 3 or not hits.is_contiguous():
        raise ValueError(f"hits must be a contiguous [capacity + 1, 3], got {tuple(hits.shape)}")
    if hits.shape[0] - 1 >= 1 << 31:
        raise ValueError(f"a hit list holds fewer than 2**31 records, got {hits.shape[0] - 1}")
    return hits.shape[0] - 1


# ---------------------------------------------------------------------------
# Host-side greedy packer (numpy; byte-equal to the JAX package's)
# ---------------------------------------------------------------------------


@dataclass
class PackedBlock:
    """One fixed-shape block of packed videos; frames stay bit-packed."""

    packed: np.ndarray  # [frames, 8] uint32 (zero rows past content)
    slot_ids: np.ndarray  # [frames] int32 block-local slot id, -1 padding
    counts: np.ndarray  # [slots, 1] int32 (0 for empty slots)
    slot_map: np.ndarray  # [slots] int64 corpus index, -1 for empty slots


def blob_to_pm1(blob: bytes) -> np.ndarray:
    """Packed 32N-byte hash blob -> [N, 256] ±1 int8 rows."""
    n = len(blob) // 32
    packed = ops_sim.blobs_to_packed(blob).reshape(1, n, LANES)
    return unpack_pm1_host(packed, np.asarray([n]))


def plan_chunks(
    counts: np.ndarray, frames_per_block: int, slots_per_block: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Next-fit packing plan from frame counts alone.

    Returns (chunk_id [n] int64, slot_id [n] int32, frame_off [n] int64,
    n_chunks) with boundaries identical to pack_blocks: a chunk closes
    when the next video exceeds its remaining frames or slots.
    """
    n = len(counts)
    chunk_id = np.empty(n, dtype=np.int64)
    slot_id = np.empty(n, dtype=np.int32)
    frame_off = np.empty(n, dtype=np.int64)
    c = 0
    used_f = 0
    used_s = 0
    for k in range(n):
        nf = int(counts[k])
        assert 1 <= nf <= frames_per_block, (k, nf)
        if used_s and (used_f + nf > frames_per_block or used_s >= slots_per_block):
            c += 1
            used_f = 0
            used_s = 0
        chunk_id[k] = c
        slot_id[k] = used_s
        frame_off[k] = used_f
        used_f += nf
        used_s += 1
    return chunk_id, slot_id, frame_off, (c + 1 if n else 0)


def pack_blocks(
    items: "list[tuple[int, bytes]]", frames_per_block: int, slots_per_block: int
) -> list[PackedBlock]:
    """Greedy next-fit packing of (corpus_index, blob) into fixed blocks.

    Every video must have 1..frames_per_block frames. Items pack in order;
    a block closes when the next video exceeds its remaining frames or
    slots.
    """
    plans: list[list[tuple[int, int]]] = []  # per block: [(corpus idx, n), ...]
    cur: list[tuple[int, int]] = []
    cur_frames = 0
    for idx, blob in items:
        n = len(blob) // 32
        assert 1 <= n <= frames_per_block, (idx, n)
        if cur and (cur_frames + n > frames_per_block or len(cur) >= slots_per_block):
            plans.append(cur)
            cur, cur_frames = [], 0
        cur.append((idx, n))
        cur_frames += n
    if cur:
        plans.append(cur)

    blob_of = dict(items)
    blocks: list[PackedBlock] = []
    for plan in plans:
        packed = np.zeros((frames_per_block, LANES), dtype=np.uint32)
        slot_ids = np.full((frames_per_block,), -1, dtype=np.int32)
        counts = np.zeros((slots_per_block, 1), dtype=np.int32)
        slot_map = np.full((slots_per_block,), -1, dtype=np.int64)
        n_block = sum(n for _, n in plan)
        packed[:n_block] = ops_sim.blobs_to_packed(
            b"".join(blob_of[idx] for idx, _ in plan)
        )
        f = 0
        for s, (idx, n) in enumerate(plan):
            slot_ids[f : f + n] = s
            counts[s, 0] = n
            slot_map[s] = idx
            f += n
        blocks.append(PackedBlock(packed, slot_ids, counts, slot_map))
    return blocks


def stack_blocks(blocks: list[PackedBlock], n_blocks: int, frames: int, slots: int):
    """Stack (and pad with empty blocks) into tile arrays: (packed
    [n_blocks*frames, 8] u32, slot_ids [n_blocks*frames], counts
    [n_blocks*slots, 1], slot_map [n_blocks*slots]); slot ids stay
    block-local."""
    assert len(blocks) <= n_blocks
    packed = np.zeros((n_blocks * frames, LANES), dtype=np.uint32)
    slot_ids = np.full((n_blocks * frames,), -1, dtype=np.int32)
    counts = np.zeros((n_blocks * slots, 1), dtype=np.int32)
    slot_map = np.full((n_blocks * slots,), -1, dtype=np.int64)
    for k, blk in enumerate(blocks):
        packed[k * frames : (k + 1) * frames] = blk.packed
        slot_ids[k * frames : (k + 1) * frames] = blk.slot_ids
        counts[k * slots : (k + 1) * slots] = blk.counts
        slot_map[k * slots : (k + 1) * slots] = blk.slot_map
    return packed, slot_ids, counts, slot_map


def unpack_blocks_pm1(
    words: torch.Tensor, slot_ids: torch.Tensor, dtype: torch.dtype = torch.int8
) -> torch.Tensor:
    """[..., F, 8] int32 words, [..., F] slot ids -> [..., F, 256] in
    {-1, 0, +1}: padding rows (slot id -1) become exact zero rows, which
    never reach a match while tol < 128."""
    pm1 = unpack_pm1(words, dtype)
    return pm1 * (slot_ids >= 0).unsqueeze(-1).to(dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the one-hot slot reductions of the JAX XLA twins
# ---------------------------------------------------------------------------


def _check_sweep_args(
    a_words, slot_a, b_words, slot_b, valid, tolerance, counts_a=None, counts_b=None
):
    if not 0 <= tolerance < BITS // 2:
        # at tol >= 128 a zero (padding) ±1 row would reach the match
        # threshold in the plain version; the kernels exclude padding by
        # slot id, so the two would disagree
        raise ValueError(f"tolerance must be in [0, 128), got {tolerance}")
    dev = a_words.device
    named = [
        ("a_words", a_words), ("slot_a", slot_a), ("b_words", b_words),
        ("slot_b", slot_b), ("valid", valid),
    ]
    if counts_a is not None or counts_b is not None:
        named += [("counts_a", counts_a), ("counts_b", counts_b)]
    for name, t in named:
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_words on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be {torch.int32}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ra_f, cb_f = a_words.shape[0], b_words.shape[0]
    if a_words.shape != (ra_f, LANES) or ra_f == 0 or ra_f % ROW_FRAMES:
        raise ValueError(f"a_words must be [k*{ROW_FRAMES}, {LANES}], got {tuple(a_words.shape)}")
    if b_words.shape != (cb_f, LANES) or cb_f == 0 or cb_f % STEP_FRAMES:
        raise ValueError(f"b_words must be [k*{STEP_FRAMES}, {LANES}], got {tuple(b_words.shape)}")
    if slot_a.shape != (ra_f,) or slot_b.shape != (cb_f,):
        raise ValueError("slot ids must hold one id per frame")
    n_row_blocks, n_steps = ra_f // ROW_FRAMES, cb_f // STEP_FRAMES
    if valid.shape != (n_steps,):
        raise ValueError(f"valid must hold one flag per column step ({n_steps})")
    if counts_a is not None and (
        counts_a.shape != (n_row_blocks * ROW_SLOTS,) or counts_b.shape != (n_steps * STEP_SLOTS,)
    ):
        raise ValueError("counts_a and counts_b must hold one frame count per slot")
    return n_row_blocks, n_steps


def _plain_slot_counts(a_words, slot_a, b_words, slot_b, valid, tolerance, both_ways):
    """(i, j, ma, mb) for each row block i and valid column step j, with ma
    and mb [N_SPLIT, ROW_SLOTS, CHUNK_SLOTS] int32 (mb is None unless
    both_ways): the one-hot reductions of the JAX package's
    ``similarity_segments_xla`` and ``make_exists_kernel_xla``, with ±1
    products in float32 (exact: every partial sum is an integer of
    magnitude <= 2048). Slot ids outside a block's slot range match no
    slot, like padding."""
    match_dot = BITS - 2 * tolerance
    dev = a_words.device
    row_slots = torch.arange(ROW_SLOTS, dtype=torch.int32, device=dev)
    col_slots = torch.arange(CHUNK_SLOTS, dtype=torch.int32, device=dev)
    steps = torch.nonzero(valid).flatten().tolist()
    for i in range(a_words.shape[0] // ROW_FRAMES):
        rs = slice(i * ROW_FRAMES, (i + 1) * ROW_FRAMES)
        a = unpack_blocks_pm1(a_words[rs], slot_a[rs], torch.float32)  # [RF, 256]
        onehot_a = (slot_a[rs, None] == row_slots).to(torch.float32)  # [RF, RS]
        for j in steps:
            cs = slice(j * STEP_FRAMES, (j + 1) * STEP_FRAMES)
            b = unpack_blocks_pm1(b_words[cs], slot_b[cs], torch.float32)
            b = b.view(N_SPLIT, CHUNK_FRAMES, BITS)
            onehot_b = (slot_b[cs].view(N_SPLIT, CHUNK_FRAMES, 1) == col_slots).to(
                torch.float32
            )  # [S, CF, CS]
            m = (torch.matmul(a, b.transpose(1, 2)) >= match_dot).to(torch.float32)  # [S, RF, CF]
            hits_b = (torch.matmul(m, onehot_b) > 0).to(torch.float32)  # [S, RF, CS]
            ma = torch.matmul(onehot_a.T, hits_b)  # [S, RS, CS]
            mb = None
            if both_ways:
                hits_a = (torch.matmul(onehot_a.T, m) > 0).to(torch.float32)  # [S, RS, CF]
                mb = torch.matmul(hits_a, onehot_b).to(torch.int32)  # [S, RS, CS]
            yield i, j, ma.to(torch.int32), mb


def _plain_similarity(ma, mb, counts_a, counts_b, i, j):
    """[S, RS, CS] int32 slot similarities min(100*ma // max(fa, 1),
    100*mb // max(fb, 1)) of row block i against column step j."""
    fa = torch.clamp(counts_a[i * ROW_SLOTS : (i + 1) * ROW_SLOTS], min=1)
    fb = torch.clamp(counts_b[j * STEP_SLOTS : (j + 1) * STEP_SLOTS], min=1)
    return torch.minimum(
        (100 * ma) // fa.view(1, ROW_SLOTS, 1),
        (100 * mb) // fb.view(N_SPLIT, 1, CHUNK_SLOTS),
    )


def _pack_rows(hit: torch.Tensor) -> torch.Tensor:
    """[S, RS, CS] bool -> [MASK_WORDS, STEP_SLOTS] int32 row-packed words:
    bit b of word [w, s*CS + c] is hit[s, 32w+b, c]."""
    pow2 = torch.ones(32, dtype=torch.int64, device=hit.device) << torch.arange(
        32, device=hit.device
    )
    bits = hit.to(torch.int64).view(N_SPLIT, MASK_WORDS, 32, CHUNK_SLOTS)
    words = (bits * pow2[:, None]).sum(2)  # [S, W, CS] in [0, 2^32)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).permute(1, 0, 2).reshape(MASK_WORDS, STEP_SLOTS)


def _slot_tile(x: torch.Tensor) -> torch.Tensor:
    """[S, RS, CS] -> the [RS, STEP_SLOTS] output tile of one step."""
    return x.permute(1, 0, 2).reshape(ROW_SLOTS, STEP_SLOTS)


def exists_mask_sweep_plain(a_words, slot_a, b_words, slot_b, valid, tolerance: int):
    """Plain PyTorch version of the sweep, laid out as the sweep's output
    (the JAX package's ``make_exists_mask_kernel_xla`` per step).
    Arguments as ``exists_mask_sweep``."""
    n_row_blocks, n_steps = _check_sweep_args(a_words, slot_a, b_words, slot_b, valid, tolerance)
    out = torch.zeros(
        (n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device
    )
    for i, j, ma, _ in _plain_slot_counts(
        a_words, slot_a, b_words, slot_b, valid, tolerance, both_ways=False
    ):
        out[i * MASK_WORDS : (i + 1) * MASK_WORDS, j * STEP_SLOTS : (j + 1) * STEP_SLOTS] = (
            _pack_rows(ma >= 1)
        )
    return out


def exists_mask_kernel_plain(a_words, slot_a, b_words, slot_b, tolerance: int):
    """Plain version of ``exists_mask_kernel``: the sweep, every step valid."""
    valid = torch.ones(b_words.shape[0] // STEP_FRAMES, dtype=torch.int32, device=a_words.device)
    return exists_mask_sweep_plain(a_words, slot_a, b_words, slot_b, valid, tolerance)


def similarity_segments_plain(a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid):
    """Plain version of kernel 3 (the JAX package's
    ``similarity_segments_xla``) at tolerance TOL: [n_row_blocks *
    ROW_SLOTS, n_steps * STEP_SLOTS] int32 slot similarities, zeros for
    invalid steps. Arguments as ``similarity_segments``."""
    n_row_blocks, n_steps = _check_sweep_args(
        a_words, slot_a, b_words, slot_b, valid, TOL, counts_a, counts_b
    )
    out = torch.zeros(
        (n_row_blocks * ROW_SLOTS, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device
    )
    for i, j, ma, mb in _plain_slot_counts(
        a_words, slot_a, b_words, slot_b, valid, TOL, both_ways=True
    ):
        out[i * ROW_SLOTS : (i + 1) * ROW_SLOTS, j * STEP_SLOTS : (j + 1) * STEP_SLOTS] = (
            _slot_tile(_plain_similarity(ma, mb, counts_a, counts_b, i, j))
        )
    return out


def similarity_mask_plain(
    a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid, min_sim: int, hits=None
):
    """Plain version of kernel 3's mask mode: sim >= min_sim, row-packed in
    the sweep's layout ([n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS]
    int32), which is what the JAX route's scan body makes of the kernel's
    output. min_sim >= 1, so empty slots never set a bit. With a hit list
    (``hit_list``), also its count and records, as the kernel writes
    them."""
    if min_sim < 1:
        raise ValueError(f"min_sim must be >= 1, got {min_sim}")
    n_row_blocks, n_steps = _check_sweep_args(
        a_words, slot_a, b_words, slot_b, valid, TOL, counts_a, counts_b
    )
    capacity = None if hits is None else _check_hits(hits, a_words.device)
    out = torch.zeros(
        (n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device
    )
    found = 0
    for i, j, ma, mb in _plain_slot_counts(
        a_words, slot_a, b_words, slot_b, valid, TOL, both_ways=True
    ):
        sim = _plain_similarity(ma, mb, counts_a, counts_b, i, j)
        hit = sim >= min_sim
        out[i * MASK_WORDS : (i + 1) * MASK_WORDS, j * STEP_SLOTS : (j + 1) * STEP_SLOTS] = (
            _pack_rows(hit)
        )
        if hits is not None:
            s, rs, cs = torch.nonzero(hit, as_tuple=True)
            row, col = i * ROW_SLOTS + rs, j * STEP_SLOTS + s * CHUNK_SLOTS + cs
            records = torch.stack([row, col, sim[s, rs, cs].long()], 1)
            kept = records[: max(0, capacity - found)]
            hits[1 + found : 1 + found + len(kept)] = kept.to(torch.int32)
            found += len(records)
    if hits is not None:
        hit_count(hits).fill_(found)
    return out


def exists_counts_plain(a_words, slot_a, b_words, slot_b, valid, tolerance: int):
    """Plain version of kernel 6 (the JAX package's
    ``make_exists_kernel_xla``): ma, the row frames of each row slot within
    ``tolerance`` of some frame of each column slot, [n_row_blocks *
    ROW_SLOTS, n_steps * STEP_SLOTS] int32, zeros for invalid steps."""
    n_row_blocks, n_steps = _check_sweep_args(a_words, slot_a, b_words, slot_b, valid, tolerance)
    out = torch.zeros(
        (n_row_blocks * ROW_SLOTS, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device
    )
    for i, j, ma, _ in _plain_slot_counts(
        a_words, slot_a, b_words, slot_b, valid, tolerance, both_ways=False
    ):
        out[i * ROW_SLOTS : (i + 1) * ROW_SLOTS, j * STEP_SLOTS : (j + 1) * STEP_SLOTS] = (
            _slot_tile(ma)
        )
    return out


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

#: output modes of csrc/similarity_segments.cu
_SIMS, _MASK, _COUNTS = 0, 1, 2


def _launch(name: str, library: str, fn: str, out: torch.Tensor, *args):
    """Call C function ``fn`` of kernel library ``library`` with ``args``
    and the current stream of ``out``'s device; raise on a CUDA error,
    else count one launch of ``name``."""
    lib = _build.load_library(library)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = ctypes.string_at(lib.hvd_cuda_error_string(err)).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    return out


def _check_cuda(a_words, b_words):
    if a_words.device.type != "cuda":
        raise ValueError(f"unsupported device {a_words.device}")
    for name, t in (("a_words", a_words), ("b_words", b_words)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _sweep(name, a_words, slot_a, b_words, slot_b, valid, tolerance):
    n_row_blocks, n_steps = _check_sweep_args(a_words, slot_a, b_words, slot_b, valid, tolerance)
    _check_cuda(a_words, b_words)
    out = torch.empty(
        (n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device
    )
    _build.check_same_device(
        out, a_words=a_words, slot_a=slot_a, b_words=b_words, slot_b=slot_b, valid=valid
    )
    return _launch(
        name, "exists_mask_sweep", "hvd_exists_mask_sweep", out,
        a_words.data_ptr(), slot_a.data_ptr(), b_words.data_ptr(), slot_b.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n_row_blocks, n_steps, tolerance,
    )


def exists_mask_sweep(a_words, slot_a, b_words, slot_b, valid, tolerance: int):
    """Whole-corpus existence sweep for one row tile.

    a_words [RA_F, 8] int32 bit-packed row frames (RA_F a multiple of
    ROW_FRAMES) with block-local slot ids slot_a [RA_F] int32 (-1 padding);
    b_words [CB_F, 8] int32, the whole stacked column corpus (CB_F a
    multiple of STEP_FRAMES), with chunk-local slot ids slot_b [CB_F];
    valid [CB_F // STEP_FRAMES] int32 (0 zeroes the step). Returns the
    row-packed masks [RA_F // ROW_FRAMES * 8, CB_F // STEP_FRAMES * 256]
    int32 described in the module docstring.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    ``exists_mask_sweep_plain``. ``LAUNCHES["exists_mask_sweep"]`` counts
    the kernel launches.
    """
    if a_words.device.type == "cpu":
        return exists_mask_sweep_plain(a_words, slot_a, b_words, slot_b, valid, tolerance)
    return _sweep("exists_mask_sweep", a_words, slot_a, b_words, slot_b, valid, tolerance)


def exists_mask_kernel(a_words, slot_a, b_words, slot_b, tolerance: int):
    """Counterpart of the JAX package's ``make_exists_mask_kernel_pallas``
    (TPU kernel 2): the existence masks of every column step, i.e. the
    sweep with every step valid, launched on ``csrc/exists_mask_sweep.cu``.
    CUDA tensors launch the kernel (or raise), CPU tensors take
    ``exists_mask_kernel_plain``; ``LAUNCHES["exists_mask_kernel"]``."""
    if a_words.device.type == "cpu":
        return exists_mask_kernel_plain(a_words, slot_a, b_words, slot_b, tolerance)
    valid = torch.ones(b_words.shape[0] // STEP_FRAMES, dtype=torch.int32, device=a_words.device)
    return _sweep("exists_mask_kernel", a_words, slot_a, b_words, slot_b, valid, tolerance)


def _segments(
    name, mode, a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid, tol, min_sim,
    hits=None,
):
    n_row_blocks, n_steps = _check_sweep_args(
        a_words, slot_a, b_words, slot_b, valid, tol, counts_a, counts_b
    )
    _check_cuda(a_words, b_words)
    capacity = 0 if hits is None else _check_hits(hits, a_words.device)
    if hits is not None and hits.data_ptr() % 8:
        raise ValueError("hits must be 8-byte aligned")
    rows = n_row_blocks * (MASK_WORDS if mode == _MASK else ROW_SLOTS)
    out = torch.empty((rows, n_steps * STEP_SLOTS), dtype=torch.int32, device=a_words.device)
    counts = {} if counts_a is None else {"counts_a": counts_a, "counts_b": counts_b}
    _build.check_same_device(
        out, a_words=a_words, slot_a=slot_a, b_words=b_words, slot_b=slot_b, valid=valid, **counts
    )
    return _launch(
        name, "similarity_segments", "hvd_similarity_segments", out,
        a_words.data_ptr(), slot_a.data_ptr(),
        None if counts_a is None else counts_a.data_ptr(),
        b_words.data_ptr(), slot_b.data_ptr(),
        None if counts_b is None else counts_b.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n_row_blocks, n_steps, tol, mode, min_sim,
        None if hits is None else hits.data_ptr(), capacity,
    )


def similarity_segments(
    a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid, min_sim: int | None = None,
    hits: torch.Tensor | None = None,
):
    """Kernel 3: slot-level similarity of one row tile against the whole
    column corpus at tolerance TOL.

    Frames, slot ids and valid as ``exists_mask_sweep``; counts_a
    [RA_F // ROW_FRAMES * 256] and counts_b [CB_F // STEP_FRAMES * 256]
    int32 are the per-slot frame counts. With ``min_sim`` None, returns the
    similarities [RA_S, CB_S] int32 (``similarity_segments_plain``); with
    an int >= 1, the row-packed masks of sim >= min_sim in the sweep's
    layout (``similarity_mask_plain``), which is what the unpruned route
    drains: the dense similarities never reach device memory. ``hits``
    (mask mode only), a ``hit_list`` on the frames' device, receives the
    launch's hit count and, up to its capacity, each hit's record with its
    similarity; the mask is written all the same.

    CUDA tensors launch ``csrc/similarity_segments.cu`` (or raise); CPU
    tensors take the plain version. ``LAUNCHES["similarity_segments"]``
    counts the kernel launches.
    """
    args = (a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid)
    if min_sim is not None and min_sim < 1:
        raise ValueError(f"min_sim must be >= 1, got {min_sim}")
    if hits is not None and min_sim is None:
        raise ValueError("a hit list needs the mask mode (min_sim)")
    if a_words.device.type == "cpu":
        if min_sim is None:
            return similarity_segments_plain(*args)
        return similarity_mask_plain(*args, min_sim, hits)
    mode = _SIMS if min_sim is None else _MASK
    return _segments(
        "similarity_segments", mode, *args, TOL, 0 if min_sim is None else min_sim, hits
    )


def exists_counts(a_words, slot_a, b_words, slot_b, valid, tolerance: int):
    """Kernel 6: per (row slot, column slot), the row frames within
    ``tolerance`` of some frame of the column slot, [RA_S, CB_S] int32;
    the counts mode of ``csrc/similarity_segments.cu``. CUDA tensors launch
    the kernel (or raise), CPU tensors take ``exists_counts_plain``;
    ``LAUNCHES["exists_counts"]``."""
    if a_words.device.type == "cpu":
        return exists_counts_plain(a_words, slot_a, b_words, slot_b, valid, tolerance)
    return _segments(
        "exists_counts", _COUNTS, a_words, slot_a, None, b_words, slot_b, None, valid,
        tolerance, 0,
    )
