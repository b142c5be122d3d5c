"""Fixed-shape segment layout and the existence mask sweep (counterpart of
the JAX package's ``ops/similarity_segments.py``).

Videos of up to SEG_MAX_FRAMES frames pack greedily into fixed frame
blocks; raggedness lives in DATA (per-frame slot ids, -1 = padding), not
in shapes. The row side packs into ROW_FRAMES-frame blocks of ROW_SLOTS
videos, the column side into CHUNK_FRAMES-frame chunks of CHUNK_SLOTS
videos, N_SPLIT chunks per column step.

The existence mask sweep is stage A of the pruned search: for one row tile
against the whole stacked column corpus it emits, per (row slot, column
slot), whether any frame pair lies within a Hamming tolerance, as
row-packed 32-bit words:

    out[i*8 + w, j*256 + s*64 + c], bit b  <=>  row slot 32w+b of row
    block i and column slot c of chunk s of step j have a frame pair at
    distance <= tol; steps with valid[j] == 0 are all zeros.

``exists_mask_sweep`` launches the hand-written CUDA kernel
(``csrc/exists_mask_sweep.cu``) on CUDA tensors and runs
``exists_mask_sweep_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import similarity as ops_sim
from .similarity import BITS, LANES, unpack_pm1, unpack_pm1_host

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
LAUNCHES = {"exists_mask_sweep": 0}


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
# Existence mask sweep: plain PyTorch version and the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _check_sweep_args(a_words, slot_a, b_words, slot_b, valid, tolerance):
    if not 0 <= tolerance < BITS // 2:
        # at tol >= 128 a zero (padding) ±1 row would reach the match
        # threshold in the plain version; the kernel excludes padding by
        # slot id, so the two would disagree
        raise ValueError(f"tolerance must be in [0, 128), got {tolerance}")
    dev = a_words.device
    for name, t, dtype in (
        ("a_words", a_words, torch.int32),
        ("slot_a", slot_a, torch.int32),
        ("b_words", b_words, torch.int32),
        ("slot_b", slot_b, torch.int32),
        ("valid", valid, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_words on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ra_f, cb_f = a_words.shape[0], b_words.shape[0]
    if a_words.shape != (ra_f, LANES) or ra_f == 0 or ra_f % ROW_FRAMES:
        raise ValueError(f"a_words must be [k*{ROW_FRAMES}, {LANES}], got {tuple(a_words.shape)}")
    if b_words.shape != (cb_f, LANES) or cb_f == 0 or cb_f % STEP_FRAMES:
        raise ValueError(f"b_words must be [k*{STEP_FRAMES}, {LANES}], got {tuple(b_words.shape)}")
    if slot_a.shape != (ra_f,) or slot_b.shape != (cb_f,):
        raise ValueError("slot ids must hold one id per frame")
    if valid.shape != (cb_f // STEP_FRAMES,):
        raise ValueError(f"valid must hold one flag per column step ({cb_f // STEP_FRAMES})")
    return ra_f // ROW_FRAMES, cb_f // STEP_FRAMES


def exists_mask_sweep_plain(a_words, slot_a, b_words, slot_b, valid, tolerance: int):
    """Plain PyTorch version of the sweep: the same one-hot slot reductions
    as the JAX package's ``make_exists_mask_kernel_xla``, with ±1 products
    in float32 (exact: every partial sum is an integer of magnitude <= 256),
    laid out as the sweep's output. Arguments as ``exists_mask_sweep``."""
    n_row_blocks, n_steps = _check_sweep_args(
        a_words, slot_a, b_words, slot_b, valid, tolerance
    )
    match_dot = BITS - 2 * tolerance
    dev = a_words.device
    out = torch.zeros(
        (n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS), dtype=torch.int32, device=dev
    )
    row_slots = torch.arange(ROW_SLOTS, dtype=torch.int32, device=dev)
    col_slots = torch.arange(CHUNK_SLOTS, dtype=torch.int32, device=dev)
    pow2 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    steps = torch.nonzero(valid).flatten().tolist()
    for i in range(n_row_blocks):
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
            dot = torch.matmul(a, b.transpose(1, 2))  # [S, RF, CF]
            m = (dot >= match_dot).to(torch.float32)
            hits_b = (torch.matmul(m, onehot_b) > 0).to(torch.float32)  # [S, RF, CS]
            ma = torch.matmul(onehot_a.T, hits_b)  # [S, RS, CS]
            hit = (ma >= 1).to(torch.int64).view(N_SPLIT, MASK_WORDS, 32, CHUNK_SLOTS)
            words = (hit * pow2[:, None]).sum(2)  # [S, W, CS] in [0, 2^32)
            words = torch.where(words >= 1 << 31, words - (1 << 32), words)
            out[i * MASK_WORDS : (i + 1) * MASK_WORDS, j * STEP_SLOTS : (j + 1) * STEP_SLOTS] = (
                words.to(torch.int32).permute(1, 0, 2).reshape(MASK_WORDS, STEP_SLOTS)
            )
    return out


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
    if a_words.device.type != "cuda":
        raise ValueError(f"unsupported device {a_words.device}")
    n_row_blocks, n_steps = _check_sweep_args(
        a_words, slot_a, b_words, slot_b, valid, tolerance
    )
    for name, t in (("a_words", a_words), ("b_words", b_words)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    from . import _build

    lib = _build.load_library("exists_mask_sweep")
    out = torch.empty(
        (n_row_blocks * MASK_WORDS, n_steps * STEP_SLOTS),
        dtype=torch.int32,
        device=a_words.device,
    )
    with torch.cuda.device(a_words.device):
        stream = torch.cuda.current_stream(a_words.device).cuda_stream
        err = lib.hvd_exists_mask_sweep(
            a_words.data_ptr(), slot_a.data_ptr(), b_words.data_ptr(),
            slot_b.data_ptr(), valid.data_ptr(), out.data_ptr(),
            n_row_blocks, n_steps, tolerance, stream,
        )
    if err != 0:
        msg = ctypes.string_at(lib.hvd_cuda_error_string(err)).decode()
        raise RuntimeError(f"exists_mask_sweep launch failed: CUDA error {err} ({msg})")
    LAUNCHES["exists_mask_sweep"] += 1
    return out
