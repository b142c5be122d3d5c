"""Bucketed video-pair similarity (counterpart of the JAX package's
``ops/similarity_pallas.py``).

The unpruned search's bucketed route pads each video to its bucket, the
next power of two of its frame count, and compares a tile of row videos of
one bucket (pa frames each) with a tile of column videos of another (pb
frames each). For each pair it gives the integer similarity

    min(100 * ma // max(fa, 1), 100 * mb // max(fb, 1))

where ma (mb) counts the row (column) video's real frames within Hamming
distance TOL of some real frame of the other video, and fa, fb are the
frame counts; 0 when either video is empty. Frames at or past a video's
count are padding and are excluded by count: an all-zero packed frame is a
valid hash.

``similarity_block`` launches ``csrc/similarity_block.cu`` on CUDA tensors
(or raises) and runs ``similarity_block_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .similarity import LANES, MATCH_DOT, unpack_pm1

#: the largest bucket the kernel takes (a video's frames in one block)
MAX_FRAMES = 1024
#: the plain version materialises its ±1 products in column chunks of at
#: most this many [row frame, column frame] entries
PLAIN_CHUNK_ENTRIES = 1 << 26

#: kernel launches by wrapper name: the wrapper adds one where it launches
#: its kernel (a run reads it to show its path went through the kernel)
LAUNCHES = {"similarity_block": 0}


def _check_args(rows_words, rows_counts, cols_words, cols_counts, pa: int, pb: int):
    """Raise on what neither version takes; (row videos, column videos)."""
    if not (1 <= pa <= MAX_FRAMES and 1 <= pb <= MAX_FRAMES):
        raise ValueError(f"pads must be in [1, {MAX_FRAMES}], got pa={pa}, pb={pb}")
    dev = rows_words.device
    named = [
        ("rows_words", rows_words), ("rows_counts", rows_counts),
        ("cols_words", cols_words), ("cols_counts", cols_counts),
    ]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows_words on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be {torch.int32}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tr, tc = rows_words.shape[0], cols_words.shape[0]
    if rows_words.shape != (tr, pa, LANES) or rows_counts.shape != (tr,):
        raise ValueError(f"rows must be [TR, {pa}, {LANES}] words and [TR] counts")
    if cols_words.shape != (tc, pb, LANES) or cols_counts.shape != (tc,):
        raise ValueError(f"columns must be [TC, {pb}, {LANES}] words and [TC] counts")
    return tr, tc


def similarity_block_plain(rows_words, rows_counts, cols_words, cols_counts, pa: int, pb: int):
    """Plain PyTorch version (the JAX package's ``similarity_block_xla``):
    ±1 products in float16 on CUDA, float32 on the CPU (exact: every sum is
    an integer of magnitude <= 256), matches at dot >= MATCH_DOT, frames
    past each count masked out. Arguments as ``similarity_block``."""
    tr, tc = _check_args(rows_words, rows_counts, cols_words, cols_counts, pa, pb)
    dev = rows_words.device
    dtype = torch.float16 if rows_words.is_cuda else torch.float32
    out = torch.zeros((tr, tc), dtype=torch.int32, device=dev)
    if tr == 0 or tc == 0:
        return out
    a = unpack_pm1(rows_words.reshape(tr * pa, LANES), dtype)
    va = torch.arange(pa, device=dev)[None, :] < rows_counts[:, None]  # [TR, pa]
    fa = torch.clamp(rows_counts, min=1)[:, None]
    step = max(1, PLAIN_CHUNK_ENTRIES // (tr * pa * pb))
    for j0 in range(0, tc, step):
        cw, cc = cols_words[j0 : j0 + step], cols_counts[j0 : j0 + step]
        n = cw.shape[0]
        b = unpack_pm1(cw.reshape(n * pb, LANES), dtype)
        dot = torch.matmul(a, b.T).reshape(tr, pa, n, pb)
        vb = torch.arange(pb, device=dev)[None, :] < cc[:, None]  # [n, pb]
        matched = (dot >= MATCH_DOT) & va[:, :, None, None] & vb[None, None, :, :]
        ma = matched.any(dim=3).sum(dim=1, dtype=torch.int32)  # [TR, n]
        mb = matched.any(dim=1).sum(dim=2, dtype=torch.int32)  # [TR, n]
        fb = torch.clamp(cc, min=1)[None, :]
        sim = torch.minimum((100 * ma) // fa, (100 * mb) // fb)
        nonempty = (rows_counts[:, None] > 0) & (cc[None, :] > 0)
        out[:, j0 : j0 + n] = torch.where(nonempty, sim, torch.zeros_like(sim))
    return out


def _launch(rows_words, rows_counts, cols_words, cols_counts, pa: int, pb: int):
    from . import _build

    tr, tc = rows_words.shape[0], cols_words.shape[0]
    for name, t in (("rows_words", rows_words), ("cols_words", cols_words)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((tr, tc), dtype=torch.int32, device=rows_words.device)
    _build.check_same_device(
        out, rows_words=rows_words, rows_counts=rows_counts, cols_words=cols_words,
        cols_counts=cols_counts,
    )
    lib = _build.load_library("similarity_block")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.hvd_similarity_block(
            rows_words.data_ptr(), rows_counts.data_ptr(), cols_words.data_ptr(),
            cols_counts.data_ptr(), out.data_ptr(), tr, tc, pa, pb, stream,
        )
    if err != 0:
        msg = ctypes.string_at(lib.hvd_cuda_error_string(err)).decode()
        raise RuntimeError(f"similarity_block launch failed: CUDA error {err} ({msg})")
    LAUNCHES["similarity_block"] += 1
    return out


def similarity_block(rows_words, rows_counts, cols_words, cols_counts, pa: int, pb: int):
    """Integer similarity [TR, TC] int32 of TR row videos against TC column
    videos.

    rows_words [TR, pa, 8] / cols_words [TC, pb, 8] int32 bit-packed frames
    (each video padded to its bucket), rows_counts [TR] / cols_counts [TC]
    int32 frame counts; 1 <= pa, pb <= MAX_FRAMES.

    CUDA tensors launch ``csrc/similarity_block.cu`` (or raise); the side
    with the larger pad takes the kernel's rows, one block per video, and
    a block computed the other way round comes back as a transposed view
    (the similarity is symmetric in its two videos). CPU tensors take
    ``similarity_block_plain``. ``LAUNCHES["similarity_block"]`` counts
    the kernel launches.
    """
    tr, tc = _check_args(rows_words, rows_counts, cols_words, cols_counts, pa, pb)
    if rows_words.device.type == "cpu":
        return similarity_block_plain(rows_words, rows_counts, cols_words, cols_counts, pa, pb)
    if rows_words.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_words.device}")
    if tr == 0 or tc == 0:
        return torch.zeros((tr, tc), dtype=torch.int32, device=rows_words.device)
    if pb > pa:
        return _launch(cols_words, cols_counts, rows_words, rows_counts, pb, pa).T
    return _launch(rows_words, rows_counts, cols_words, cols_counts, pa, pb)
