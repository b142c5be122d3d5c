"""The plain reference: VPDQ's exact video similarity, and every match of a
sample of videos against a whole library, in NumPy and plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the packed hashes the benchmark generated and handed to both sides.

Semantics (VPDQ's ``matchHash`` as the program states it): a frame of one
video matches the other video when its Hamming distance to some frame of
the other is at most TOL; the similarity of two non-empty videos is
``min(100 * matched_a // frames_a, 100 * matched_b // frames_b)``, the
integer part of the smaller matched percentage; an empty video matches
nothing, itself included. A pair is reported at a minimum similarity
``min_sim`` when its similarity reaches it.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 31
BITS = 256
BYTES = 32


def frames(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype=np.uint8).reshape(-1, BYTES)


def _pm1_host(u8: np.ndarray) -> np.ndarray:
    """[k, 32] uint8 -> [k, 256] float64 of +-1, one entry a bit."""
    return np.unpackbits(u8, axis=1).astype(np.float64) * 2.0 - 1.0


def _percent(matched: int, total: int) -> int:
    return 100 * matched // total


def similarity(a: bytes, b: bytes, tol: int = TOL) -> int:
    """The similarity of two packed hashes (float64 +-1 products, exact)."""
    if not a or not b:
        return 0
    fa, fb = _pm1_host(frames(a)), _pm1_host(frames(b))
    dist = (BITS - fa @ fb.T) / 2
    hit = dist <= tol
    return min(
        _percent(int(hit.any(axis=1).sum()), len(fa)),
        _percent(int(hit.any(axis=0).sum()), len(fb)),
    )


def _pm1(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[k, 32] uint8 on a device -> [k, 256] +-1 of ``dtype``."""
    shifts = torch.arange(8, device=u8.device, dtype=torch.uint8)
    bits = (u8.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(u8.shape[0], BITS).to(dtype) * 2 - 1


def row_matches(
    blobs, rows, min_sim: int, device="cpu", tol: int = TOL,
    block_elems: int = 1 << 31, col_block: int = 1 << 19,
) -> dict[int, dict[int, int]]:
    """For each video r of ``rows``: {j: similarity} of every video j of
    ``blobs`` (r itself included) whose similarity with r reaches
    ``min_sim``.

    Every frame of the sampled rows is compared with every frame of the
    library, in blocks of at most ``block_elems`` frame pairs, as one
    matrix product of +-1 entries (float16 on a CUDA device, float32 on the
    CPU: every partial sum is an integer of magnitude at most 256, exact in
    both), thresholded at the dot product 256 - 2 tol; the matched frames
    are then counted per pair of videos on the host.
    """
    device = torch.device(device)
    dtype = torch.float16 if device.type == "cuda" else torch.float32
    n = len(blobs)
    lens = np.fromiter((len(b) // BYTES for b in blobs), dtype=np.int64, count=n)
    rows = np.unique(np.asarray(list(rows), dtype=np.int64))
    rows = rows[lens[rows] > 0]
    out: dict[int, dict[int, int]] = {int(r): {} for r in rows}
    if len(rows) == 0:
        return out
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    col_u8 = torch.from_numpy(np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(-1, BYTES).copy())
    col_u8 = col_u8.to(device)
    row_owner = np.repeat(rows, lens[rows])
    row_pm = _pm1(
        torch.from_numpy(np.frombuffer(b"".join(blobs[int(r)] for r in rows), dtype=np.uint8)
                         .reshape(-1, BYTES).copy()).to(device),
        dtype,
    )
    n_rf, n_cf = row_pm.shape[0], col_u8.shape[0]
    row_block = max(1, min(n_rf, block_elems // col_block))
    min_dot = BITS - 2 * tol
    hits_r, hits_c = [], []
    for c0 in range(0, n_cf, col_block):
        col_pm = _pm1(col_u8[c0 : c0 + col_block], dtype)
        for r0 in range(0, n_rf, row_block):
            dots = row_pm[r0 : r0 + row_block] @ col_pm.T
            nz = torch.nonzero(dots >= min_dot)
            hits_r.append((nz[:, 0] + r0).cpu())
            hits_c.append((nz[:, 1] + c0).cpu())
            del dots, nz
        del col_pm
    rf = torch.cat(hits_r).numpy().astype(np.int64)
    cf = torch.cat(hits_c).numpy().astype(np.int64)
    rv, cv = row_owner[rf], owner[cf]
    # matched row frames per (row video, column video), and matched column
    # frames per (row video, column video): each frame counted once
    key_a = np.unique(rf * n + cv)
    pair_a, ma = np.unique(row_owner[key_a // n] * n + key_a % n, return_counts=True)
    key_b = np.unique(cf * n + rv)
    pair_b, mb = np.unique((key_b % n) * n + owner[key_b // n], return_counts=True)
    if not np.array_equal(pair_a, pair_b):
        raise AssertionError("reference: a frame match counted on one side only")
    r_of, j_of = pair_a // n, pair_a % n
    sims = np.minimum(100 * ma // lens[r_of], 100 * mb // lens[j_of])
    keep = sims >= min_sim
    for r, j, s in zip(r_of[keep].tolist(), j_of[keep].tolist(), sims[keep].tolist()):
        out[r][j] = s
    del rv, cv
    return out
