"""Batched PDQ frame hashing in plain PyTorch (counterpart of the JAX
package's ``models/pdq.py``).

Implements the exact-by-construction PDQ spec of
``vpdq.pdq_math`` (the port's copy) with the same fixed op
order as the numpy oracle (``vpdq/python_ref.py``), and takes every
constant from that module. Each float32 add and multiply is its own eager
PyTorch op, so nothing is contracted into an FMA: on the CPU and on the
card this pipeline is bit-identical to the oracle. No ``matmul``,
``einsum``, ``addcmul`` or ``torch.compile`` may enter it.

On the main path the filter stage (``_luma`` + ``_filter_and_decimate``)
runs as the hand-written CUDA kernel of ``ops/pdq_filter.py``; the tail
(``_quality``, ``_dct16``, ``_threshold_pack``) is shared by both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..vpdq import pdq_math as pm

_RECIPS = torch.from_numpy(np.asarray(pm.box_recips(pm.FRAME_DIM), dtype=np.float32))  # [512]
_DCT = torch.from_numpy(np.asarray(pm.DCT_MATRIX, dtype=np.float32))  # [16, 64]
_QS = float(pm.QUALITY_SCALE)  # an f32 value; multiplying an f32 tensor keeps f32
_BIT_WEIGHTS = torch.tensor([1 << j for j in range(pm.DCT_DIM)], dtype=torch.int32)  # [16]


@functools.cache
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reciprocal table, the DCT matrix and the packing bit weights on
    ``device``, copied once (a per-batch copy would block the host); one
    entry per device, kept for the process (devices are few)."""
    return _RECIPS.to(device), _DCT.to(device), _BIT_WEIGHTS.to(device)


def _shift(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """out[i] = x[i+k] along ``dim`` (k may be negative); exact 0.0 out of range."""
    n = x.shape[dim]
    zeros = torch.zeros_like(x.narrow(dim, 0, abs(k)))
    if k >= 0:
        return torch.cat([x.narrow(dim, k, n - k), zeros], dim)
    return torch.cat([zeros, x.narrow(dim, 0, n + k)], dim)


def _box_pass(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One window-4 box pass along ``dim`` (1: columns, 2: rows of [B, H, W]).

    The spec's pairwise-tree order: left pair a2, right pair b2, their sum,
    then the per-position f32 reciprocal multiply.
    """
    a2 = x + _shift(x, -1, dim)  # x[i-1] + x[i], left-clipped
    b2 = _shift(x, 1, dim) + _shift(x, 2, dim)  # x[i+1] + x[i+2], right-clipped
    s4 = a2 + b2  # sum x[i-1..i+2]
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    return s4 * _constants(x.device)[0].reshape(shape)


def _luma(frames_u8: torch.Tensor) -> torch.Tensor:
    """[B, 512, 512, 3] uint8 -> [B, 512, 512] f32 luma x1000 (exact)."""
    f = frames_u8.to(torch.int32)
    milli = pm.LUMA_R * f[..., 0] + pm.LUMA_G * f[..., 1] + pm.LUMA_B * f[..., 2]
    return milli.to(torch.float32)


def _filter_and_decimate(luma: torch.Tensor) -> torch.Tensor:
    """[B, 512, 512] f32 -> [B, 64, 64] f32: the full box passes (rows,
    cols, cols, rows — pdq_math's pass-order note), then the gather at
    (8i+4, 8j+4)."""
    x = _box_pass(luma, dim=2)  # rep 1: along each row
    x = _box_pass(x, dim=1)  # rep 1: along each column
    x = _box_pass(x, dim=1)  # rep 2: columns first
    x = _box_pass(x, dim=2)  # rep 2: rows second
    s, o = pm.DECIMATE_STRIDE, pm.DECIMATE_OFF
    return x[:, o::s, o::s].contiguous()


def _quality(buf64: torch.Tensor) -> torch.Tensor:
    """[B, 64, 64] f32 -> [B] int32 gradient quality (truncation toward
    zero, as C's cast does)."""
    dv = (buf64[:, :-1, :] - buf64[:, 1:, :]) * _QS
    dh = (buf64[:, :, :-1] - buf64[:, :, 1:]) * _QS
    gs = dv.to(torch.int32).abs().sum(dim=(1, 2)) + dh.to(torch.int32).abs().sum(dim=(1, 2))
    return torch.clamp(gs // pm.QUALITY_DENOM, max=pm.QUALITY_MAX).to(torch.int32)


def _dct16(buf64: torch.Tensor) -> torch.Tensor:
    """[B, 64, 64] f32 -> [B, 16, 16] f32: ``D @ buf64 @ D^T`` as two fixed
    k = 0..63 chains of multiply-then-add, one eager op each. Deliberately
    not a matmul: its reduction order would break bit parity."""
    d = _constants(buf64.device)[1]
    batch = buf64.shape[0]
    tmp = torch.zeros((batch, pm.DCT_DIM, pm.BUF_DIM), dtype=torch.float32, device=buf64.device)
    for k in range(pm.BUF_DIM):  # tmp = D @ buf
        tmp = tmp + d[None, :, k, None] * buf64[:, None, k, :]
    out = torch.zeros((batch, pm.DCT_DIM, pm.DCT_DIM), dtype=torch.float32, device=buf64.device)
    for k in range(pm.BUF_DIM):  # out = tmp @ D^T
        out = out + tmp[:, :, k, None] * d[None, None, :, k]
    return out


def _threshold_pack(dct: torch.Tensor) -> torch.Tensor:
    """[B, 16, 16] f32 -> [B, 16] int32 words (w[i] bit j = dct[i,j] > median,
    the median being the 128th-smallest of the 256 values)."""
    flat = dct.reshape(dct.shape[0], -1)
    median = torch.sort(flat, dim=1).values[:, flat.shape[1] // 2 - 1]
    bits = (dct > median[:, None, None]).to(torch.int32)
    return (bits * _constants(dct.device)[2]).sum(dim=2, dtype=torch.int32)


def pdq_hash_batch(frames_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash a batch of pre-scaled frames in plain PyTorch.

    Args:
      frames_u8: [B, 512, 512, 3] uint8 rgb24 (the JAX function's layout).

    Returns:
      (words, quality): [B, 16] int32 hash words (w0..w15, 16 low bits
      significant) and [B] int32 quality. :func:`words_to_blobs` turns
      words into canonical 32-byte blobs.
    """
    buf64 = _filter_and_decimate(_luma(frames_u8))
    return _threshold_pack(_dct16(buf64)), _quality(buf64)


# ---------------------------------------------------------------------------
# Host-side packing between device words and canonical 32-byte blobs
# ---------------------------------------------------------------------------


def words_to_blobs(words: np.ndarray) -> list[bytes]:
    """[B, 16] int/uint words -> list of canonical 32-byte PDQ blobs."""
    w = np.asarray(words, dtype=np.uint16)  # [B, 16], w0..w15
    be = w[:, ::-1].astype(">u2")  # w15..w0, big-endian each
    return [row.tobytes() for row in be]


def blobs_to_words(blobs: list[bytes]) -> np.ndarray:
    """Inverse of words_to_blobs: canonical blobs -> [B, 16] uint16 (w0..w15)."""
    out = np.zeros((len(blobs), pm.DCT_DIM), dtype=np.uint16)
    for i, blob in enumerate(blobs):
        if len(blob) != pm.BYTES_PER_HASH:
            raise ValueError(f"a PDQ blob is {pm.BYTES_PER_HASH} bytes, got {len(blob)}")
        out[i] = np.frombuffer(blob, dtype=">u2")[::-1]
    return out
