"""Bit-packed VPDQ hash primitives (counterpart of the JAX package's
``ops/similarity.py`` and ``similarity_pallas.unpack_pm1_host``).

Representations, as in the reference:

- canonical blob: 32 bytes/frame (storage format, DB + matchHashBytes);
- packed: [F, 8] 32-bit words, bit b of frame f = word[f, b // 32] >> (b % 32);
  the little-endian word view of the blob's byte rows. On the device the
  words travel as ``int32``: torch's ``uint32`` supports few operations.
  A right shift of an ``int32`` sign-extends, so every shift is followed
  by ``& 1``;
- ±1 form: [F, 256] in {-1, +1}. dot(a, b) = 256 - 2 * hamming(a, b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..vpdq import pdq_math as pm

BYTES = pm.BYTES_PER_HASH  # 32
LANES = BYTES // 4  # 8 words per 256-bit hash
BITS = 8 * BYTES  # 256
TOL = pm.DEFAULT_DISTANCE_TOLERANCE  # 31
#: dot >= MATCH_DOT  <=>  hamming <= TOL
MATCH_DOT = BITS - 2 * TOL


def blobs_to_packed(blob: bytes) -> np.ndarray:
    """Packed hash blob (32N bytes) -> [N, 8] uint32 words."""
    arr = np.frombuffer(blob, dtype=np.uint8).reshape(-1, BYTES)
    return arr.view(np.uint32)


def packed_to_blobs(packed: np.ndarray) -> bytes:
    """Inverse of blobs_to_packed."""
    return np.ascontiguousarray(packed.astype(np.uint32)).view(np.uint8).tobytes()


def to_words(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 packed words (numpy) -> the same bits as an int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(packed).view(np.int32)).to(device)


def unpack_pm1(words: torch.Tensor, dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] in {-1, +1} (bit set -> +1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], BITS)
    return (bits * 2 - 1).to(dtype)


def unpack_pm1_host(packed: np.ndarray, counts: np.ndarray | None = None) -> np.ndarray:
    """[V, P, 8] uint32 -> [V*P, 256] int8 ±1; frames at or past each
    video's count (counts [V]) become zero rows. Bit j of word l is hash
    bit l*32 + j: np.unpackbits' little order on the raw bytes."""
    v, p, _lanes = packed.shape
    u8 = np.ascontiguousarray(packed).view(np.uint8).reshape(v * p, BYTES)
    bits = np.unpackbits(u8, axis=1, bitorder="little")
    # 0/1 -> -1/+1 without an astype copy: uint8 wraps 0*2-1 to 255 == -1
    bits *= 2
    bits -= 1
    pm1 = bits.view(np.int8)
    if counts is not None:
        invalid = np.arange(p)[None, :] >= np.asarray(counts, np.int64)[:, None]
        pm1.reshape(v, p, BITS)[invalid] = 0
    return pm1
