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

Below them, the JAX module's XLA reference functions as plain torch ops on
the tensors' device (``hamming_tile*``, ``video_pair_similarity``,
``int_similarity_to_distance``): test oracles, which no path of the
program calls.
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


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 ``a @ b`` of integer matrices. torch has no integer
    matmul on CUDA, so there it goes through float64, exact while every
    partial sum stays below 2**53 (these oracles sum at most a few
    thousand small integers)."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return (a.to(torch.float64) @ b.to(torch.float64)).round().to(torch.int64)


def hamming_tile(a_pm1: torch.Tensor, b_pm1: torch.Tensor) -> torch.Tensor:
    """[Fa, 256] x [Fb, 256] ±1 -> [Fa, Fb] int32 Hamming distances:
    dot = 256 - 2d, so d = (256 - dot) >> 1."""
    dot = _int_matmul(a_pm1, b_pm1.T)
    return ((BITS - dot) >> 1).to(torch.int32)


def hamming_tile_packed(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """Hamming distances straight from [F, 8] int32 words."""
    return hamming_tile(unpack_pm1(a_words), unpack_pm1(b_words))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 in, int64 out), by the SWAR sum
    on the zero-extended word."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_tile_popcount(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """The same distances by XOR and population count of the words."""
    x = a_words[:, None, :] ^ b_words[None, :, :]
    return _popcount32(x).sum(dim=2).to(torch.int32)


def video_pair_similarity(
    ham: torch.Tensor,
    a_video_ids: torch.Tensor,
    b_video_ids: torch.Tensor,
    a_frame_counts: torch.Tensor,
    b_frame_counts: torch.Tensor,
    num_a: int,
    num_b: int,
    tolerance: int = TOL,
) -> torch.Tensor:
    """Aggregate a frame-level Hamming tile into video-level integer
    similarity: the readable reference of the match-fraction semantics
    that the kernels implement on their own layouts.

    ham: [Fa, Fb] frame Hamming distances; padding frames carry the video
    id num_a / num_b (out of range). a/b_video_ids: [Fa] / [Fb] video
    index per frame. a/b_frame_counts: [num_a] / [num_b] true frame counts
    (0 for empty videos). Returns [num_a, num_b] int32 similarity in
    [0, 100]: min(100 * ma // fa, 100 * mb // fb), 0 where either side is
    empty.
    """
    dev = ham.device
    matched = (ham <= tolerance).to(torch.int64)  # [Fa, Fb]
    onehot_a = (a_video_ids[:, None] == torch.arange(num_a, device=dev)[None, :]).to(torch.int64)
    onehot_b = (b_video_ids[:, None] == torch.arange(num_b, device=dev)[None, :]).to(torch.int64)
    # frame fa matches some frame of video vb; frame fb of some frame of va
    frame_hits_b = (_int_matmul(matched, onehot_b) > 0).to(torch.int64)  # [Fa, num_b]
    frame_hits_a = (_int_matmul(onehot_a.T, matched) > 0).to(torch.int64)  # [num_a, Fb]
    ma = _int_matmul(onehot_a.T, frame_hits_b)  # [num_a, num_b] matched-a counts
    mb = _int_matmul(frame_hits_a, onehot_b)  # [num_a, num_b] matched-b counts
    a_counts = a_frame_counts.to(torch.int64)
    b_counts = b_frame_counts.to(torch.int64)
    sim_a = torch.div(100 * ma, a_counts.clamp(min=1)[:, None], rounding_mode="floor")
    sim_b = torch.div(100 * mb, b_counts.clamp(min=1)[None, :], rounding_mode="floor")
    nonempty = (a_counts[:, None] > 0) & (b_counts[None, :] > 0)
    return torch.where(nonempty, torch.minimum(sim_a, sim_b), 0).to(torch.int32)


def int_similarity_to_distance(sim: torch.Tensor) -> torch.Tensor:
    """Reference distance mapping: (100 - int(similarity)) + 1 in [1, 101]."""
    return (100 - sim) + 1
