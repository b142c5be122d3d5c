"""Shared exact-math constants for the PDQ perceptual hash.

This module is the single source of truth for every numeric constant used by
the three PDQ implementations in this framework (numpy oracle, C++ native,
JAX/Pallas TPU). All three must produce bit-identical 256-bit hashes; that is
only possible if they share the exact same f32 constants and the exact same
op ordering. The op-ordering contract ("exact-by-construction PDQ") is:

1.  Luma:  ``luma_milli = 299*R + 587*G + 114*B`` in int32 (Rec.601 weights
    scaled by 1000 so the value is exact; max 255000 < 2^24 so the conversion
    to f32 is exact). The whole pipeline thereafter runs on a 1000x-scaled
    luma; PDQ's DCT/median threshold is scale-invariant so the resulting hash
    bits are unchanged vs an unscaled pipeline.
2.  Jarosz filter: two (rows, cols) passes of a window-4 box filter, i.e. the
    two-pass tent filter of reference PDQ. The window size follows upstream
    PDQ's computeJaroszFilterWindowSize: ceil(oldDim / (2 * newDim)) =
    ceil(512 / 128) = 4 — each box pass covers HALF the decimation stride so
    the two passes together tent over one full stride (upstream's own
    comment: 1024x1024 input -> window 8 = 16/2). The window span per output
    i is [i-1, i+2] clipped to the frame — the same span as upstream PDQ's
    box1D phase logic (halfWindow = (W+2)//2, right extent = halfWindow-1,
    left extent = W-1-right). Each pass uses a FIXED pairwise summation
    order over the zero-padded window:

        a2 = x + shift_up(x, 1)            # shift_up(v,k)[i] = v[i-k], 0 OOB
                                           # a2[i] = x[i-1] + x[i], left-clipped
        b2 = shift_down(x, 1) + shift_down(x, 2)
                                           # b2[i] = x[i+1] + x[i+2], right-clipped
        s4 = a2 + b2                       # s4[i] = sum x[i-1 .. i+2], both-clipped
        out = s4 * RECIP[count[i]]

    (3 adds in a fixed pairwise tree instead of upstream's sequential
    running-window add/subtract — the order every implementation must
    reproduce exactly). Out-of-frame terms are exact 0.0f. Multiplying by a
    shared f32 reciprocal constant (instead of dividing) makes CPU and TPU
    agree bitwise; it deviates from upstream PDQ's ``sum / count`` by <= 1
    ulp, far below the median-threshold decision noise, as is the
    tree-vs-sequential reassociation (measured: tests/unit_tests/
    test_pdq_upstream_fidelity.py hashes corpus + random + structured
    frames through a literal upstream-order oracle and records the max
    hash-bit divergence).

    Pass order: rep 1 filters rows then columns (like upstream); rep 2
    filters COLUMNS then rows (upstream repeats rows-then-cols). Box
    passes along different axes commute exactly in real arithmetic; the
    swap only reorders f32 roundings (~1 ulp pre-threshold, measured 0
    flipped hash bits over the fidelity corpus) and lets the TPU kernel
    evaluate both rep-2 passes ONLY at the 4::8 decimation sites with
    sublane-aligned gathers — rep 2 costs 1/8 of a full pass instead of
    two full passes. Every rep-2 output site is window-interior (rows/
    cols 3..510), so the restricted form is bit-identical to full
    swapped-order passes; implementations may use either.
3.  Decimate: sample the filtered 512x512 at (8i+4, 8j+4) — identical to
    upstream PDQ's ``(int)((i + 0.5) * 512 / 64)``. (The stride 8 is
    FRAME_DIM // BUF_DIM, independent of the box window.)
4.  Quality: sum over vertical+horizontal neighbor diffs of
    ``trunc((u - v) * QUALITY_SCALE)`` (QUALITY_SCALE folds upstream's
    ``* 100 / 255`` and our 1000x luma scale into one f32 constant);
    ``quality = min(gradient_sum // 90, 100)``.
5.  DCT: ``out16 = D @ buf64 @ D^T`` with the 16x64 DCT-II matrix
    ``D[i,j] = sqrt(2/64) * cos(pi/2/64 * (i+1) * (2j+1))`` (frequencies
    1..16, skipping DC — same as upstream). Both contractions are computed
    as fixed-order k=0..63 multiply-then-add chains in f32 (no FMA: the
    C++ build uses -ffp-contract=off; the JAX path uses lax.scan so XLA
    cannot re-recognize the chain as a reassociable dot).

    Bit-exactness scope: the numpy oracle, the C++ native path, and the
    TPU backend are strictly bit-identical. The XLA-**CPU** fallback is
    the one exception: LLVM contracts f32 mul+add into FMA regardless of
    XLA flags, which can shift DCT values ~1 ulp and flip a couple of
    near-median hash bits on degenerate (e.g. constant) frames — within
    the reference's own golden-test tolerance. The exact CPU path is the
    native hasher.
6.  Threshold: median = 128th-smallest of the 256 DCT outputs (equivalent to
    upstream's torben() for n=256); ``bit[i,j] = dct[i,j] > median``.
7.  Packing: bit index b = i*16 + j lives in 16-bit word ``w[i]`` at bit
    position j; the canonical 32-byte blob serializes words most-significant
    first: ``bytes[2*(15-i)] = w[i] >> 8; bytes[2*(15-i)+1] = w[i] & 0xff``
    (this reproduces upstream Hash256's hex string w15..w0, each %04x — the
    "PDQ-native byte order" the reference DB stores after its 0.10.0
    migration, upstream src/hydrusvideodeduplicator/db/DedupeDB.py:535-559).

Reference behavior citations (paths in the upstream hydrus-video-deduplicator repository):
- 512x512 rgb24 input frames: src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py:23,86-96
- quality >= 31 frames kept: src/hydrusvideodeduplicator/db/DedupeDB.py:550-553
- 32 bytes per frame hash:   src/hydrusvideodeduplicator/dedup.py:83
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

#: Input frame side length (frames are pre-scaled to FRAME_DIM x FRAME_DIM rgb24).
FRAME_DIM = 512
#: Intermediate buffer side after decimation.
BUF_DIM = 64
#: DCT output side (256 bits total).
DCT_DIM = 16
#: Bytes per packed frame hash.
BYTES_PER_HASH = 32

#: Jarosz box window for 512 -> 64: upstream PDQ's
#: computeJaroszFilterWindowSize(old, new) = (old + 2*new - 1) // (2*new),
#: i.e. ceil(old / (2*new)) == 4 — each of the two box passes covers half
#: the decimation stride so their composition (a tent) spans one stride.
WINDOW = (FRAME_DIM + 2 * BUF_DIM - 1) // (2 * BUF_DIM)
#: Window half extents: output i averages input [i - OFF_L, i + OFF_R].
#: Derived from upstream PDQ's box1D phases: halfWindow = (W + 2) // 2,
#: right extent = halfWindow - 1, left extent = W - 1 - right.
OFF_R = (WINDOW + 2) // 2 - 1
OFF_L = WINDOW - 1 - OFF_R

#: Number of (rows, cols) box passes. Two reps of (rows+cols) = tent filter.
N_REPS = 2

#: Decimation stride and center offset: out (i, j) samples the filtered
#: frame at (STRIDE*i + OFF, STRIDE*j + OFF).
DECIMATE_STRIDE = FRAME_DIM // BUF_DIM
DECIMATE_OFF = DECIMATE_STRIDE // 2
#: Decimation gather indices: floor((i + 0.5) * FRAME_DIM / BUF_DIM).
DECIMATE_IDX = ((2 * np.arange(BUF_DIM) + 1) * FRAME_DIM) // (2 * BUF_DIM)

# ---------------------------------------------------------------------------
# Luma (Rec.601, scaled x1000 so it is integer-exact)
# ---------------------------------------------------------------------------

LUMA_R, LUMA_G, LUMA_B = 299, 587, 114
LUMA_SCALE = LUMA_R + LUMA_G + LUMA_B  # 1000

# ---------------------------------------------------------------------------
# Quality metric
# ---------------------------------------------------------------------------

#: Upstream PDQ: d = (int)((u - v) * 100 / 255) on a 0..255-scale buffer.
#: Our buffer carries the x1000 luma scale, so fold everything into one f32
#: constant computed in f64 then rounded once.
QUALITY_SCALE = np.float32(np.float64(100.0) / (np.float64(255.0) * LUMA_SCALE))
#: quality = min(gradient_sum // QUALITY_DENOM, 100)
QUALITY_DENOM = 90
QUALITY_MAX = 100
#: Frames with quality below this are dropped from the video hash
#: (reference: db/DedupeDB.py:550-553 — ``>= 31`` kept).
QUALITY_MIN_KEEP = 31

# ---------------------------------------------------------------------------
# Similarity
# ---------------------------------------------------------------------------

#: Default Hamming tolerance (of 256 bits) for a frame-hash match
#: (reference: vpdqpy/vpdqpy.py:53 — tolerance 31, match when distance <= 31).
DEFAULT_DISTANCE_TOLERANCE = 31


def _f32_recip_table(max_count: int) -> np.ndarray:
    """f32 reciprocals 1/c computed in f64 then rounded once to f32."""
    table = np.zeros(max_count + 1, dtype=np.float32)
    table[1:] = (np.float64(1.0) / np.arange(1, max_count + 1, dtype=np.float64)).astype(np.float32)
    return table


#: RECIP[c] == f32(1.0/c) for window counts c in 1..WINDOW.
RECIP = _f32_recip_table(WINDOW)


def box_counts(n: int = FRAME_DIM) -> np.ndarray:
    """Live window count per output position: |[max(0,i-OFF_L), min(n-1,i+OFF_R)]|."""
    i = np.arange(n)
    lo = np.maximum(0, i - OFF_L)
    hi = np.minimum(n - 1, i + OFF_R)
    return (hi - lo + 1).astype(np.int32)


def box_recips(n: int = FRAME_DIM) -> np.ndarray:
    """f32 reciprocal of the live window count per output position."""
    return RECIP[box_counts(n)]


def dct_matrix() -> np.ndarray:
    """The 16x64 DCT-II matrix, computed in f64 and rounded once to f32.

    D[i, j] = sqrt(2/64) * cos((pi/2/64) * (i+1) * (2j+1)) — frequencies 1..16
    (skipping DC), identical to upstream PDQ's dct64To16 matrix.
    """
    i = np.arange(1, DCT_DIM + 1, dtype=np.float64)[:, None]
    j = np.arange(BUF_DIM, dtype=np.float64)[None, :]
    d = np.sqrt(np.float64(2.0) / BUF_DIM) * np.cos((np.pi / 2.0 / BUF_DIM) * i * (2.0 * j + 1.0))
    return d.astype(np.float32)


DCT_MATRIX = dct_matrix()

# Bit/byte packing ----------------------------------------------------------


def pack_bits_to_hash(bits: np.ndarray) -> bytes:
    """Pack a [16,16] bool array to the canonical 32-byte PDQ blob.

    bit (i, j) -> word w[i] bit j; blob = w15..w0 big-endian 16-bit words.
    """
    assert bits.shape == (DCT_DIM, DCT_DIM)
    words = (bits.astype(np.uint32) << np.arange(DCT_DIM, dtype=np.uint32)[None, :]).sum(axis=1)
    out = bytearray(BYTES_PER_HASH)
    for i in range(DCT_DIM):
        w = int(words[i])
        out[2 * (DCT_DIM - 1 - i)] = (w >> 8) & 0xFF
        out[2 * (DCT_DIM - 1 - i) + 1] = w & 0xFF
    return bytes(out)


def unpack_hash_to_bits(blob: bytes) -> np.ndarray:
    """Inverse of :func:`pack_bits_to_hash`: 32-byte blob -> [16,16] bool."""
    assert len(blob) == BYTES_PER_HASH
    bits = np.zeros((DCT_DIM, DCT_DIM), dtype=bool)
    for i in range(DCT_DIM):
        w = (blob[2 * (DCT_DIM - 1 - i)] << 8) | blob[2 * (DCT_DIM - 1 - i) + 1]
        for j in range(DCT_DIM):
            bits[i, j] = bool((w >> j) & 1)
    return bits
