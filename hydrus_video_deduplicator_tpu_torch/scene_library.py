"""A synthetic scene library of packed VPDQ hashes with planted duplicates.

The generative model of the JAX package's ``artifacts/sweep_scenes.py``,
as a function of the library size, the seed, the frame clip and the plants
(and no module state): at seed 7 with the 512-frame clip it gives that
script's blobs and plants byte for byte.

- frame count ~ LogNormal(ln 48, 0.9), rounded, clipped to [1, clip];
- shots: geometric with mean SHOT_MEAN = 6 frames, a uniform random 256-bit
  anchor per shot;
- within-shot drift: frame t of a shot differs from the anchor by about
  Binomial(256, min(0.012 t, 0.08)) bits;
- planted duplicates: re-encodes (every frame XOR up to REENC_BITS random
  bits) as adjacent pairs and far pairs (k, k + n // 2), and half-clips
  (the first half of a video, re-encoded); some empty hashes.

Unrelated frames lie about 128 bits apart, so the exact set of pairs at
or above a threshold is the planted pairs that reach it.

Long plants (``long_plants``, none by default) add pairs with a side of
LONG_MIN..clip frames, drawn after every other plant so the rest of the
library does not change: re-encodes of long videos placed at k + n // 2
(far) or k + 1 (adjacent), and half-clips of long videos, whose halves fall
at or below SEG_MAX_FRAMES.

``median`` sets the median of the frame-count model: 48 (the default) is
the mean-71 profile, 84 the mean-120 one (``HVD_SWEEP_MEDIAN=84`` of
``artifacts/sweep_scenes.py``).

``build_delta`` draws new videos for a library that ``build_corpus`` built,
as a user adds videos to an already-searched library: background videos
from the same model under a seed of their own, re-encodes of library
videos and pairs among the new videos, with the exact expected pairs.
"""

from __future__ import annotations

import numpy as np

from .vpdq import matchHashBytes

SHOT_MEAN = 6  # mean shot length, 1 fps frames
DRIFT_RATE = 0.012  # per-position per-bit flip probability slope
DRIFT_SAT = 0.08  # drift saturation (~20 bits from anchor)
REENC_BITS = 8  # re-encode noise bits per frame
MEDIAN_FRAMES = 48.0  # median of the lognormal frames-per-video model
MIN_SIM = 75
#: planted pairs, each capped by the library size n: adjacent re-encodes
#: (n // 20), far re-encodes (n // 40), half-clips (n // 40), empty hashes
#: (n // 50)
N_PLANT = 1_000
N_PLANT_FAR = 500
N_CLIP = 300
N_EMPTY = 100
GEN_CHUNK = 2_000_000  # frames per generation slab (bounds RNG temps)
#: the segment route's limit; a long video has more frames than this
SEG_MAX_FRAMES = 512
LONG_MIN = SEG_MAX_FRAMES + 1
#: build_delta's plants: re-encodes of library videos, pairs among the new
#: videos, and the seed of the new videos' draws
N_DELTA_CROSS = 500
N_DELTA_PAIRS = 100
DELTA_SEED = 11
#: build_sweep_corpus (artifacts/sweep_1m.py): its seed, the frames of a
#: video in the uniform corpus and the most in the mixed one, and the bytes
#: of one draw where only the generator's state after the frames is wanted
#: (a multiple of 4: numpy draws uint8 bytes four to a 32-bit word, so
#: draws of such sizes leave the generator where one draw of their sum does)
SWEEP_SEED = 42
SWEEP_FRAMES = 8
SWEEP_MAX_FRAMES = 64
SWEEP_SLAB_BYTES = 1 << 25


def frame_counts(
    rng: np.random.Generator, n: int, clip: int = 512, median: float = MEDIAN_FRAMES
) -> np.ndarray:
    """The frame count of each of n videos, gen_corpus's first draw from
    ``rng``: with a fresh generator of the same seed, the counts of the
    library it generates, before any plant."""
    return np.clip(
        np.rint(np.exp(rng.normal(np.log(median), 0.9, n))), 1, clip
    ).astype(np.int64)


def gen_corpus(
    rng: np.random.Generator, n: int, clip: int = 512, median: float = MEDIAN_FRAMES
):
    """Vectorised scene-model frames: (frames [F, 32] uint8, offsets [n+1])."""
    counts = frame_counts(rng, n, clip, median)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    f_total = int(offsets[-1])

    # per-frame shot structure: new-shot flags -> shot ids -> position in shot
    new_shot = rng.random(f_total) < (1.0 / SHOT_MEAN)
    new_shot[offsets[:-1]] = True  # first frame of each video starts a shot
    shot_id = np.cumsum(new_shot) - 1
    n_shots = int(shot_id[-1]) + 1
    shot_start = np.zeros(n_shots, dtype=np.int64)
    shot_start[shot_id[new_shot]] = np.nonzero(new_shot)[0]
    pos = np.arange(f_total, dtype=np.int64) - shot_start[shot_id]

    anchors = rng.integers(0, 256, (n_shots, 32), dtype=np.uint8)
    # drift probability per frame, quantized to AND-depth k: p = 2^-k
    p = np.minimum(DRIFT_RATE * pos, DRIFT_SAT)
    with np.errstate(divide="ignore"):
        k = np.where(p > 0, np.rint(-np.log2(np.maximum(p, 1e-9))), 99).astype(np.int8)
    k = np.clip(k, 3, 99)  # p <= 1/8 always; k=99 -> no drift (exact anchor)

    frames = np.empty((f_total, 32), dtype=np.uint8)
    for s0 in range(0, f_total, GEN_CHUNK):
        s1 = min(s0 + GEN_CHUNK, f_total)
        sl = slice(s0, s1)
        fa = anchors[shot_id[sl]]
        drift = np.zeros((s1 - s0, 32), dtype=np.uint8)
        kk = k[sl]
        active = kk < 99
        if active.any():
            depth = int(kk[active].max())
            mask = rng.integers(0, 256, (int(active.sum()), 32), dtype=np.uint8)
            for d in range(2, depth + 1):
                deeper = kk[active] >= d
                mask[deeper] &= rng.integers(0, 256, (int(deeper.sum()), 32), dtype=np.uint8)
            drift[active] = mask
        frames[sl] = fa ^ drift
    return frames, offsets


def _reencode(rng: np.random.Generator, src: bytes) -> bytes:
    """src with REENC_BITS random bits of every frame flipped."""
    arr = np.frombuffer(src, dtype=np.uint8).reshape(-1, 32).copy()
    pos = rng.integers(0, 256, (arr.shape[0], REENC_BITS))
    for f in range(arr.shape[0]):  # planted pairs only — not corpus-scale
        for pbit in pos[f]:
            arr[f, pbit // 8] ^= np.uint8(1 << (pbit % 8))
    return arr.tobytes()


def plant_layout(n: int):
    """build_corpus's plants in a library of n videos, before the long
    plants: (re-encode pairs, half-clip pairs, the index range the empty
    hashes are drawn from)."""
    n_plant = min(N_PLANT, n // 20)
    n_far = min(N_PLANT_FAR, n // 40)
    n_clip = min(N_CLIP, n // 40)
    plant_pairs = [(2 * kk, 2 * kk + 1) for kk in range(n_plant)]
    far0 = 2 * n_plant
    plant_pairs += [(far0 + kk, far0 + kk + n // 2) for kk in range(n_far)]
    clip0 = far0 + n_far
    clip_pairs = [(clip0 + 2 * kk, clip0 + 2 * kk + 1) for kk in range(n_clip)]
    return plant_pairs, clip_pairs, (clip0 + 2 * n_clip, n - n // 2 - 1)


def _expected(blob, pairs) -> dict:
    """(a, b) and (b, a) -> the exact integer similarity of every pair
    scoring >= MIN_SIM; blob(i) is video i's hash."""
    expected = {}
    for a, b in pairs:
        s = int(matchHashBytes(blob(a), blob(b)))
        if s >= MIN_SIM:
            expected[(a, b)] = s
            expected[(b, a)] = s
    return expected


def build_corpus(
    n: int, seed: int = 7, clip: int = 512, long_plants=(0, 0, 0), median: float = MEDIAN_FRAMES,
    with_plants: bool = False,
):
    """The library with its plants: (blobs, expected, n_empty), and with
    ``with_plants`` a fourth element, every planted (a, b) pair in the
    order they were placed, those scoring below MIN_SIM too.

    ``long_plants``: how many long (adjacent, far, half-clip) pairs to add;
    fewer are placed where the library holds too few long videos.
    ``expected`` maps (a, b) AND (b, a) video-index pairs to the exact
    integer similarity of every planted pair scoring >= MIN_SIM.
    """
    rng = np.random.default_rng(seed)
    frames, offsets = gen_corpus(rng, n, clip, median)
    blobs = [frames[offsets[i] : offsets[i + 1]].tobytes() for i in range(n)]
    del frames

    n_empty = min(N_EMPTY, n // 50)
    plant_pairs, clip_pairs, empty_range = plant_layout(n)
    for a, b in plant_pairs:
        blobs[b] = _reencode(rng, blobs[a])
    for a, b in clip_pairs:
        half = (len(blobs[a]) // 32 + 1) // 2 * 32
        blobs[b] = _reencode(rng, blobs[a][:half])
    empties = rng.choice(np.arange(*empty_range), size=n_empty, replace=False)
    for e in empties:
        blobs[int(e)] = b""

    long_adjacent, long_far, long_clip = long_plants
    if any(long_plants):
        used = {i for pair in plant_pairs + clip_pairs for i in pair}
        used |= {int(e) for e in empties}
        long_src = [i for i, b in enumerate(blobs) if len(b) // 32 >= LONG_MIN and i not in used]

        def take(limit: int, offset: int, below: int) -> list[tuple[int, int]]:
            pairs: list[tuple[int, int]] = []
            for i in long_src:
                if len(pairs) == limit:
                    break
                if i < below and i + offset < n and not {i, i + offset} & used:
                    used.update((i, i + offset))
                    pairs.append((i, i + offset))
            return pairs

        far_long = take(long_far, n // 2, n // 2)
        adjacent_long = take(long_adjacent, 1, n)
        clip_long = take(long_clip, 1, n)
        for a, b in far_long + adjacent_long:
            blobs[b] = _reencode(rng, blobs[a])
        for a, b in clip_long:
            half = (len(blobs[a]) // 32 + 1) // 2 * 32
            blobs[b] = _reencode(rng, blobs[a][:half])
        plant_pairs += far_long + adjacent_long
        clip_pairs += clip_long

    planted = plant_pairs + clip_pairs
    expected = _expected(blobs.__getitem__, planted)
    return (blobs, expected, n_empty, planted) if with_plants else (blobs, expected, n_empty)


def build_delta(
    blobs, n_new: int, n_cross: int = N_DELTA_CROSS, n_pairs: int = N_DELTA_PAIRS,
    median: float = MEDIAN_FRAMES,
):
    """n_new new videos for the library ``blobs`` that build_corpus built
    with the 512-frame clip and no long plants: (new_blobs, expected). New
    video k has index len(blobs) + k.

    - background: gen_corpus under DELTA_SEED at the library's profile
      (``median``);
    - ``n_cross`` re-encodes of library videos: new videos at every
      (n_new // n_cross)-th position, their sources spread by a stride
      over the library videos that no build_corpus plant or empty hash
      touches, so that they fall early, in the middle and at the end;
    - ``n_pairs`` pairs among the new videos, half adjacent (j, j + 1) and
      half far (j, j + n_new // 2), on positions no other plant holds.

    ``expected`` maps (a, b) AND (b, a) library-index pairs to the exact
    integer similarity of every delta plant scoring >= MIN_SIM; with
    build_corpus's own expected it is the whole library's after the delta.
    """
    n = len(blobs)
    if n_cross > n_new or 2 * n_pairs + n_cross > n_new:
        raise ValueError(f"{n_new} new videos cannot hold {n_cross} + 2 x {n_pairs} plants")
    rng = np.random.default_rng(DELTA_SEED)
    frames, offsets = gen_corpus(rng, n_new, median=median)
    new = [frames[offsets[i] : offsets[i + 1]].tobytes() for i in range(n_new)]
    del frames

    plant_pairs, clip_pairs, _ = plant_layout(n)
    touched = {i for pair in plant_pairs + clip_pairs for i in pair}
    free = np.asarray([i for i in range(n) if i not in touched and blobs[i]], dtype=np.int64)
    sources = free[np.linspace(0, len(free) - 1, n_cross).round().astype(np.int64)]
    stride = n_new // n_cross
    taken = set(range(0, n_cross * stride, stride))
    pairs = [(int(src), n + k * stride) for k, src in enumerate(sources)]

    def claim(start: int, offset: int) -> tuple[int, int]:
        """The first free (j, j + offset) at or after start."""
        j = start
        while j in taken or j + offset in taken:
            j += 1
        if j + offset >= n_new:
            raise ValueError(f"no room for a new pair at offset {offset}")
        taken.update((j, j + offset))
        return j, j + offset

    n_adjacent = n_pairs // 2
    new_pairs = [claim(k * (n_new // max(n_adjacent, 1)), 1) for k in range(n_adjacent)]
    n_far = n_pairs - n_adjacent
    half = n_new // 2
    new_pairs += [claim(k * (half // max(n_far, 1)), half) for k in range(n_far)]
    for src, dst in pairs:
        new[dst - n] = _reencode(rng, blobs[src])
    for a, b in new_pairs:
        new[b] = _reencode(rng, new[a])
    pairs += [(n + a, n + b) for a, b in new_pairs]
    return new, _expected(lambda i: blobs[i] if i < n else new[i - n], pairs)


def sweep_plants(n: int, n_plant: int = N_PLANT, n_far: int = N_PLANT_FAR):
    """build_sweep_corpus's planted (a, b) pairs in the order they are
    drawn: adjacent (2k, 2k + 1), then far (2 n_plant + k, 2 n_plant + k +
    n // 2)."""
    far0 = 2 * n_plant
    if n_far > n_plant or far0 + n_far + n // 2 > n:
        raise ValueError(f"{n} videos cannot hold {n_plant} + {n_far} planted pairs")
    pairs = [(2 * k, 2 * k + 1) for k in range(n_plant)]
    return pairs + [(far0 + k, far0 + k + n // 2) for k in range(n_far)]


def _sweep_counts(rng, n: int, lengths: str, frames: int) -> np.ndarray:
    """The first draw of the mixed corpus: each video's frame count; the
    uniform corpus draws none."""
    if lengths == "uniform":
        return np.full(n, frames, dtype=np.int64)
    if lengths == "mixed":
        return rng.integers(1, SWEEP_MAX_FRAMES + 1, n)
    raise ValueError(f"lengths must be 'uniform' or 'mixed', got {lengths!r}")


def _sweep_empties(rng, n: int, n_plant: int, n_empty: int) -> np.ndarray:
    """The mixed corpus's empty hashes, drawn after its frames, past every
    plant's first video and before n // 2."""
    return rng.choice(np.arange(3 * n_plant, n - n // 2), size=n_empty, replace=False)


def sweep_frame_counts(
    n: int, lengths: str = "uniform", *, seed: int = SWEEP_SEED, frames: int = SWEEP_FRAMES,
    n_plant: int = N_PLANT, n_far: int = N_PLANT_FAR, n_empty: int = N_EMPTY,
) -> np.ndarray:
    """The frame count of each video of ``build_sweep_corpus`` with the
    same arguments, the plants and the empty hashes included (0 for an
    empty hash), without holding the frames: the mixed corpus's byte draw
    is made in SWEEP_SLAB_BYTES slabs and dropped."""
    rng = np.random.default_rng(seed)
    counts = _sweep_counts(rng, n, lengths, frames)
    if lengths == "mixed":
        left = int(counts.sum()) * 32
        while left:
            step = min(SWEEP_SLAB_BYTES, left)
            rng.integers(0, 256, (step,), dtype=np.uint8)
            left -= step
        counts[_sweep_empties(rng, n, n_plant, n_empty)] = 0
    for a, b in sweep_plants(n, n_plant, n_far):
        counts[b] = counts[a]
    return counts


def build_sweep_corpus(
    n: int, lengths: str = "uniform", *, seed: int = SWEEP_SEED, frames: int = SWEEP_FRAMES,
    n_plant: int = N_PLANT, n_far: int = N_PLANT_FAR, n_empty: int = N_EMPTY,
):
    """The corpus of the JAX package's ``artifacts/sweep_1m.py`` (its
    ``main``'s draws, in its order, from ``np.random.default_rng(seed)``):
    (blobs, expected, n_empty).

    - ``"uniform"``: n videos of ``frames`` random frames, no empty hash;
    - ``"mixed"``: 1..64 random frames a video, then ``n_empty`` empty
      hashes at indices in [3 n_plant, n - n // 2);
    - plants (``sweep_plants``): video b becomes video a with 3 random
      bits of each frame flipped (a position over the blob, then a bit).

    ``expected`` maps (a, b) AND (b, a) to the exact integer similarity
    of every plant (native matchHashBytes); each must reach MIN_SIM.
    """
    rng = np.random.default_rng(seed)
    counts = _sweep_counts(rng, n, lengths, frames)
    if lengths == "uniform":
        raw = rng.integers(0, 256, (n, frames * 32), dtype=np.uint8)
        blobs = [row.tobytes() for row in raw]
        del raw
        n_empty = 0
    else:
        flat = rng.integers(0, 256, (int(counts.sum()) * 32,), dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(counts * 32)])
        fb = flat.tobytes()
        del flat
        blobs = [fb[offs[i] : offs[i + 1]] for i in range(n)]
        del fb
        for e in _sweep_empties(rng, n, n_plant, n_empty):
            blobs[int(e)] = b""

    plants = sweep_plants(n, n_plant, n_far)
    for a, b in plants:
        src = bytearray(blobs[a])
        flips = rng.integers(0, len(src), size=max(1, 3 * (len(src) // 32)))
        for f in flips:
            src[int(f)] ^= 1 << int(rng.integers(0, 8))
        blobs[b] = bytes(src)
    expected = {}
    for a, b in plants:
        s = int(matchHashBytes(blobs[a], blobs[b]))
        if s < MIN_SIM:
            raise AssertionError(f"planted pair ({a}, {b}) scores {s} < {MIN_SIM}")
        expected[(a, b)] = expected[(b, a)] = s
    return blobs, expected, n_empty
