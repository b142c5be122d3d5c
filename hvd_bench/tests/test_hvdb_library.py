"""The frozen generators against the port's scene_library, and the plain
reference against a brute force of its own."""

import numpy as np
import pytest
from hvdb import library, reference

from hydrus_video_deduplicator_tpu_torch import scene_library as port
from hydrus_video_deduplicator_tpu_torch.vpdq import matchHashBytes


@pytest.mark.parametrize("n, seed, clip, long_plants, median", [
    (600, 7, 512, (0, 0, 0), 48.0),
    (800, 3_000_000_001, 512, (0, 0, 0), 48.0),
    (1_200, 5, 1024, (4, 2, 2), 160.0),
])
def test_build_corpus_equals_the_port(n, seed, clip, long_plants, median):
    blobs, expected, n_empty, planted = library.build_corpus(n, seed, clip, long_plants, median)
    p_blobs, p_expected, p_empty, p_planted = port.build_corpus(
        n, seed=seed, clip=clip, long_plants=long_plants, median=median, with_plants=True
    )
    assert blobs == p_blobs and expected == p_expected
    assert (n_empty, planted) == (p_empty, p_planted)


def test_build_delta_equals_the_port():
    blobs = library.build_corpus(700, 11)[0]
    new, expected, planted = library.build_delta(blobs, 400, 50, 20)
    p_new, p_expected = port.build_delta(blobs, 400, 50, 20)
    assert new == p_new and expected == p_expected
    assert {(a, b) for a, b in expected} <= {p for ab in planted for p in (ab, ab[::-1])}


@pytest.mark.parametrize("lengths", ["uniform", "mixed"])
def test_build_sweep_corpus_equals_the_port(lengths):
    args = dict(seed=9, frames=8, n_plant=60, n_far=30, n_empty=20)
    blobs, expected, n_empty, planted = library.build_sweep_corpus(2_000, lengths, **args)
    p_blobs, p_expected, p_empty = port.build_sweep_corpus(2_000, lengths, **args)
    assert blobs == p_blobs and expected == p_expected and n_empty == p_empty
    assert planted == port.sweep_plants(2_000, 60, 30)


def brute_similarity(a: bytes, b: bytes) -> int:
    """XOR and popcount, then the same rule: the test's own brute force."""
    if not a or not b:
        return 0
    fa = np.frombuffer(a, np.uint8).reshape(-1, 32)
    fb = np.frombuffer(b, np.uint8).reshape(-1, 32)
    dist = np.unpackbits(fa[:, None, :] ^ fb[None, :, :], axis=2).sum(axis=2)
    hit = dist <= 31
    return min(100 * int(hit.any(1).sum()) // len(fa), 100 * int(hit.any(0).sum()) // len(fb))


def all_pairs(blobs, min_sim):
    return {
        (a, b): s for a in range(len(blobs)) for b in range(a + 1, len(blobs))
        if (s := brute_similarity(blobs[a], blobs[b])) >= min_sim
    }


def reference_pairs(blobs, min_sim, rows=None):
    rows = range(len(blobs)) if rows is None else rows
    out = {}
    for r, matches in reference.row_matches(blobs, rows, min_sim, col_block=1 << 12).items():
        for j, s in matches.items():
            if j != r:
                out[(min(r, j), max(r, j))] = s
    return out


def test_reference_finds_the_planted_scene_pairs():
    blobs, expected, _, _ = library.build_corpus(240, 21)
    want = all_pairs(blobs, 75)
    assert reference_pairs(blobs, 75) == want
    assert want == {(a, b): s for (a, b), s in expected.items() if a < b}


def test_reference_finds_the_planted_delta_pairs():
    blobs = library.build_corpus(200, 4)[0]
    new, expected, _ = library.build_delta(blobs, 120, 20, 10)
    both = blobs + new
    want = {k: s for k, s in all_pairs(both, 75).items() if k[1] >= len(blobs)}
    got = {k: s for k, s in reference_pairs(both, 75, range(len(blobs), len(both))).items()}
    assert got == want == {(a, b): s for (a, b), s in expected.items() if a < b}


def test_reference_finds_the_planted_sweep_pairs():
    blobs, expected, _, _ = library.build_sweep_corpus(
        400, "mixed", seed=5, n_plant=40, n_far=20, n_empty=10
    )
    want = all_pairs(blobs, 75)
    assert reference_pairs(blobs, 75) == want == {(a, b): s for (a, b), s in expected.items() if a < b}


def test_reference_similarity_agrees_with_the_program_and_brute_force():
    """Every similarity, not only the planted ones: the reference, the test's
    brute force and the program's matchHashBytes, over pairs of all
    similarities (half-clips, partial overlaps, empties)."""
    blobs, _, _, planted = library.build_corpus(400, 8)
    rng = np.random.default_rng(0)
    pairs = planted + [tuple(p) for p in rng.integers(0, 400, (200, 2))]
    cut = [(a, b[: 32 * k]) for a, b in [(blobs[x], blobs[y]) for x, y in planted[:50]]
           for k in (1, 3, 7)]
    seen = set()
    for a, b in [(blobs[x], blobs[y]) for x, y in pairs] + cut:
        s = reference.similarity(a, b)
        seen.add(s)
        assert s == brute_similarity(a, b) == int(matchHashBytes(a, b))
    assert len(seen) > 10
