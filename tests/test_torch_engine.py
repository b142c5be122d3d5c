"""GpuSearchEngine (on the CPU, through the plain PyTorch versions) against
the JAX package's TpuSearchEngine on the CPU.

Pair sets must be identical: the port's pruned route, its unpruned
segment and bucketed routes == the JAX pruned route == the JAX unpruned
segment route, including videos past the segment limit
(512 frames) and past the bucketed limit (1024 frames), the chunked
triangle (col_limit with col_state reuse and rows_at), and rep-cache
radius-cap invalidation.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
from hydrus_video_deduplicator_tpu_torch import scene_library
from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel import engine as eng
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
from hydrus_video_deduplicator_tpu_torch.utils import profiling

from .unit_tests.test_pruned_search import _flip, _mixed_corpus, _scene_video


def _port():
    return GpuSearchEngine(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    """Mixed scene corpus plus a 1100-frame video and its re-encode (past
    both the segment and the bucketed limits), two 600-frame ones, and the
    edges of the 1024 bucket: a 1024-frame video and its re-encoded first
    half (512 frames, across the segment limit), and a 513-frame video
    that holds a short video's frames after a real all-zero frame (a
    short x long pair scoring above 0 in one direction only, and a zero
    frame beside the bucket's all-zero padding); the JAX engines' all-pairs
    results at min_sim 1 are computed once."""
    rng = np.random.default_rng(4321)
    blobs = _mixed_corpus(rng, long_video=True)  # two 600-frame videos last
    very_long = _scene_video(rng, 110, 10)
    assert len(very_long) > 1024
    blobs.insert(10, very_long.tobytes())
    blobs.insert(20, np.stack([_flip(rng, f, 6) for f in very_long]).tobytes())
    full = _scene_video(rng, 64, 16)
    assert len(full) == 1024
    blobs.insert(5, full.tobytes())
    blobs.insert(15, np.stack([_flip(rng, f, 6) for f in full[:512]]).tobytes())
    short = np.frombuffer(blobs[3], np.uint8).reshape(-1, 32)
    filler = _scene_video(rng, 1, 512 - len(short))
    blobs.append(np.concatenate([np.zeros((1, 32), np.uint8), short, filler]).tobytes())
    assert len(blobs[-1]) // 32 == 513
    brute = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 1))
    pruned = sorted(TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 1))
    return blobs, brute, pruned


@pytest.mark.parametrize("min_sim", [1, 30, 75, 100])
def test_pruned_equals_jax(corpus, min_sim):
    blobs, brute, pruned = corpus
    want = [h for h in brute if h[2] >= min_sim]
    assert [h for h in pruned if h[2] >= min_sim] == want
    got = sorted(_port().find_pairs_pruned(blobs, blobs, min_sim))
    assert got == want
    lens = [len(b) // 32 for b in blobs]
    # the long-video complements contribute, on both sides of the limits
    assert any(lens[i] > 1024 and lens[j] > 1024 and i != j for i, j, _ in want)
    assert any(512 < lens[i] <= 1024 and i != j for i, j, _ in want)


def test_find_pairs_equals_jax(corpus):
    """The port's find_pairs (segment route, bucketed route for 513-1024
    frames, host path for the longest)."""
    blobs, brute, _ = corpus
    assert sorted(_port().find_pairs(blobs, blobs, 40)) == [h for h in brute if h[2] >= 40]


@pytest.mark.parametrize("min_sim", [1, 75])
def test_find_pairs_segment_route_equals_jax(corpus, min_sim, monkeypatch):
    """The unpruned segment route on the CPU (the kernel's plain version)
    gives the JAX segment route's pair list with its integer
    similarities; 513-1024-frame videos keep the bucketed route, longer
    ones the host path, and empty hashes match nothing."""
    blobs, brute, _ = corpus
    launches = []
    real = seg.similarity_segments

    def spy(*args):
        launches.append(args[0].shape[0] // seg.ROW_FRAMES)
        return real(*args)

    monkeypatch.setattr(seg, "similarity_segments", spy)
    got = sorted(_port().find_pairs(blobs, blobs, min_sim))
    assert got == [h for h in brute if h[2] >= min_sim]
    assert launches


def test_find_pairs_segment_route_in_triangle_chunks(corpus):
    """Stage 4's pattern on the unpruned route: row chunks sharing one
    col_state, each sweeping the corpus prefix up to its own end, against
    the JAX engine called the same way."""
    blobs, brute, _ = corpus
    n = len(blobs)
    cuts = [0, n // 3, 2 * n // 3, n]
    port = _port()
    jax_engine = TpuSearchEngine(force_segments=True)
    state: dict = {}
    jax_state: dict = {}
    got, want = [], []
    for r0, r1 in zip(cuts, cuts[1:]):
        rows = blobs[r0:r1]
        got += [
            (i + r0, j, s)
            for i, j, s in port.find_pairs(rows, blobs, 20, col_state=state, col_limit=r1)
        ]
        if r0 == 0:
            staged = state["seg_cols"]
        want += [
            (i + r0, j, s)
            for i, j, s in jax_engine.find_pairs(rows, blobs, 20, col_state=jax_state, col_limit=r1)
        ]
    assert state["seg_cols"] is staged  # the full column frames staged once
    assert sorted(got) == sorted(want)
    ends = np.searchsorted(cuts, np.arange(n), side="right")
    assert sorted(got) == [h for h in brute if h[2] >= 20 and h[1] < cuts[ends[h[0]]]]


def test_find_pairs_routes_by_bucket(corpus, monkeypatch):
    """Every bucket pair with both sides of at most 512 frames takes the
    segment route, whatever the call's size; the bucketed route sees only
    pairs with a 513-1024-frame side; a call whose columns hold no
    segment-eligible video stages and launches nothing."""
    blobs, brute, _ = corpus
    launches, bucket_pairs = [], []
    real_seg, real_bucket = seg.similarity_segments, GpuSearchEngine._bucket_pair

    def spy_seg(*args):
        launches.append(1)
        return real_seg(*args)

    def spy_bucket(self, pa, r_idx, r_frames, r_counts, pb, *rest):
        bucket_pairs.append((pa, pb))
        return real_bucket(self, pa, r_idx, r_frames, r_counts, pb, *rest)

    monkeypatch.setattr(seg, "similarity_segments", spy_seg)
    monkeypatch.setattr(GpuSearchEngine, "_bucket_pair", spy_bucket)
    lens = [len(b) // 32 for b in blobs]
    short = [k for k, n in enumerate(lens) if 1 <= n <= 512]
    pos = {k: p for p, k in enumerate(short[:2])}
    two = [blobs[k] for k in pos]  # one tiny call: 2 x 2 videos
    assert sorted(_port().find_pairs(two, two, 1)) == [
        (pos[i], pos[j], s) for i, j, s in brute if i in pos and j in pos
    ]
    assert launches and not bucket_pairs

    launches.clear()
    state: dict = {}
    assert sorted(_port().find_pairs(blobs, blobs, 1, col_state=state)) == brute
    assert launches and bucket_pairs
    assert all(max(pa, pb) > 512 for pa, pb in bucket_pairs)
    assert {max(pa, pb) for pa, pb in bucket_pairs} == {1024}

    launches.clear()
    long_cols = [b if 512 < n <= 1024 else b"" for b, n in zip(blobs, lens)]
    state = {}
    got = _port().find_pairs(blobs, long_cols, 1, col_state=state)
    assert not launches and "seg_cols" not in state
    assert sorted(got) == [h for h in brute if 512 < lens[h[1]] <= 1024]


@pytest.mark.parametrize("pruned", [False, True])
def test_bucketed_route_runs_the_similarity_block_both_ways(corpus, monkeypatch, pruned):
    """Every bucket pair with a 513-1024-frame side goes through
    ``similarity_block``: long rows against every column bucket, short rows
    against long columns. The pairs equal the JAX pairs with their integer
    similarities, the 513-frame video's one-directional pair among them;
    the pruned search reaches the route through its complements."""
    blobs, brute, _ = corpus
    calls = []
    real = sb.similarity_block

    def spy(rows_words, rows_counts, cols_words, cols_counts, pa, pb):
        calls.append((pa, pb))
        return real(rows_words, rows_counts, cols_words, cols_counts, pa, pb)

    monkeypatch.setattr(sb, "similarity_block", spy)
    engine = _port()
    search = engine.find_pairs_pruned if pruned else engine.find_pairs
    got = sorted(search(blobs, blobs, 1))
    assert got == brute
    assert all(max(pa, pb) == 1024 for pa, pb in calls)
    assert {pb for pa, pb in calls if pa == 1024} >= {4, 8, 1024}
    assert {pa for pa, pb in calls if pb == 1024} >= {4, 8}
    n513 = len(blobs) - 1
    (sim,) = [s for i, j, s in got if (i, j) == (3, n513)]
    assert 0 < sim < 100


def test_pruned_col_limit_state_reuse_and_rows_at(corpus):
    """The stage-4 pattern: two row chunks sharing col_state, each sweeping
    the corpus prefix up to its own end, rows looked up by position."""
    blobs, brute, _ = corpus
    n = len(blobs)
    half = n // 2
    engine = _port()
    state: dict = {}
    got_a = engine.find_pairs_pruned(
        blobs[:half], blobs, 20, col_state=state, col_limit=half, rows_at=0
    )
    staged = state["prune"]["seg_cols"]
    got_b = engine.find_pairs_pruned(
        blobs[half:], blobs, 20, col_state=state, col_limit=n, rows_at=half
    )
    assert state["prune"]["seg_cols"] is staged  # columns staged once
    want_a = [h for h in brute if h[2] >= 20 and h[0] < half and h[1] < half]
    want_b = [(i - half, j, s) for i, j, s in brute if s >= 20 and i >= half]
    assert sorted(got_a) == want_a
    assert sorted(got_b) == want_b


def test_pruned_exact_with_one_row_block_per_launch(corpus, monkeypatch):
    """A tiny mask budget puts one row block in each sweep launch: the row
    maps must stay right across tiles and the drain pipeline."""
    blobs, brute, _ = corpus
    pos = {k: p for p, k in enumerate(k for k, b in enumerate(blobs) if len(b) <= 32 * 512)}
    n = len(pos)
    many = [blobs[k] for k in pos] * 16  # > 256 videos: several row blocks
    monkeypatch.setattr(GpuSearchEngine, "CPU_MASK_BUDGET_BYTES", 1)
    launches = []
    real = seg.exists_mask_sweep

    def spy(a, *args):
        launches.append(a.shape[0] // seg.ROW_FRAMES)
        return real(a, *args)

    monkeypatch.setattr(seg, "exists_mask_sweep", spy)
    got = sorted(_port().find_pairs_pruned(many, many, 90, col_limit=n * 3))
    assert len(launches) > 1 and set(launches) == {1}
    want = sorted(
        (pos[i] + n * a, pos[j] + n * b, s)
        for i, j, s in brute
        if s >= 90 and i in pos and j in pos
        for a in range(16)
        for b in range(3)
    )
    assert got == want


def test_pruned_verify_reuses_row_span_blobs(corpus, monkeypatch):
    """DB-backed columns (the iter_many duck type) + rows_at: verify's
    column blobs inside the chunk's own row span are the in-memory row
    objects themselves; out-of-span ones are fetched; pairs stay exact."""
    blobs, brute, _ = corpus
    n = len(blobs)
    half = n // 2

    class SpyColumn:
        def __init__(self, items):
            self._items = items
            self.blob_n_frames = [len(b) // 32 for b in items]

        def __len__(self):
            return len(self._items)

        def __getitem__(self, i):
            return bytes(bytearray(self._items[int(i)]))

        def iter_many(self, indices):
            return ((int(i), bytes(bytearray(self._items[int(i)]))) for i in indices)

    captured: dict = {}
    real_verify = pair_verify.verify_pairs

    def spy_verify(pairs, row_blob, col_blob, min_sim, device, progress=None):
        captured.update(pairs=list(pairs), row_blob=row_blob, col_blob=col_blob)
        return real_verify(pairs, row_blob, col_blob, min_sim, device, progress)

    monkeypatch.setattr(pair_verify, "verify_pairs", spy_verify)
    rows = blobs[half:]
    got = sorted(
        _port().find_pairs_pruned(
            rows, SpyColumn(blobs), 20, col_state={}, col_limit=n, rows_at=half
        )
    )
    assert got == [(i - half, j, s) for i, j, s in brute if s >= 20 and i >= half]
    cand = captured["pairs"]
    in_span = [(i, j) for i, j in cand if half <= j < n]
    out_span = [(i, j) for i, j in cand if j < half]
    assert in_span and out_span
    for _, j in in_span:
        assert captured["col_blob"][j] is captured["row_blob"][j - half]
    for _, j in out_span:
        assert captured["col_blob"][j] == blobs[j]


def _boundary_pair(rng):
    """Leader distance exactly 31 + 2*24 = 79 between two 2-frame videos
    whose frames a, b sit at distance 31 (disjoint flips add exactly)."""
    used: set = set()
    c_a = rng.integers(0, 256, 32, dtype=np.uint8)
    a = _flip(rng, c_a, 24, used)
    b = _flip(rng, a, 31, used)
    c_b = _flip(rng, b, 24, used)
    return [np.stack([c_a, a]).tobytes(), np.stack([c_b, b]).tobytes()]


def test_triangle_bound_boundary_and_radius_cap_invalidation(rng):
    blobs = _boundary_pair(rng)
    want = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 1))
    assert (0, 1, 50) in want
    engine = _port()
    state: dict = {}
    assert sorted(engine.find_pairs_pruned(blobs, blobs, 1, col_state=state, radius_cap=24)) == want
    staged = state["prune"]["seg_cols"]
    # same state, smaller cap: the cap-24 reps and their staging are rebuilt
    assert sorted(engine.find_pairs_pruned(blobs, blobs, 1, col_state=state, radius_cap=8)) == want
    assert state["prune"]["rep_cols_radius_cap"] == 8
    assert state["prune"]["seg_cols"] is not staged


def test_state_from_jax_sweeps_from_the_same_reps(corpus, monkeypatch):
    """A JAX engine's host-side rep cache carried into the port: the port
    sweeps from exactly those reps (no re-clustering) and finds the same
    pairs."""
    from hydrus_video_deduplicator_tpu_torch.ops import reps as reps_mod

    blobs, brute, _ = corpus
    jax_state: dict = {}
    TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 60, col_state=jax_state)
    state = eng.state_from_jax(jax_state)
    assert state["prune"]["rep_cols"] == jax_state["prune"]["rep_cols"]
    assert state["prune"]["rep_cols_radius_cap"] == jax_state["prune"]["rep_cols_radius_cap"]

    def no_clustering(*_a, **_k):
        raise AssertionError("the port re-clustered the reps")

    monkeypatch.setattr(reps_mod, "extract_reps", no_clustering)
    got = sorted(_port().find_pairs_pruned(blobs, blobs, 60, col_state=state, rows_at=0))
    assert got == [h for h in brute if h[2] >= 60]


def test_drain_decode_word_w_bit_b_is_row_slot_32w_plus_b(rng):
    """Pins the mask layout the drain decodes: bit b of the word at [w, c]
    is row slot 32w+b, column slot c — against a dense bit-by-bit unpack,
    as the JAX suite pins its sparse and dense drain paths together."""
    masks = np.zeros((16, 300), dtype=np.uint32)
    want = set()
    for _ in range(400):
        rs, cs = int(rng.integers(0, 512)), int(rng.integers(0, 300))
        masks[rs // 32, cs] |= np.uint32(1) << np.uint32(rs % 32)
        want.add((rs, cs))
    masks[3, 7] = 0xFFFFFFFF  # bit 31 makes the int32 word negative
    want |= {(96 + b, 7) for b in range(32)}
    words = masks.view(np.int32)
    w, c = np.nonzero(words)
    rows, cols = eng.decode_mask_hits(w, c, words[w, c])
    assert set(zip(rows.tolist(), cols.tolist())) == want
    dense = {
        (32 * wi + b, ci)
        for wi in range(16)
        for ci in range(300)
        for b in range(32)
        if (int(masks[wi, ci]) >> b) & 1
    }
    assert dense == want


def test_drain_dense_clump_and_progress(rng):
    """A dense clump of identical videos (many bits per word) drains
    exactly, and progress runs to completion."""
    base = rng.integers(0, 256, (2, 32), dtype=np.uint8).tobytes()
    vids = [base] * 40 + [
        rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes()
        for c in rng.integers(1, 9, 30)
    ]
    want = sorted(TpuSearchEngine(force_segments=False).find_pairs(vids, vids, 75))
    events = []
    got = sorted(
        _port().find_pairs_pruned(vids, vids, 75, progress=lambda d, t: events.append((d, t)))
    )
    assert got == want and len(got) >= 1600
    assert events and events[-1][0] == events[-1][1]


@pytest.fixture(scope="module")
def hit_list_corpora():
    """Three libraries of segment-route videos, each with the JAX segment
    route's all-pairs list at 75 (sorted): uniform 8-frame clips with
    adjacent and far plants; scene videos of 1-512 frames with re-encoded
    and half-clip plants and empty hashes; a clump of 40 identical
    videos (1,600 hits in one row block) among short random ones."""
    rng = np.random.default_rng(99)
    clump = [rng.integers(0, 256, (2, 32), dtype=np.uint8).tobytes()] * 40
    clump += [
        rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes()
        for c in rng.integers(1, 9, 300)
    ]
    libraries = {
        "clips": scene_library.build_sweep_corpus(1200, seed=3, n_plant=40, n_far=20)[0],
        "scenes": scene_library.build_corpus(240, seed=5, median=48.0)[0],
        "clump": clump,
    }
    jax_engine = TpuSearchEngine(force_segments=True)
    return {
        name: (blobs, sorted(jax_engine.find_pairs(blobs, blobs, 75)))
        for name, blobs in libraries.items()
    }


#: the recorder's counts of the hit lists' drain and of the host scoring
HIT_COUNTS = ("seg.tiles", "seg.device_sims", "seg.sims_overflow", "seg.host_hits")


def _counted_search(blobs, layout) -> tuple[list, dict]:
    """find_pairs over ``blobs`` at 75, whole or (``triangle``) in three
    row chunks sharing one col_state, each up to its own end (col_limit),
    as stage 4 runs it; with the recorder's HIT_COUNTS summed over the
    calls."""
    profiling.enable(True)
    profiling.clear()
    try:
        engine = _port()
        if layout == "triangle":
            n = len(blobs)
            cuts = [0, n // 3, 2 * n // 3, n]
            state: dict = {}
            got = []
            for r0, r1 in zip(cuts, cuts[1:]):
                got += [
                    (i + r0, j, s)
                    for i, j, s in engine.find_pairs(
                        blobs[r0:r1], blobs, 75, col_state=state, col_limit=r1
                    )
                ]
        else:
            got = engine.find_pairs(blobs, blobs, 75)
        records = profiling.records()
    finally:
        profiling.enable(False)
        profiling.clear()
    counts = {name: sum(r.counts.get(name, 0) for r in records) for name in HIT_COUNTS}
    return got, counts


@pytest.mark.parametrize("layout", ["whole", "triangle", "one block"])
@pytest.mark.parametrize("library", ["clips", "scenes", "clump"])
def test_hit_lists_give_the_parents_list_in_order(hit_list_corpora, monkeypatch, library, layout):
    """The unpruned segment route with kernel 3's hit lists returns,
    element for element and in order, what it returns with every list of
    capacity 0 (each slab with a hit overflows: its mask decoded, its hits
    scored by matchHashBytes) and with lists one record short of the
    fullest slab's hits (that slab overflows, the others do not); sorted,
    it is the JAX segment route's list. The recorder counts every hit in
    seg.device_sims and none in seg.host_hits, the reverse with every list
    overflowing, and each forced overflow in seg.sims_overflow."""
    blobs, brute = hit_list_corpora[library]
    if layout == "one block":
        monkeypatch.setattr(GpuSearchEngine, "_row_blocks_per_tile", lambda self, n, s: 1)
    search = "triangle" if layout == "triangle" else "whole"
    found: list[int] = []  # each slab's hit count
    real_drain = GpuSearchEngine._drain

    def drain(self, slabs, *args):
        found.extend(int(seg.hit_count(hits)) for *_, hits in slabs)
        return real_drain(self, slabs, *args)

    monkeypatch.setattr(GpuSearchEngine, "_drain", drain)
    listed, counts = _counted_search(blobs, search)
    fullest = max(found)
    n_fullest = found.count(fullest)
    monkeypatch.setattr(GpuSearchEngine, "_hit_capacity", lambda self, rows: fullest - 1)
    tight, some = _counted_search(blobs, search)
    monkeypatch.setattr(GpuSearchEngine, "_hit_capacity", lambda self, rows: 0)
    scored, forced = _counted_search(blobs, search)

    assert listed == scored and tight == scored
    want = brute
    if search == "triangle":
        n = len(blobs)
        ends = np.asarray([n // 3, 2 * n // 3, n])
        want = [h for h in brute if h[1] < ends[np.searchsorted(ends, h[0], side="right")]]
    assert sorted(listed) == want and len(want) > len(blobs) // 2
    assert counts == {
        "seg.tiles": counts["seg.tiles"], "seg.device_sims": len(listed),
        "seg.sims_overflow": 0, "seg.host_hits": 0,
    }
    assert forced == {
        "seg.tiles": counts["seg.tiles"], "seg.device_sims": 0,
        "seg.sims_overflow": counts["seg.tiles"], "seg.host_hits": len(listed),
    }
    assert some["seg.sims_overflow"] == n_fullest and some["seg.host_hits"] > 0
    if layout == "one block":  # listed and scored slabs in one list
        assert counts["seg.tiles"] > 1 and some["seg.host_hits"] < len(listed)


def test_engine_keeps_tensors_on_its_device(corpus):
    blobs, _, _ = corpus
    engine = _port()
    state: dict = {}
    engine.find_pairs_pruned(blobs, blobs, 50, col_state=state)
    staged = state["prune"]["seg_cols"]
    assert staged["words"].device == torch.device("cpu")
    assert staged["words"].dtype == torch.int32
    assert staged["words"].shape == (staged["n_steps"] * seg.STEP_FRAMES, 8)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_on_cuda_equals_jax(corpus, cuda_device):
    """On the card: the sweep kernel, fp16 verify and the fp16 bucketed
    complements give the JAX pair sets, chunked triangle included."""
    blobs, brute, _ = corpus
    engine = GpuSearchEngine(device=cuda_device)
    before = seg.LAUNCHES["exists_mask_sweep"]
    assert sorted(engine.find_pairs_pruned(blobs, blobs, 1)) == brute
    assert seg.LAUNCHES["exists_mask_sweep"] > before
    assert sorted(engine.find_pairs(blobs, blobs, 1)) == brute
    n, half = len(blobs), len(blobs) // 2
    state: dict = {}
    got = engine.find_pairs_pruned(blobs[:half], blobs, 20, col_state=state, col_limit=half, rows_at=0)
    got += [
        (i + half, j, s)
        for i, j, s in engine.find_pairs_pruned(
            blobs[half:], blobs, 20, col_state=state, col_limit=n, rows_at=half
        )
    ]
    want = [h for h in brute if h[2] >= 20 and (h[0] >= half or h[1] < half)]
    assert sorted(got) == want


@pytest.mark.cuda
def test_segment_route_on_cuda_equals_jax(corpus, cuda_device):
    """On the card: the similarity kernel's mask mode, the drain and the
    host similarities give the JAX pair list, triangle chunks included."""
    blobs, brute, _ = corpus
    engine = GpuSearchEngine(device=cuda_device)
    before = seg.LAUNCHES["similarity_segments"]
    assert sorted(engine.find_pairs(blobs, blobs, 1)) == brute
    assert seg.LAUNCHES["similarity_segments"] > before
    n, half = len(blobs), len(blobs) // 2
    state: dict = {}
    got = engine.find_pairs(blobs[:half], blobs, 20, col_state=state, col_limit=half)
    got += [
        (i + half, j, s)
        for i, j, s in engine.find_pairs(blobs[half:], blobs, 20, col_state=state, col_limit=n)
    ]
    assert sorted(got) == [h for h in brute if h[2] >= 20 and (h[0] >= half or h[1] < half)]
