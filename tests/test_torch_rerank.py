"""The port's embedding rerank (``rerank.py``, ``--rerank clip``) against
the JAX package's, on the CPU: the gate's decisions and counts, the CLI on
the fake Hydrus corpus at a threshold every pair clears and at one none
can, a threshold that splits the corpus pairs (the VP-tree and the
all-pairs engine mark the JAX ``main()``'s set and count), and the refusal
without weights. Weights are pixel-identity checkpoints from
``make_synthetic_params``: their embeddings track visual content."""

from __future__ import annotations

import itertools
import re
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu import entrypoint as jax_entrypoint
from hydrus_video_deduplicator_tpu import rerank as jax_rerank
from hydrus_video_deduplicator_tpu.models import embed as jax_embed
from hydrus_video_deduplicator_tpu_torch import dedup, entrypoint, rerank

from .fake_hydrus import (
    CORPUS_EXPECTED_PAIRS,
    DEFAULT_ACCESS_KEY,
    FakeHydrus,
    corpus_file_store,
    sha256_hex,
)

#: the subset of the corpus that test_torch_orchestrator.py runs: scene_b
#: (6 encodings) and scene_d (5), whose same-scene pairs are the 25
#: candidates, and two files that match nothing
SUBSET = ("scene_b/", "scene_d/", "strange/one_frame.gif", "strange/mono.y4m")
SUBSET_PAIRS = 25
#: the seed of the pixel-identity weights of the splitting threshold
SPLIT_SEED = 1
#: the least distance of the splitting threshold from any pair's cosine
SPLIT_MARGIN = 1e-3


def write_weights(path: Path, seed: int) -> Path:
    np.savez(path, **jax_embed.make_synthetic_params(np.random.default_rng(seed), pixel_identity=True))
    return path


def subset_store() -> tuple[dict[str, bytes], dict[str, str]]:
    """({sha256: bytes}, {sha256: scene directory}) of the subset."""
    videos = Path(__file__).parent / "corpus" / "videos"
    store, scene = {}, {}
    for vid in sorted(videos.rglob("*")):
        rel = vid.relative_to(videos).as_posix()
        if vid.is_file() and rel.startswith(SUBSET):
            data = vid.read_bytes()
            store[sha256_hex(data)] = data
            scene[sha256_hex(data)] = rel.split("/")[0]
    return store, scene


def splitting_threshold(weights: Path) -> tuple[float, set[frozenset]]:
    """A threshold that splits the subset's candidate pairs (same scene),
    from the JAX package's embeddings: the middle of the widest gap between
    their cosines, at least SPLIT_MARGIN from every one of them; and the
    candidate pairs at or above it."""
    store, scene = subset_store()
    rr = jax_rerank.ClipReranker(str(weights), threshold=0.0)
    emb = {h: rr._embed(h, store.__getitem__) for h in store}
    cos = {
        frozenset((a, b)): float(np.dot(emb[a], emb[b]))
        for a, b in itertools.combinations(sorted(store), 2)
        if scene[a] == scene[b] != "strange"
    }
    assert len(cos) == SUBSET_PAIRS
    ranked = sorted(cos.values())
    gap = int(np.argmax(np.diff(ranked)))
    threshold = (ranked[gap] + ranked[gap + 1]) / 2
    assert min(abs(c - threshold) for c in ranked) >= SPLIT_MARGIN, (threshold, ranked)
    kept = {p for p, c in cos.items() if c >= threshold}
    assert 0 < len(kept) < SUBSET_PAIRS
    return threshold, kept


def run_main(main, store, db_dir, capsys=None, **kwargs):
    """main() against a fake Hydrus server holding ``store``: (reported
    pairs, marked pairs, the rerank summary line or None)."""
    server = FakeHydrus(store)
    server.start()
    try:
        pairs = main(
            api_key=DEFAULT_ACCESS_KEY, api_url=server.url, dedup_database_dir=Path(db_dir),
            rerank="clip", **kwargs,
        )
    finally:
        server.stop()
    summary = None
    if capsys is not None:
        out = " ".join(capsys.readouterr().out.split())
        found = re.findall(r"Rerank: \d+ of \d+ candidate pairs rejected by the embedding gate\.", out)
        summary = found[-1] if found else None
    return pairs, {frozenset(p) for p in server.relationships}, summary


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The splitting threshold and the JAX main()'s result at it."""
    weights = write_weights(tmp_path_factory.mktemp("weights") / "vit.npz", SPLIT_SEED)
    threshold, kept = splitting_threshold(weights)
    store, _ = subset_store()
    pairs, marked, _ = run_main(
        jax_entrypoint.main, store, tmp_path_factory.mktemp("jax"), search_backend="tpu",
        rerank_weights=str(weights), rerank_threshold=threshold,
    )
    assert marked == kept and pairs == len(kept)
    return weights, threshold, pairs, marked


@pytest.mark.parametrize("search_backend", ["tree", "gpu"])
def test_a_splitting_threshold_marks_the_jax_pairs(split, tmp_path, search_backend):
    weights, threshold, jax_pairs, jax_marked = split
    store, _ = subset_store()
    pairs, marked, _ = run_main(
        entrypoint.main, store, tmp_path, search_backend=search_backend, device="cpu",
        rerank_weights=str(weights), rerank_threshold=threshold,
    )
    assert marked == jax_marked
    assert pairs == jax_pairs


def _y4m(seed: int) -> bytes:
    """Two 128x128 frames of 16x16 colour blocks from a seed, as YUV4MPEG2."""
    f = np.repeat(
        np.repeat(np.random.default_rng(seed).integers(0, 256, (16, 16, 3), dtype=np.uint8), 8, 0),
        8, 1,
    )
    h, w = f.shape[:2]
    out = [f"YUV4MPEG2 W{w} H{h} F1:1 C444\n".encode()]
    for _ in range(2):
        r, g, b = (f[:, :, i].astype(np.int32) for i in range(3))
        y = np.clip((299 * r + 587 * g + 114 * b + 500) // 1000, 0, 255)
        u = np.clip(((b - y) * 564 + 500) // 1000 + 128, 0, 255)
        v = np.clip(((r - y) * 713 + 500) // 1000 + 128, 0, 255)
        out += [b"FRAME\n", *(c.astype(np.uint8).tobytes() for c in (y, u, v))]
    return b"".join(out)


def test_the_gate_decides_and_counts_as_the_jax_gate(tmp_path):
    weights = str(write_weights(tmp_path / "vit.npz", 7))
    store = {"a": _y4m(1), "b": _y4m(1), "c": _y4m(2)}

    def missing(h):
        raise KeyError(h)

    ours = rerank.ClipReranker(weights, threshold=0.95, device="cpu")
    theirs = jax_rerank.ClipReranker(weights, threshold=0.95)
    for rr in (ours, theirs):
        assert rr.pair_passes("a", "b", store.__getitem__)
        assert not rr.pair_passes("a", "c", store.__getitem__)
        assert rr.pair_passes("a", "missing", missing)  # fail-open
        assert rr.pair_passes("c", "c", store.__getitem__)
    assert (ours.pairs_checked, ours.pairs_rejected) == (theirs.pairs_checked, theirs.pairs_rejected)
    assert (ours.pairs_checked, ours.pairs_rejected) == (4, 1)
    assert ours._cache.keys() == theirs._cache.keys() and ours._cache["missing"] is None
    np.testing.assert_allclose(ours._cache["c"], theirs._cache["c"], rtol=0, atol=1e-5)
    assert rerank.MAX_EMBED_FRAMES == jax_rerank.MAX_EMBED_FRAMES == 32


def test_cli_gate_keeps_every_pair_at_0_6_and_none_at_1_01(tmp_path, capsys):
    """As the JAX package's end-to-end gate test: on the whole corpus a
    sane threshold keeps the 101 pairs, an impossible one (> 1) gates every
    pair out (here on the same database, its search cache cleared, so the
    files are not hashed again)."""
    weights = str(write_weights(tmp_path / "vit.npz", 7))
    store = corpus_file_store()
    db = tmp_path / uuid.uuid4().hex
    server = FakeHydrus(store)
    server.start()
    try:
        run = dict(
            api_key=DEFAULT_ACCESS_KEY, api_url=server.url, dedup_database_dir=db,
            rerank="clip", rerank_weights=weights, device="cpu",
        )
        pairs = entrypoint.main(rerank_threshold=0.6, **run)
        assert pairs == CORPUS_EXPECTED_PAIRS
        n_marked = len(server.relationships)
        assert n_marked == CORPUS_EXPECTED_PAIRS
        capsys.readouterr()
        pairs2 = entrypoint.main(
            rerank_threshold=1.01, skip_hashing=True, clear_search_cache=True, **run
        )
        assert pairs2 == 0
        assert len(server.relationships) == n_marked  # nothing new marked
    finally:
        server.stop()
    out = " ".join(capsys.readouterr().out.split())
    assert f"Rerank: {CORPUS_EXPECTED_PAIRS} of {CORPUS_EXPECTED_PAIRS} candidate pairs rejected" in out


@pytest.mark.parametrize("weights", [None, "missing.npz"])
def test_missing_weights_exit_before_any_request(tmp_path, weights):
    store, _ = subset_store()
    server = FakeHydrus(store)
    server.start()
    try:
        with pytest.raises(SystemExit) as exc:
            entrypoint.main(
                api_key=DEFAULT_ACCESS_KEY, api_url=server.url, dedup_database_dir=tmp_path / "db",
                rerank="clip", rerank_weights=weights and str(tmp_path / weights), device="cpu",
            )
    finally:
        server.stop()
    assert exc.value.code == 1
    assert server.requests_seen == []
    assert not (tmp_path / "db").exists()  # no database either


def test_the_orchestrator_refuses_bad_choices_and_never_falls_back(tmp_path, monkeypatch):
    weights = str(write_weights(tmp_path / "vit.npz", 7))
    D = dedup.HydrusVideoDeduplicator
    with pytest.raises(ValueError, match="requires --rerank-weights"):
        D(None, None, rerank="clip")
    with pytest.raises(ValueError, match="unknown rerank mode"):
        D(None, None, rerank="siglip", rerank_weights=weights)
    assert D(None, None, rerank="clip", rerank_weights=weights, device="cpu").reranker.threshold == 0.85
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D(None, None, rerank="clip", rerank_weights=weights)
