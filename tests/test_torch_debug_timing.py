"""Stage 4's opt-in timing lines (``HVD_DEBUG_TIMING``) in the port, against
the JAX package's on the same inputs, on the CPU (the port's plain PyTorch
versions, the JAX package's own CPU route).

Only labels and counts are compared, never seconds. The JAX package prints
its ``[chunk-timing]`` line through rich's ``print``, which reads the tag as
markup and drops it; its lines are read here without the tag, the port's
with it.
"""

from __future__ import annotations

import functools
import re

import pytest
import torch

from hydrus_video_deduplicator_tpu import entrypoint as jax_entrypoint
from hydrus_video_deduplicator_tpu.ops import pair_verify as jax_verify
from hydrus_video_deduplicator_tpu_torch import entrypoint, scene_library
from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
from hydrus_video_deduplicator_tpu_torch.utils import profiling

from .test_torch_search_checkpoint import PACKAGES, _main_run, _queue
from .unit_tests.test_pruned_search import _mixed_corpus

ENV = "HVD_DEBUG_TIMING"
TAGS = ("[chunk-timing]", "[prune-timing]", "[seg-timing]", "[verify-timing]")
#: the library: the smoke's mean-71 profile at a few hundred videos, in
#: chunks of CHUNK_ROWS rows, so a run has several checkpoint chunks
N_VIDEOS = 300
CHUNK_ROWS = 64
#: a chunk line, tagged or not (rich may wrap a long line)
CHUNK = re.compile(
    r"rows (\d+)\.\.(\d+):\s+fetch [\d.]+s\s+search [\d.]+s\s+mark [\d.]+s\s+"
    r"\((\d+)\s+hits\)\s+cache-update [\d.]+s"
)
PRUNE = re.compile(r"^\[prune-timing\] (.+): \d+\.\ds$", re.M)
SECONDS = re.compile(r"\d+\.\ds")

MAINS = {
    "jax": functools.partial(jax_entrypoint.main, search_backend="tpu"),
    "port": functools.partial(entrypoint.main, search_backend="gpu", device="cpu"),
}


@pytest.fixture(scope="module")
def library():
    blobs, expected, _ = scene_library.build_corpus(N_VIDEOS, seed=7, median=48.0)
    return blobs, {(a, b) for a, b in expected if a < b}


def _run(package, tmp_path, blobs, capsys, monkeypatch, prefilter="reps"):
    """One package's main() over a fresh database of ``blobs``, in chunks
    of CHUNK_ROWS rows: ((count, marked, posted), stdout, stderr)."""
    db_mod, _, cls, _ = PACKAGES[package]
    monkeypatch.setattr(cls, "SEARCH_CHECKPOINT_ROWS", CHUNK_ROWS)
    db_dir = tmp_path / package
    _queue(db_mod, db_dir, 0, blobs)
    capsys.readouterr()
    result = _main_run(MAINS[package], db_dir, len(blobs), search_prefilter=prefilter)
    out, err = capsys.readouterr()
    return result, out, err


def _chunks(out: str) -> list[tuple[int, int, int]]:
    return [tuple(map(int, m.groups())) for m in CHUNK.finditer(out)]


def test_laps_print_the_tag_and_label_only_when_the_variable_is_set(monkeypatch, capsys):
    """The helper's format, f"{tag} {label}: {seconds:.1f}s" on stdout; its
    silence with the variable unset; the variable read when a printer is
    made, not at import."""
    monkeypatch.delenv(ENV, raising=False)
    silent = profiling.Laps("[prune-timing]")
    monkeypatch.setenv(ENV, "1")
    assert profiling.debug_timing()
    laps = profiling.Laps("[prune-timing]")
    silent("col reps")
    laps("stage-A sweep ({} candidates)", 1546)
    laps("verify ({} hits)", 0)
    out, err = capsys.readouterr()
    assert not silent.on and laps.on and not err
    assert re.fullmatch(
        r"\[prune-timing\] stage-A sweep \(1546 candidates\): \d+\.\ds\n"
        r"\[prune-timing\] verify \(0 hits\): \d+\.\ds\n",
        out,
    )
    monkeypatch.setenv(ENV, "")
    assert not profiling.debug_timing() and not profiling.Laps("[seg-timing]").on


def test_unset_prints_nothing_and_marks_the_same_pairs(library, tmp_path, capsys, monkeypatch):
    """Without the variable the port prints no tagged line on either
    stream; with it, every tag (the seg laps with their drain split) and
    the same marked pairs and count."""
    blobs, planted = library
    monkeypatch.delenv(ENV, raising=False)
    quiet, out, err = _run("port", tmp_path / "unset", blobs, capsys, monkeypatch)
    assert not [t for t in TAGS if t in out + err]
    monkeypatch.setenv(ENV, "1")
    timed, out, err = _run("port", tmp_path / "set", blobs, capsys, monkeypatch)
    assert timed == quiet and quiet[1] == planted
    assert all(t in out for t in TAGS[:3]) and "[verify-timing]" in err
    assert "[seg-timing] drain split: " in out and "[verify-timing]" not in out
    chunks = _chunks(out)
    assert len(chunks) == -(-N_VIDEOS // CHUNK_ROWS)
    assert [(a, b) for a, b, _ in chunks] == [
        (k, min(k + CHUNK_ROWS, N_VIDEOS)) for k in range(0, N_VIDEOS, CHUNK_ROWS)
    ]


@pytest.mark.parametrize("prefilter", ["reps", "none"])
def test_lines_equal_the_jax_orchestrators(library, tmp_path, capsys, monkeypatch, prefilter):
    """Both orchestrators on one library with the variable set: the same
    chunk lines (row spans and hits) and, pruned, the same [prune-timing]
    labels in the same order with the same candidates, off-span blobs and
    hits; unpruned, no prune lap at all."""
    blobs, planted = library
    monkeypatch.setenv(ENV, "1")
    runs = {
        package: _run(package, tmp_path, blobs, capsys, monkeypatch, prefilter)
        for package in MAINS
    }
    assert runs["port"][0] == runs["jax"][0] and runs["port"][0][1] == planted
    chunks = {package: _chunks(out) for package, (_, out, _) in runs.items()}
    assert chunks["port"] == chunks["jax"] and len(chunks["port"]) == -(-N_VIDEOS // CHUNK_ROWS)
    assert sum(h for _, _, h in chunks["port"]) > len(planted)  # self-pairs count too
    assert runs["port"][1].count("[chunk-timing] rows ") == len(chunks["port"])
    laps = {package: PRUNE.findall(out) for package, (_, out, _) in runs.items()}
    assert laps["port"] == laps["jax"]
    if prefilter == "none":
        assert laps["port"] == []
    else:
        per_chunk = laps["port"][:5]
        assert [re.sub(r" \(\d+ [a-z-]+\)", "", lap) for lap in per_chunk] == [
            "col reps", "row reps", "stage-A sweep", "verify-blob fetch", "verify"
        ]
        assert len(laps["port"]) == 5 * len(chunks["port"])


def test_verify_timing_line_equals_the_jax_one(rng, monkeypatch, capsys):
    """verify_pairs of both packages on the same candidates: the same
    [verify-timing] parts and device chunk count, on stderr only."""
    blobs = _mixed_corpus(rng)
    nonempty = [i for i, b in enumerate(blobs) if 0 < len(b) // 32 <= 512]
    pairs = [(i, j) for i in nonempty for j in rng.choice(nonempty, size=4, replace=False)]
    monkeypatch.setenv(ENV, "1")
    capsys.readouterr()
    got = pair_verify.verify_pairs(pairs, blobs, blobs, 1, torch.device("cpu"))
    out_port, err_port = capsys.readouterr()
    want = jax_verify.verify_pairs(pairs, blobs, blobs, 1)
    out_jax, err_jax = capsys.readouterr()
    assert sorted(got) == sorted(want)
    assert out_port == out_jax == ""
    line = SECONDS.sub("_", err_port)
    assert line == SECONDS.sub("_", err_jax)
    assert re.fullmatch(
        r"\[verify-timing\] bucket _ pack _ dispatch _ drain _ over [1-9]\d* device chunks\n", line
    )


def test_seg_laps_count_every_drained_tile(library, monkeypatch, capsys):
    """The unpruned segment route one row block a tile: a dispatch lap for
    each of the first 8 tiles only, then row tiles + drain and the drain
    split over every tile launched, after the staging laps, with every hit
    read from kernel 3's hit lists and no slab overflowed."""
    blobs, planted = library
    drained = []
    monkeypatch.setattr(GpuSearchEngine, "_row_blocks_per_tile", lambda self, n, s: 1)
    real = GpuSearchEngine._drain
    monkeypatch.setattr(
        GpuSearchEngine, "_drain", lambda self, *a: drained.append(1) or real(self, *a)
    )
    monkeypatch.setenv(ENV, "1")
    capsys.readouterr()
    hits = GpuSearchEngine(device="cpu").find_pairs(blobs, blobs, 75)
    out, _ = capsys.readouterr()
    assert {(i, j) for i, j, _ in hits if i < j} == planted
    labels = [m.group(1) for m in re.finditer(r"^\[seg-timing\] (.+?): ", out, re.M)]
    n_tiles = len(drained)
    assert n_tiles > 8
    assert labels == [
        "col stream+fill", "col staging synced (debug)", "row pack",
        *(f"row tile {k} dispatched" for k in range(8)), "row tiles + drain", "drain split",
    ]
    assert re.search(
        rf"^\[seg-timing\] drain split: fetch \d+\.\ds host \d+\.\ds over {n_tiles} row tiles "
        rf"\(0 dense-fallback groups\); {len(hits)} device sims, 0 overflowed slabs$",
        out,
        re.M,
    )
