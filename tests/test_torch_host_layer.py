"""The port's own host layer against the JAX package's originals it was
copied from: ``matchHashBytes``, the scene representatives, the perceptual
hash of a video, the SQLite database in both directions, and the scene
library generator; and the port's native build, which must hold when
several processes start it at once on an empty build directory."""

from __future__ import annotations

import hashlib
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu import hashing as jax_hashing
from hydrus_video_deduplicator_tpu import vpdq as jax_vpdq
from hydrus_video_deduplicator_tpu.db import DedupeDB as jax_db
from hydrus_video_deduplicator_tpu.native import decode as jax_decode
from hydrus_video_deduplicator_tpu.ops import reps as jax_reps
from hydrus_video_deduplicator_tpu_torch import hashing, native, scene_library, vpdq
from hydrus_video_deduplicator_tpu_torch.db import DedupeDB
from hydrus_video_deduplicator_tpu_torch.native import decode as port_decode
from hydrus_video_deduplicator_tpu_torch.ops import reps

from .unit_tests.test_pruned_search import _mixed_corpus

REPO = Path(__file__).resolve().parents[1]
VIDEO = REPO / "tests" / "corpus" / "videos" / "scene_a" / "S01_h264.mp4"


@pytest.fixture(scope="module")
def blobs():
    return _mixed_corpus(np.random.default_rng(2024), long_video=True)


def test_match_hash_bytes_equals_the_original(blobs):
    assert native.is_available()  # the port's own build, never the oracle
    for a in blobs[::3]:
        for b in blobs:
            assert vpdq.matchHashBytes(a, b) == jax_vpdq.matchHashBytes(a, b)


@pytest.mark.parametrize("radius_cap", [8, 24])
def test_extract_reps_equals_the_original(blobs, radius_cap):
    nonempty = [b for b in blobs if b]
    got = reps.extract_reps(nonempty, radius_cap)
    assert got == jax_reps.extract_reps(nonempty, radius_cap)
    assert sum(map(len, got)) < sum(map(len, nonempty))
    assert reps.prune_tolerance(radius_cap) == jax_reps.prune_tolerance(radius_cap)


def _jax_phash(video: Path) -> bytes:
    """The JAX package's compute_phash of ``video``, through its native
    decoder. Several test processes may run that package's ``make`` at
    once, and a process that loads a library another is still writing
    marks the decoder unavailable and decodes through OpenCV instead; then
    a fresh interpreter computes the hash, after the builds have finished.
    It must find the native decoder wherever the port's own loads."""
    if jax_decode.is_available():
        return jax_hashing.compute_phash(video.read_bytes()).bytes
    code = (
        "import sys; from hydrus_video_deduplicator_tpu import hashing; "
        "from hydrus_video_deduplicator_tpu.native import decode; "
        "phash = hashing.compute_phash(open(sys.argv[1], 'rb').read()).bytes; "
        "print(decode.is_available(), phash.hex())"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(video)], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    )
    native, phash = proc.stdout.split()
    assert native == "True" or not port_decode.is_available(), proc.stderr
    return bytes.fromhex(phash)


def test_compute_phash_of_a_corpus_video_is_byte_equal(monkeypatch):
    got = hashing.compute_phash(VIDEO.read_bytes()).bytes
    assert len(got) > 0 and len(got) % 32 == 0
    assert got == _jax_phash(VIDEO)
    # the same comparison when this process's JAX decoder failed to load
    monkeypatch.setattr(jax_decode, "is_available", lambda: False)
    assert got == _jax_phash(VIDEO)


def _write_db(module, db_dir: Path, items: list[tuple[str, bytes]]) -> None:
    """A fresh database with ``items`` queued, bound (the set-based drain,
    as the gpu backend runs it) and one file's search cache marked."""
    module.set_db_dir(db_dir)
    module.create_db()
    db = module.DedupeDb(module.get_db_dir(), module.get_db_name())
    db.init_connection()
    for file_hash, phash in items:
        db.add_to_phashed_files_queue(file_hash, phash)
    assert db.drain_phashed_queue_batch(len(items)) == len(items)
    db.execute(
        "UPDATE shape_search_cache SET searched_distance = 26 WHERE hash_id = ?",
        (db.get_hash_id(items[0][0]),),
    )
    db.commit()
    db.close()


def _read_db(module, db_dir: Path) -> dict:
    db = module.DedupeDb(db_dir, module.get_db_name())
    db.init_connection()
    try:
        assert not db.does_need_upgrade()
        out = {}
        for file_hash in db.get_phashed_files():
            hash_id = db.get_hash_id(file_hash)
            out[file_hash] = db.get_phash(db.get_phash_id_from_hash_id(hash_id))
        searched = db.execute(
            "SELECT count(*) FROM shape_search_cache WHERE searched_distance = 26"
        ).fetchone()[0]
        return {"phashes": out, "searched": searched, "version": db.get_version()}
    finally:
        db.close()


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_a_database_written_by_one_package_reads_back_in_the_other(
    blobs, tmp_path, writer, reader
):
    modules = {"jax": jax_db, "port": DedupeDB}
    items = [(f"{i:064x}", b) for i, b in enumerate(blobs)]
    _write_db(modules[writer], tmp_path, items)
    got = _read_db(modules[reader], tmp_path)
    assert got == _read_db(modules[writer], tmp_path)
    assert got["phashes"] == dict(items) and got["searched"] == 1


def test_scene_library_equals_sweep_scenes(monkeypatch):
    """At seed 7 with the 512-frame clip the port's generator gives the
    blobs, plants and empties of artifacts/sweep_scenes.build_corpus."""
    n = 2_000
    monkeypatch.syspath_prepend(str(REPO / "artifacts"))
    monkeypatch.setattr(sys, "argv", ["sweep_scenes", str(n)])  # read at import
    monkeypatch.delitem(sys.modules, "sweep_scenes", raising=False)
    import sweep_scenes

    want = sweep_scenes.build_corpus(np.random.default_rng(7))
    monkeypatch.delitem(sys.modules, "sweep_scenes")
    got = scene_library.build_corpus(n, seed=7, clip=512)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert len(got[1]) > 100


def test_scene_library_long_plants():
    """The 1024-frame clip keeps the upper tail; long plants add pairs with
    a 513-1024-frame side, drawn after every other plant."""
    blobs, expected, _ = scene_library.build_corpus(3_000, seed=7, clip=1024, long_plants=(4, 2, 2))
    short, _, _ = scene_library.build_corpus(3_000, seed=7, clip=1024)
    lens = np.asarray([len(b) // 32 for b in blobs])
    assert lens.max() > 512 and lens.max() <= 1024
    long_pairs = {(a, b) for a, b in expected if a < b and max(lens[a], lens[b]) > 512}
    assert len(long_pairs) >= 6
    changed = [i for i, (x, y) in enumerate(zip(blobs, short)) if x != y]
    assert len(changed) == 8  # the plants' targets, and nothing else


#: sha256 of build_corpus(2_000, seed=7) (blobs, then the expected pairs,
#: then the empty count) as it was before it took a median
SCENE_LIBRARY_2000_DIGEST = "8954b95c4d57eb94e232278847390af383265346e4ccb057552c0cbff1afa7bd"


def _library_digest(library) -> str:
    blobs, expected, n_empty = library
    h = hashlib.sha256()
    for b in blobs:
        h.update(len(b).to_bytes(4, "little"))
        h.update(b)
    for key in sorted(expected):
        h.update(repr((key, expected[key])).encode())
    h.update(str(n_empty).encode())
    return h.hexdigest()


def _sweep_scenes(monkeypatch, n: int, median: str):
    """artifacts/sweep_scenes.py imported with N = n and HVD_SWEEP_MEDIAN =
    median (both read at import)."""
    monkeypatch.setattr(sys, "argv", ["sweep_scenes", str(n)])
    monkeypatch.setenv("HVD_SWEEP_MEDIAN", median)
    spec = importlib.util.spec_from_file_location(
        f"sweep_scenes_median_{median}", REPO / "artifacts" / "sweep_scenes.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: build_corpus's median -> the range of its mean frame count
MEDIAN_MEANS = {48.0: (60, 80), 84.0: (100, 140), 160.0: (180, 230)}


@pytest.mark.parametrize("median", sorted(MEDIAN_MEANS))
def test_scene_library_median(monkeypatch, median):
    """At the median 48 (the default) build_corpus gives what it gave
    before it took a median, byte for byte; at 84 (the mean-120 profile)
    and 160 (the mean-200 one) its frame counts, blobs and plants are
    those of artifacts/sweep_scenes.py under HVD_SWEEP_MEDIAN=84 or 160."""
    n = 2_000
    got = scene_library.build_corpus(n, seed=7, median=median)
    _, offsets = scene_library.gen_corpus(np.random.default_rng(7), n, median=median)
    low, high = MEDIAN_MEANS[median]
    assert low < np.diff(offsets).mean() < high
    if median == 48.0:
        assert _library_digest(got) == SCENE_LIBRARY_2000_DIGEST
        return
    sweep = _sweep_scenes(monkeypatch, n, f"{median:g}")
    _, sweep_offsets = sweep.gen_corpus(np.random.default_rng(7))
    assert np.array_equal(offsets, sweep_offsets)
    assert got == sweep.build_corpus(np.random.default_rng(7))


def test_build_delta_plants_exactly_its_expected_pairs():
    """Every pair of a new video with a library or new video that scores
    >= MIN_SIM (matchHashBytes over all of them) is one of build_delta's
    plants, with its similarity; re-encodes fall across the library, on
    videos no library plant or empty hash touches."""
    blobs, expected, _ = scene_library.build_corpus(400, seed=7)
    new, delta = scene_library.build_delta(blobs, 80, n_cross=8, n_pairs=6)
    n, corpus = len(blobs), blobs + new
    found = {}
    for i in range(n, len(corpus)):
        for j in range(len(corpus)):
            s = int(vpdq.matchHashBytes(corpus[i], corpus[j]))
            if i != j and s >= scene_library.MIN_SIM:
                found[(i, j)] = s
    assert found == {(a, b): s for (a, b), s in delta.items() if a >= n}
    sources = sorted(a for a, b in delta if a < n)
    assert len(sources) == 8 and len({b for a, b in delta if a >= n and b >= n}) == 12
    assert sources[0] < n // 4 and sources[-1] > 3 * n // 4
    assert not set(sources) & {i for pair in expected for i in pair}
    assert all(blobs[i] for i in sources)
    again = scene_library.build_delta(blobs, 80, n_cross=8, n_pairs=6)
    assert again == (new, delta)


def test_native_library_builds_once_for_six_processes(tmp_path):
    """Six processes load a copy of the port's native package from an empty
    build directory at once: each loads the library, which was built once,
    to a temporary name moved into place."""
    pkg = tmp_path / "native_copy"
    shutil.copytree(
        Path(native.__file__).parent, pkg, ignore=shutil.ignore_patterns("build", "__pycache__")
    )
    assert not (pkg / "build").exists()
    code = (
        "import native_copy as n; lib = n.get_lib(); "
        "print(lib is not None and n.match_hash_bytes(bytes(32), bytes(32)) == 100.0)"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [o.strip() for o, _ in outs] == ["True"] * 6, [e for _, e in outs]
    built = sorted(p.name for p in (pkg / "build").iterdir())
    assert built == [".lock", "libhvdaccel.so"]


#: the port's verbatim copies of JAX package files, and each difference:
#: (a regular expression matching the original's text once, the copy's text)
COPIES = {
    "models/convert_clip.py": [
        (r"python -m hydrus_video_deduplicator_tpu\.models", "python -m hydrus_video_deduplicator_tpu_torch.models"),
    ],
    "gui/__init__.py": [],
    "native/tsan_stress.cpp": [],
    "typing_utils.py": [],
    "gui/gui.py": [
        (r"reference \(/\S+/reference/src/\n", "reference (upstream\nsrc/"),
        (r"Deduplicator TPU \{", "Deduplicator (PyTorch/CUDA port) {"),
        (r'\["auto", "tree", "tpu"\]', '["auto", "tree", "gpu"]'),
        (r'\["auto", "native", "tpu"\]', '["auto", "native", "gpu"]'),
        (r"prune for the TPU engine", "prune for the GPU engine"),
        (
            r"auto: TPU exact all-pairs engine when a device is available",
            "auto: GPU exact all-pairs engine when CUDA is available",
        ),
        (r'"tpu: force the device engine\."', '"gpu: force the device engine."'),
        (r'"tpu: device-batched hashing', '"gpu: device-batched hashing'),
    ],
    **{
        name: [
            (r"from hydrus_video_deduplicator_tpu import", "from hydrus_video_deduplicator_tpu_torch import"),
            (r"from hydrus_video_deduplicator_tpu\.entrypoint", "from hydrus_video_deduplicator_tpu_torch.entrypoint"),
        ]
        for name in ("winexe_entrypoint.py", "winexe_gui_entrypoint.py")
    },
}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copied_file_differs_from_its_original_only_as_listed(name):
    """The GUI, the Windows entry points, the CLIP converter, the typing
    helpers and the native hasher's ThreadSanitizer stress are copies: the
    original with each listed difference applied, once, is the copy."""
    text = (REPO / "hydrus_video_deduplicator_tpu" / name).read_text()
    for pattern, new in COPIES[name]:
        text, n = re.subn(pattern, lambda _m, new=new: new, text)
        assert n == 1, (name, pattern)
    assert (REPO / "hydrus_video_deduplicator_tpu_torch" / name).read_text() == text
