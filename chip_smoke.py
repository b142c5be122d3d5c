"""Builds the port's CUDA kernel and drives its main path on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

0. build: prints the card's name and power limit, the torch and CUDA
   versions, and the nvcc build of csrc/exists_mask_sweep.cu (time and
   the compiler's register/shared-memory report);
1. kernel against its plain PyTorch version on the card, bit for bit, at
   the main path's shapes: one row tile of 2 row blocks of scene leaders
   against the whole column corpus of leaders of the seed-7 scene library,
   tolerances 79 and 31, all-zero padding frames, an all-zero real frame
   and some invalid steps; both timed with CUDA events;
2. the real size through the orchestrator: the seed-7 mean-71 scene library
   of N videos (artifacts/sweep_scenes.build_corpus, as
   artifacts/library_1m_fresh.py builds it) queued into a fresh database,
   stage 2, maintenance and deduplicate(skip_hashing=True) with the port's
   HydrusVideoDeduplicator against a fake Hydrus server: the marked set
   must equal the planted set, the search cache must be fully marked, a
   re-run must mark 0, and the sweep kernel must have launched;
3. the CLI, ``python -m hydrus_video_deduplicator_tpu_torch`` (run in this
   process, so its kernel launches are counted), on the test corpus with
   native hashing: once with --search-backend gpu --search-prefilter reps,
   once with --search-backend tree in a fresh database; the two marked
   pair sets must be equal and non-empty.

The last lines are the card (nvidia-smi), one JSON object describing each
kernel, and {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result. ``python3 chip_smoke.py N`` sets the library size (default 100000).
"""

from __future__ import annotations

import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_VIDEOS = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
THRESHOLD = 75.0
KERNEL_SOURCE = "hydrus_video_deduplicator_tpu_torch/csrc/exists_mask_sweep.cu"
REPLACES = "hydrus_video_deduplicator_tpu/ops/similarity_segments.py:466"


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase0_build():
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import _build

    log(f"card: {card_line()}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    so = _build.library_path()
    log(f"kernel build (nvcc, sm_90a): {time.perf_counter() - t0:.3f} s -> {os.path.relpath(so, ROOT)}")
    report = so.with_suffix(".log")
    if report.is_file():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    _build.load_library()


def build_library():
    """The seed-7 scene library: (blobs, expected undirected pairs)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "artifacts"))
    # sweep_scenes reads its corpus parameters from argv at import time
    argv, sys.argv = sys.argv, ["sweep_scenes", str(N_VIDEOS), "131072", "pruned"]
    import sweep_scenes as ss

    sys.argv = argv
    blobs, expected, n_empty = ss.build_corpus(np.random.default_rng(7))
    return blobs, {(a, b) for (a, b) in expected if a < b}, n_empty, ss.MIN_SIM


def phase1_kernel_vs_plain(blobs, dev):
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu.ops import reps as reps_mod
    from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import (
        GpuSearchEngine,
        seg_columns_from_pairs,
    )

    t0 = time.perf_counter()
    idx = [i for i, b in enumerate(blobs) if 0 < len(b) <= 32 * seg.SEG_MAX_FRAMES]
    reps = reps_mod.extract_reps([blobs[i] for i in idx])
    rep_items = list(zip(idx, reps))
    cols = GpuSearchEngine(device=dev)._stage_columns(seg_columns_from_pairs(rep_items))
    rows = seg.pack_blocks(rep_items[:1000], seg.ROW_FRAMES, seg.ROW_SLOTS)[:2]
    packed, slot_a, _, _ = seg.stack_blocks(rows, 2, seg.ROW_FRAMES, seg.ROW_SLOTS)
    a_words = ops_sim.to_words(packed, dev)
    a_words[5] = 0  # a real row frame with every bit clear
    slot_a = torch.from_numpy(slot_a).to(dev)
    b_words = cols["words"].clone()
    b_words[7] = 0  # a real column frame with every bit clear
    n_steps = cols["n_steps"]
    valid = torch.ones(n_steps, dtype=torch.int32, device=dev)
    valid[::7] = 0
    n_pad = int((cols["slots"] < 0).sum())
    log(
        f"phase 1 inputs: {n_steps} column steps ({b_words.shape[0]} frames, {n_pad} "
        f"padding), 2 row blocks, {int((valid == 0).sum())} invalid steps; "
        f"{time.perf_counter() - t0:.1f} s to build"
    )
    assert n_steps >= 64 and n_pad > 0
    args = (a_words, slot_a, b_words, cols["slots"], valid)
    result = {}
    for tol in (79, 31):
        got = seg.exists_mask_sweep(*args, tol)
        want = seg.exists_mask_sweep_plain(*args, tol)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        n_bits = int(np.unpackbits(want.cpu().numpy().view(np.uint8)).sum())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at tol {tol}: max abs word error {err}")
        ms = cuda_time_ms(lambda: seg.exists_mask_sweep(*args, tol), 20)
        plain_ms = cuda_time_ms(lambda: seg.exists_mask_sweep_plain(*args, tol), 3)
        log(
            f"phase 1 tol {tol}: bit-equal ({n_bits} bits set); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call"
        )
        result[tol] = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}
    return result


class StageTimers:
    """Wall time of the engine's stages during phase 2, by wrapping them."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.events = []
        self._restore = []

    def wrap(self, owner, name: str, label: str):
        import torch

        real = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0

        setattr(owner, name, timed)
        self._restore.append((owner, name, real))

    def wrap_kernel(self, module):
        import torch

        real = module.exists_mask_sweep

        def launched(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args)
            end.record()
            self.events.append((start, end))
            return out

        module.exists_mask_sweep = launched
        self._restore.append((module, "exists_mask_sweep", real))

    def restore(self):
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)

    def kernel_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase2_orchestrator(blobs, expected, n_empty, min_sim):
    import numpy as np

    import hydrus_video_deduplicator_tpu.db.DedupeDB as DedupeDB
    from hydrus_video_deduplicator_tpu.client import HVDClient
    from hydrus_video_deduplicator_tpu.db import vptree
    from hydrus_video_deduplicator_tpu.ops import reps as reps_mod
    from hydrus_video_deduplicator_tpu_torch import dedup
    from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)
    assert max(1, 101 - search_threshold) == min_sim

    def file_hash(i: int) -> str:
        return f"{i:016x}" + "00" * 24

    os.environ.setdefault("HVD_SQLITE_CACHE_MB", "1024")
    server = FakeHydrus({})
    server.start()
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_") as workdir:
        try:
            DedupeDB.set_db_dir(workdir)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            t0 = time.perf_counter()
            for i0 in range(0, N_VIDEOS, 50_000):
                db.conn.executemany(
                    "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
                    [(file_hash(i), blobs[i]) for i in range(i0, min(i0 + 50_000, N_VIDEOS))],
                )
            db.commit()
            t_queue = time.perf_counter() - t0

            deduper = dedup.HydrusVideoDeduplicator(db, client=client, search_backend="gpu")
            deduper.threshold = THRESHOLD
            t0 = time.perf_counter()
            db.begin_transaction()
            with db.conn:
                deduper.process_phashed_file_queue()
            t_stage2 = time.perf_counter() - t0
            t0 = time.perf_counter()
            db.begin_transaction()
            with db.conn:
                deduper.run_maintenance()
            t_maint = time.perf_counter() - t0
            n_files = db.execute("SELECT count(*) FROM files").fetchone()[0]
            assert n_files == N_VIDEOS, n_files

            timers = StageTimers()
            timers.wrap(reps_mod, "extract_reps", "host clustering (reps)")
            timers.wrap(GpuSearchEngine, "_stage_columns", "column staging")
            timers.wrap(GpuSearchEngine, "_segment_route", "stage A (sweep + drain)")
            timers.wrap(pair_verify, "verify_pairs", "stage B (verify)")
            timers.wrap_kernel(seg)
            seg.LAUNCHES["exists_mask_sweep"] = 0
            t0 = time.perf_counter()
            try:
                pairs = deduper.deduplicate(skip_hashing=True)
            finally:
                timers.restore()
            t_search = time.perf_counter() - t0
            launches = seg.LAUNCHES["exists_mask_sweep"]

            idx = {file_hash(i): i for i in range(N_VIDEOS)}
            got = {tuple(sorted((idx[a], idx[b]))) for a, b in server.relationships}
            unsearched = db.execute(
                "SELECT count(*) FROM shape_search_cache WHERE searched_distance IS NULL"
                " OR searched_distance < ?",
                (search_threshold,),
            ).fetchone()[0]
            log(
                f"phase 2: N={N_VIDEOS} ({n_empty} empty hashes): marked {len(got)} pairs "
                f"(planted {len(expected)}), missing {len(expected - got)}, extras "
                f"{len(got - expected)}, unsearched left {unsearched}, reported {pairs}; "
                f"sweep kernel launches {launches}"
            )
            if got != expected or pairs != len(expected):
                raise AssertionError("phase 2: the marked pairs differ from the planted set")
            if unsearched:
                raise AssertionError(f"phase 2: {unsearched} files left unsearched")
            if launches == 0:
                raise AssertionError("phase 2: the sweep kernel never launched")
            t0 = time.perf_counter()
            pairs2 = deduper.deduplicate(skip_hashing=True)
            t_rerun = time.perf_counter() - t0
            if pairs2 != 0:
                raise AssertionError(f"re-run marked {pairs2} pairs")
            log(
                f"phase 2 stage times (s): queue fill {t_queue:.3f}, stage 2 {t_stage2:.3f}, "
                f"maintenance {t_maint:.3f}, stage 4 search+mark {t_search:.3f}, "
                f"re-run {t_rerun:.3f}"
            )
            for label, sec in timers.seconds.items():
                log(f"phase 2   {label}: {sec:.3f} s")
            log(f"phase 2   sweep kernel device time: {timers.kernel_ms():.3f} ms "
                f"over {len(timers.events)} launches")
            db.close()
        finally:
            server.stop()
    return launches


def phase3_cli():
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus, corpus_file_store

    def run(backend_args, db_dir):
        server = FakeHydrus(corpus_file_store())
        server.start()
        argv = sys.argv
        sys.argv = [
            "hydrus_video_deduplicator_tpu_torch", "--api-key", DEFAULT_ACCESS_KEY,
            "--api-url", server.url, "--dedup-database-dir", db_dir, *backend_args,
        ]
        try:
            runpy.run_module("hydrus_video_deduplicator_tpu_torch", run_name="__main__")
        except SystemExit as exc:  # click's normal exit; a failure re-raises
            if exc.code not in (0, None):
                raise RuntimeError(f"the CLI exited with {exc.code}") from exc
        finally:
            sys.argv = argv
            server.stop()
        return set(server.relationships)

    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_cli_") as tmp:
        seg.LAUNCHES["exists_mask_sweep"] = 0
        t0 = time.perf_counter()
        gpu = run(["--search-backend", "gpu", "--search-prefilter", "reps"], os.path.join(tmp, "gpu"))
        t_gpu = time.perf_counter() - t0
        launches = seg.LAUNCHES["exists_mask_sweep"]
        t0 = time.perf_counter()
        tree = run(["--search-backend", "tree"], os.path.join(tmp, "tree"))
        t_tree = time.perf_counter() - t0
    log(
        f"phase 3: CLI gpu marked {len(gpu)} pairs in {t_gpu:.1f} s (kernel launches "
        f"{launches}); CLI tree marked {len(tree)} pairs in {t_tree:.1f} s"
    )
    if gpu != tree or not gpu or launches == 0:
        raise AssertionError("phase 3: gpu and tree pair sets differ, or are empty")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    phase0_build()
    blobs, expected, n_empty, min_sim = build_library()
    timing = phase1_kernel_vs_plain(blobs, dev)
    launches = phase2_orchestrator(blobs, expected, n_empty, min_sim)
    del blobs
    phase3_cli()
    if "jax" in sys.modules:
        raise AssertionError("the port's main path imported jax")

    print(card_line())
    print(json.dumps({
        "kernels": [{
            "name": "exists_mask_sweep",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": max(t["max_abs_err"] for t in timing.values()),
            "ms": timing[79]["ms"],
            "plain_ms": timing[79]["plain_ms"],
        }]
    }))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
