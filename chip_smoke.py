"""Builds the port's CUDA kernels and drives its main paths on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

0. build: prints the card's name and power limit, the torch and CUDA
   versions, and the nvcc builds of csrc/exists_mask_sweep.cu,
   csrc/pair_verify.cu, csrc/pdq_filter.cu, csrc/similarity_segments.cu
   and csrc/similarity_block.cu, started together (time and the compiler's
   register/shared-memory report of each); it reads the SASS of the four
   Hamming libraries (all but the PDQ filter) with cuobjdump and fails
   unless each holds tensor-core MMA instructions (their frame pairs run
   on binary mma.sync: BMMA), printing the counts;
1. sweep kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's shapes: one row tile of 2 row blocks of scene
   leaders against the whole column corpus of leaders of the seed-7 scene
   library, tolerances 79 and 31, all-zero padding frames, an all-zero real
   frame and some invalid steps; both timed with CUDA events; then the
   work counts (slot pairs, pairs in live fragments, real pairs) and the
   torch._int_mm yardstick over the same real leaders, as phase 6;
2. stage 4 at real size through the orchestrator: the seed-7 mean-71 scene
   library of N videos (the port's scene_library.build_corpus, the model
   of artifacts/sweep_scenes.py, frames clipped at 512) queued into a
   fresh database, stage 2, maintenance and deduplicate(skip_hashing=True)
   with the port's HydrusVideoDeduplicator against a fake Hydrus server:
   the marked set must equal the planted set, the search cache must be
   fully marked, a re-run must mark 0, and the sweep kernel and stage B's
   kernel (csrc/pair_verify.cu) must have launched, and no other kernel
   (so in every pruned phase below);
2b. the delta, on phase 2's database right after its re-run (the
   database phases 11 and 12 copy was saved before phase 2's search, so
   they do not see it): N_DELTA = 10,000 new videos of
   scene_library.build_delta (500 re-encodes of searched videos spread
   across the library, 100 pairs among the new videos, the rest
   background) listed by the fake server and queued, then
   deduplicate(skip_hashing=True) with search_prefilter="auto": stage 2
   must drain only the new rows, the server's relationships must be
   phase 2's plants and the delta's with no pair of two searched videos
   POSTed, the returned count must be the reference's rule, (500 + 2 x
   100) // 2 = 350, the search cache must be fully marked, a re-run must
   mark 0, and the sweep and stage B's kernel must have launched and no
   other kernel; its stage-2 and stage-4 seconds print beside phase 2's;
2c. the mean-200 profile: N_MEAN200 = 10,000 videos of the seed-7 scene
   library at the median 160 (about 2.07M frames; the JAX package's
   artifacts/library_1m_fresh_mean200_r05.log at a hundredth of its size)
   through stage 2 and stage 4 as phase 2, with search_prefilter="auto":
   exact, a re-run marking 0, the sweep and stage B's kernel launched and
   no other kernel; its stage-2 and stage-4 seconds print beside phase 2's;
2d. stage 4's timing lines: stage 4 once more from the database phase 2
   saved after stage 2, with HVD_DEBUG_TIMING=1 for this run only (phase
   2 runs without it) and stdout and stderr teed: held as phase 2, with as
   many sweep launches as phase 2; one [chunk-timing] line per checkpoint
   chunk, spanning the rows in order, whose hits add up to what the
   chunks' searches handed the marking; [prune-timing], [seg-timing] with
   its drain split, and [verify-timing] on stderr; the chunks' parts at
   most the stage-4 seconds. It prints one line splitting those seconds
   (the chunks' fetch, search with its prune laps and the complements,
   mark and cache-update, and what lies outside the chunks) with the card,
   and one with stage A's segment laps and stage B's verify split;
2e. stage B's kernel alone (csrc/pair_verify.cu) on the device pairs of
   one find_pairs_pruned call of the scene1m-pruned cell's shape: row
   chunk 4 (131,072 rows) of the seed-7 mean-71 library of 1,000,000
   videos against all of it; the kernel's similarities must equal its
   plain version's on the card (the float16 bmm chain, _verify_plain)
   exactly; it prints the call's pairs and frame pairs, the kernel's
   CUDA-event ms beside its bound, the upload's ms and the host parts;
3. the CLI, ``python -m hydrus_video_deduplicator_tpu_torch`` (run in this
   process, so its kernel launches are counted), on the test corpus: with
   --hash-backend native --search-backend gpu --search-prefilter reps,
   with --search-backend tree in a fresh database, and with --hash-backend
   gpu --search-backend gpu --search-prefilter reps in a third; the three
   marked pair sets must be equal and non-empty, and each gpu run must
   have launched its kernels; then the JAX package's recorded Hydrus
   session (tests/fixtures/cassette_main.json.zip) replayed through the
   port's entrypoint.main() with hash_backend="gpu": every request as
   recorded, in order, every recorded request made, the recorded pair
   count, and the PDQ kernel launched (its four files take the VP-tree, as
   in the recording);
4. PDQ filter kernel against its plain PyTorch version on the card: one
   batch of 512 planar frames (noise, smooth gradients, constant, all-0,
   all-255 and frames decoded from tests/corpus/videos, from a numpy
   seed) bit for bit, the fused hash (kernel + PyTorch tail) against the
   numpy oracle on 64 of them, both filters timed with CUDA events, and
   the kernel's bytes per second beside the bound (the bytes the function
   needs: the 447 frame rows a frame that its bands read, the reciprocals
   and the output);
5. stage 1 at real size through the orchestrator: 10,000 MJPG videos (5,000
   scenes x 2 versions, the second with +-6 noise; 16 s at 1 fps, so
   160,000 hashed frames; the corpus shape of artifacts/bench_e2e.py)
   served by the fake Hydrus server, deduplicate(skip_hashing=False) with
   hash_backend="gpu", search_backend="gpu" and the user's default
   search_prefilter="auto", which declines the prune on 16-frame videos,
   so stage 4 takes the unpruned segment route: no file may fail, 1,000
   sampled queued hashes must equal hashing.compute_phash of the same
   bytes, the marked set must equal the 5,000 planted pairs (or, if the
   scenes match each other, a native-hash run's marked set), a re-run
   must fetch no file and mark 0, and both the PDQ kernel and the segment
   similarity kernel must have launched. It also prints one decode
   thread's per-frame split on this host (the backend's decode, the
   512x512 rescale, the planar transpose) over 50 of the videos;
6. segment similarity kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes: one tile of 2 row blocks
   of the seed-7 library's full frames (the first and the last videos in
   staging order, so the first and the last steps hold a dense
   self-diagonal) against the full-frame columns of every
   segment-eligible video, staged as phase 7's find_pairs stages them,
   with invalid steps, an all-zero real frame at each side, padding frames
   and empty slots; the similarities, the masks at min_sim 75 and 1, and
   the counts (kernel 6) at tolerance 31 and 79; and kernel 2's
   counterpart, the sweep with every step valid; each timed with CUDA
   events beside its plain version; then the work counts (slot pairs,
   pairs in the fragments the tensor-core kernel computes, real pairs) and a
   yardstick, torch._int_mm over the same real frames as ±1 rows, for the
   mask at 75 and for the every-step sweep;
7. the unpruned search at real size through the orchestrator: the phase-2
   library, a fresh database, stage 2, maintenance and
   deduplicate(skip_hashing=True) with search_prefilter="none": the marked
   set must equal the planted set, the search cache must be fully marked,
   a re-run must mark 0, the segment similarity kernel must have launched
   and no other kernel;
7b. the JAX package's exact all-pairs sweep (artifacts/sweep_1m.py) at a
   tenth of its size, through find_pairs: sweep_rehearsal at SWEEP_SMOKE,
   100,000 8-frame videos in triangle chunks of 13,107 rows and 24,000
   videos of 1-64 frames with 100 empty hashes in chunks of 3,000,
   kernel 3 in its mask mode: each chunk's hits equal to the planted truth's, every
   non-empty video matching itself at 100, every planted direction at its
   similarity, nothing else, and only the segment similarity kernel
   launched;
8. bucketed similarity kernel (kernel 5) against its plain PyTorch version
   on the card, bit for bit, at the long-video route's shapes: the
   513-1024-frame videos of the phase-9 library's first checkpoint chunk
   (one launch's row tile) against the whole of buckets 1, 64, 512 and
   1024 (one launch's columns), and the swapped direction, that chunk's 33-64-frame videos
   against bucket 1024; with empty videos, counts of 1, pad - 1 and pad
   (frames past a video's real count then hold zero words: real all-zero
   frames beside the all-zero padding), an all-zero real frame on each side
   and self-pairs scoring 100; each timed with CUDA events beside its plain
   version and the torch._int_mm yardstick over the same real frames;
9. the long tail through the orchestrator: the seed-7 library with its
   frames clipped at 1024 instead of 512 (the same draws: the seed-7
   frame-count profile with its upper tail kept) and long plants, pairs
   with a 513-1024-frame side (re-encodes, adjacent and far, and
   half-clips whose halves fall at or below 512): N videos with the
   user's default search_prefilter="auto", which keeps the prune, so the
   long videos take the complements, then N_NONE = 20,000 videos with
   search_prefilter="none". Each run as phase 2: the marked set must equal
   the planted set, the search cache must be fully marked, a re-run must
   mark 0; the bucketed similarity kernel must have launched beside the
   sweep ("auto") or the segment similarity kernel ("none"), and no
   torch.matmul may run inside the bucketed route;
10. the embedding rerank (--rerank clip), whose tower has no hand-written
   kernel (its matmuls, softmax and layer norms are torch ops in float32):
   (a) the port's tower on the card against the same tower on the CPU at
   CLIP ViT-B/32's shape (width 768, 12 layers, 12 heads, patch 32, image
   224, projection 512, quick_gelu, pre_ln), random weights from a seed, on
   one video of 32 frames: the unit-norm embeddings and the cosines of 16
   frame pairs within 1e-4; the card's ms a video (the port's
   device_timer, CUDA events), frames/s and float32 FLOP/s of its matmuls,
   counted from the shapes; (b) deduplicate() with rerank="clip",
   hash_backend="gpu" and search_backend="gpu" on 200 scenes of the
   phase-5 generator (400 MJPG videos, 200 planted pairs), pixel-identity
   weights at ViT-B/32's shape, inside the port's trace_to: at threshold
   0.6 the marked set must equal the planted set, then on the same
   database with its search cache cleared the same gate at 1.01 must mark
   nothing and reject every pair it checks; the tower's parameters must be
   on the card and the PDQ and segment similarity kernels must have
   launched (their counts set to 0 just before). It prints the share of
   the traced window in which a CUDA kernel ran (the union of the kernel
   intervals; 1 minus the device's idle share);
11. the multi-device path (``parallel/mesh.py``): a mesh over every
   visible card, or, with one card, MESH_MEMBERS_ON_ONE_CARD members
   sharing it, each on a stream of its own (then the phase measures the
   sharding's cost, not a speed-up); ``parallel.dryrun.dryrun_multidevice``
   on it (stages 1-7, each against the port on one device); phase 2's
   library through stage 4 with the orchestrator's _device_mesh returning
   the mesh and search_prefilter="auto" (as phase 2: the planted set, the
   cache fully marked, a re-run marking 0, and the sweep launched on every
   member); the long-tail library of phase 9's "none" run on the mesh
   (kernel 3 and kernel 5 on every member), both stage-4 runs starting
   from a copy of their phase's database after stage 2, so stage 2 is
   not run again; stage 1 of phase 10's 400 MJPG
   videos on the mesh as phase 5 runs it (no file failing, 100 sampled
   queued hashes equal to compute_phash, the planted set, the PDQ kernel
   on every member). It prints each member's launches and device ms
   (CUDA events on the member's stream) of kernels 1, 3, 4 and 5, and
   fails if a member of a run launched no kernel of its route, and the
   stage-4 seconds beside phases 2 and 9 with the card;
12. the installed port: the package sources, setup.py, pyproject.toml and
   README.md copied to a temporary directory, a wheel built there (``pip
   wheel --no-deps --no-build-isolation``, no network) and installed with
   ``pip install --no-deps --no-index --target``, each step timed; a fresh
   interpreter on the installed copy, run outside the repository, must
   import the port from there, name every kernel library as the checkout
   does (the same sources) and load the port's native library from the
   wheel; then the console script, ``<target>/bin/hydrus-video-deduplicator-tpu-torch
   --search-backend gpu --threshold 75``, twice against a fake Hydrus
   server that lists phase 2's 100,000 files, on a copy of the database
   phase 2 saved after stage 2 (search_prefilter "auto", pruned): stage 1
   must fetch no file, the marked set must equal the planted set, the
   search cache must be fully marked, the second run must mark 0, and the
   sweep library must have been built during the run, under the
   checkout's name, inside the installed copy, and launched there, with
   stage B's kernel and no other search kernel (each
   run's launch counts come from the run's own interpreter at its exit,
   through a sitecustomize in a directory of its own on PYTHONPATH). It
   prints the runs' stage-4 and whole-run seconds beside phase 2's;
13. the port's benchmark as users run it: ``python3 bench_torch.py`` in
   its own process (the kernels are built by then), whose last line must
   hold every key of BENCH_KEYS, the card's name as torch names it,
   positive rates and projections, and a launch of each of its three
   kernels (the PDQ filter, the segment similarity kernel and the sweep);
   it prints the benchmark's stderr, its filter ms beside phase 4's, its
   sweep rate beside phase 1's, and each search measurement's bound. It
   adds nothing to the last lines.

The last lines are the card (nvidia-smi), one JSON object describing each
kernel, and {"ok": true, "device": {...}}. A kernel's "launches" is its
count over the run of the path it serves: phases 2, 2b and 2c for the sweep and
for stage B's kernel (timed in phase 2e), phase 5
for the PDQ filter, phases 7 and 7b for the similarity kernel and, read from
phase 7's counters, for the counts mode (kernel 6) and the every-step sweep
(kernel 2): these serve no path of the program, so theirs is 0; phase 6
holds both against their plain versions; phase 9's "auto" run for the
bucketed similarity kernel. "bound_ms" is the least time the card could
take for the timed call: the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
peak for their type: the PDQ filter's float32 adds and multiplies against
67 TFLOP/s; a real frame pair of the Hamming kernels (1, 2, 3, 5, 6) as
one 256-deep binary product, 512 operations, against the binary tensor
cores' rate, which the data sheet does not give, so the highest that
mma_rates.py measured on the card (B1_OPS_PER_S; about 5.1x the int8
rate of 1,979 TOP/s). Phases 1, 6 and 8 also print each such bound at
the int8 rate, the definition before the kernels ran binary products.
No single PyTorch call computes any of these functions, so "library_ms"
is null: the torch._int_mm yardstick of phases 6 and 8 computes only the
inner product. At the end the script fails if jax or any module of the
JAX package was imported.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result. ``python3 chip_smoke.py N`` sets the
library size of phases 2, 7, 8 and the "auto" run of phase 9 (default
100000). Phase 2 alone at another size:

    python3 -c "import sys, chip_smoke as c; \
sys.exit(c.stage4_orchestrator(2, *c.build_library(1_000_000), {'exists_mask_sweep'}) is None)"

The JAX package's fresh-library rehearsal (artifacts/library_1m_fresh.py),
stage 2 and stage 4 of a never-searched library with the JAX log's lines
(``fresh_rehearsal``; it checks first that the temporary directory has
160 bytes free for each frame, about twice what the database takes). At
1M: the mean-120 profile (artifacts/library_1m_fresh_mean120_r05.log,
1,535 pairs; 120.5M frames, 19.3 GB asked), the mean-200 one
(artifacts/library_1m_fresh_mean200_r05.log, 1,511 pairs; 206.7M frames,
33.1 GB asked, a 15.95 GB database; 18 minutes on the card's machine, the
corpus build included), and the long tail (videos of 513-1024 frames on
kernel 5; 71.8M frames, 11.5 GB asked, a 7.10 GB database; 12 minutes):

    python3 -c "import chip_smoke as c; c.fresh_rehearsal(1_000_000, median=84.0)"
    python3 -c "import chip_smoke as c; c.fresh_rehearsal(1_000_000, median=160.0)"
    python3 -c "import chip_smoke as c; c.fresh_rehearsal(1_000_000, clip=1024, \
long_plants=(600, 300, 300))"

With ``timing=True`` a rehearsal's stage 4 also prints the port's
HVD_DEBUG_TIMING lines, checked and summed as phase 2d's (the mean-71
library at 1M, 16 chunks of 62,500 rows):

    python3 -c "import chip_smoke as c; c.fresh_rehearsal(1_000_000, timing=True)"

The JAX package's library rehearsal (artifacts/library_10m_rehearsal.py:
8-frame random videos, the corpus drained by stage 2 and marked searched,
then new videos with 1,000 planted re-encodes through one deduplicate();
``auto`` declines the prune, so kernel 3 and the host similarities run),
at 1M + 100k (about 3 minutes on the card's machine) and at its own
10M + 100k (about 25 minutes, 8 GB of SQLite in the temporary directory):

    python3 -c "import chip_smoke as c; c.delta_rehearsal(1_000_000, 100_000)"
    python3 -c "import chip_smoke as c; c.delta_rehearsal(10_000_000, 100_000)"

The JAX package's measured exact all-pairs sweep (artifacts/sweep_1m.py)
through the port's find_pairs at the JAX logs' own sizes, each held chunk
by chunk against its log where it has one (``sweep_rehearsal``), and the
1M library through stage 4 of deduplicate() with the timing lines
(``sweep_orchestrator``); one a chip call:

    python3 -c "import chip_smoke as c; c.sweep_rehearsal(1_000_000, 131_072, 'triangle')"
    python3 -c "import chip_smoke as c; c.sweep_rehearsal(240_000, 30_000, 'triangle', 'mixed')"
    python3 -c "import chip_smoke as c; c.sweep_rehearsal(1_000_000, 131_072, 'square')"
    python3 -c "import chip_smoke as c; c.sweep_orchestrator(1_000_000)"

Phases 0, 2 and 2b alone:

    python3 -c "import chip_smoke as c; c.phase0_build(); lib = c.build_library(100_000); \
c.stage4_orchestrator(2, *lib, {'exists_mask_sweep'}, after=lambda *s: c.phase2b_delta(lib, *s))"

Phase 11's mesh against one device in turns (one, mesh, mesh, one), stage 4
and stage 1, as PERF.md compares them (``mesh_turns``; each library's
stage 2 runs once and every turn starts from a copy of its database); on
four cards, after the dry run:

    python3 -c "import chip_smoke as c; c.phase0_build(); c.phase11_dryrun(); c.mesh_turns()"

The fresh 1M libraries on the mesh against one card, in the same turns,
from one stage 2 (``mesh_rehearsal``; it asks for FRESH_BYTES_PER_FRAME
bytes a frame for two databases, the saved one and a turn's copy): mean
200 (1,511 pairs, 66.2 GB asked) and mean 71 (1,557 pairs, 22.8 GB
asked). Every turn copies the database (16 GB at mean 200); a RAM-backed
work directory (/dev/shm) keeps those copies off the disk, each run in a
temporary directory of its own that it removes:

    python3 -c "import chip_smoke as c; c.mesh_rehearsal(1_000_000, median=160.0, \
workdir='/dev/shm')"
    python3 -c "import chip_smoke as c; c.mesh_rehearsal(1_000_000, workdir='/dev/shm')"

Phases 0 and 2, then phase 12 on the database phase 2 saved (the installed
port alone, about 2.5 minutes):

    python3 -c "import os, tempfile, chip_smoke as c; c.phase0_build(); \
lib = c.build_library(100_000); db = os.path.join(tempfile.mkdtemp(), 'p2.sqlite'); \
c.stage4_orchestrator(2, *lib, {'exists_mask_sweep'}, save_db=db); c.phase12_installed(lib, db)"

Phase 2 inside trace_to, printing its busy share (any phase runs so through
``traced``):

    python3 -c "import sys, chip_smoke as c; sys.exit(c.traced(c.stage4_orchestrator, 2, \
*c.build_library(100_000), {'exists_mask_sweep'}) is None)"
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_VIDEOS = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
THRESHOLD = 75.0
KERNELS = {  # wrapper name -> (kernel library, the JAX package's kernel it replaces)
    "exists_mask_sweep": ("exists_mask_sweep", "ops/similarity_segments.py:467"),
    "pdq_filter": ("pdq_filter", "ops/pdq_pallas.py:114"),
    "similarity_segments": ("similarity_segments", "ops/similarity_segments.py:107"),
    "exists_counts": ("similarity_segments", "ops/similarity_segments.py:230"),
    "exists_mask_kernel": ("exists_mask_sweep", "ops/similarity_segments.py:355"),
    "similarity_block": ("similarity_block", "ops/similarity_pallas.py:113"),
    # stage B: the JAX package's is XLA's batched product, no Pallas kernel
    "pair_verify": ("pair_verify", "ops/pair_verify.py:51"),
}
LIBRARIES = sorted({lib for lib, _ in KERNELS.values()})
#: the libraries whose frame pairs run on the tensor cores, and the SASS
#: opcodes of a tensor-core product
MMA_LIBRARIES = ("exists_mask_sweep", "pair_verify", "similarity_block", "similarity_segments")
MMA_OPCODES = re.compile(r"\b(IGMMA|HGMMA|QGMMA|IMMA|HMMA|BMMA)\b")
#: the int8 GEMM yardstick's output chunk (int32 entries)
YARDSTICK_CHUNK_ENTRIES = 1 << 28
#: phase 2b: the new videos added to phase 2's searched library
N_DELTA = 10_000
#: phase 2c: the mean-200 library's size and median (the JAX package's
#: artifacts/library_1m_fresh_mean200_r05.log at 1M)
N_MEAN200 = 10_000
MEAN200_MEDIAN = 160.0
#: fresh_rehearsal: the free bytes it asks for each frame before it builds
#: anything, artifacts/library_1m_fresh_mean200_r05.log's 33.05 GB over
#: 206.7M frames; the port's fresh database of that library holds 15.95 GB
#: (77 bytes a frame), so this leaves a margin of two
FRESH_BYTES_PER_FRAME = 160
#: delta_rehearsal (artifacts/library_10m_rehearsal.py): frames a video and
#: planted new videos
REHEARSAL_FRAMES = 8
REHEARSAL_PLANTS = 1_000
#: sweep_rehearsal (artifacts/sweep_1m.py): the JAX package's logs by (n,
#: chunk, mode, lengths), whose corpus line and chunk hits are held against
#: the port's, and phase 7b's runs
SWEEP_LOGS = {
    (1_000_000, 131_072, "triangle", "uniform"): "artifacts/sweep_1m_triangle_packed_warm.log",
    (240_000, 30_000, "triangle", "mixed"): "artifacts/sweep_mixed_240k.log",
}
SWEEP_CORPUS_LINE = re.compile(r"corpus: (\d+) videos \((\w+), (\d+) frames, (\d+) empty\)")
SWEEP_CHUNK_LINE = re.compile(r"chunk \d+/\d+: (\d+) hits")
SWEEP_SMOKE = ((100_000, 13_107, "triangle", "uniform"), (24_000, 3_000, "triangle", "mixed"))
#: phases 2, 2b, 2c, 7, 9 and 11: stage-2 and stage-4 search+mark seconds
#: by (phase, search_prefilter); phases 5 and 11: stage-1 (seconds, hashed
#: frames)
STAGE2_S: dict = {}
STAGE4_S: dict = {}
STAGE1_S: dict = {}
#: phase 2d and fresh_rehearsal(timing=True): the port's stage-4 timing
#: lines (HVD_DEBUG_TIMING), in the JAX package's formats
CHUNK_LINE = re.compile(
    r"^\[chunk-timing\] rows (\d+)\.\.(\d+): fetch (\d+\.\d)s search (\d+\.\d)s "
    r"mark (\d+\.\d)s \((\d+) hits\) cache-update (\d+\.\d)s$", re.M,
)
PRUNE_LAP = re.compile(
    r"^\[prune-timing\] (col reps|row reps|stage-A sweep|verify-blob fetch|verify)"
    r"(?: \((\d+) [a-z-]+\))?: (\d+\.\d)s$", re.M,
)
SEG_LAP = re.compile(r"^\[seg-timing\] (.+?): (\d+\.\d)s$", re.M)
DRAIN_SPLIT = re.compile(
    r"^\[seg-timing\] drain split: fetch (\d+\.\d)s host (\d+\.\d)s over (\d+) row tiles "
    r"\((\d+) dense-fallback groups\); (\d+) device sims, (\d+) overflowed slabs$", re.M,
)
#: on stderr, where a progress bar may precede it on its line
VERIFY_LINE = re.compile(
    r"\[verify-timing\] bucket (\d+\.\d)s pack (\d+\.\d)s dispatch (\d+\.\d)s "
    r"drain (\d+\.\d)s over (\d+) device chunks$", re.M,
)
#: the [prune-timing] laps of one chunk, in order
PRUNE_LAPS = ("col reps", "row reps", "stage-A sweep", "verify-blob fetch", "verify")
#: phase 11: the members on one card when only one is visible, and the
#: sampled files of its stage-1 run
MESH_MEMBERS_ON_ONE_CARD = 4
MESH_STAGE1_SAMPLE = 100
#: phase 5: scenes (two versions each), seconds per video at 1 fps, side
STAGE1_SCENES = 5_000
STAGE1_SECONDS = 16
STAGE1_DIM = 128
STAGE1_SAMPLE = 1_000
#: phase 9: the frame clip of the long-tail library, the size of its
#: "none" run, and the long plants (adjacent, far, half-clip) of each run
LONG_CLIP = 1024
N_NONE = 20_000
LONG_PLANTS = {"auto": (60, 30, 30), "none": (40, 15, 10)}
#: phase 10: CLIP ViT-B/32's vision tower (openai/clip-vit-base-patch32),
#: the frames of one video, its frame pairs compared, the scenes of the
#: rerank run and the tolerance of the card against the CPU
VIT_B32 = {"width": 768, "layers": 12, "heads": 12, "patch": 32, "image_size": 224,
           "embed_dim": 512}
RERANK_FRAMES = 32
RERANK_FRAME_PAIRS = 16
RERANK_SCENES = 200
TOWER_TOL = 1e-4
#: phase 12: the console script, what its wheel is built from (the
#: packages and the packaging files), and the build outputs of a checkout
#: that a copy of them leaves out
CONSOLE_SCRIPT = "hydrus-video-deduplicator-tpu-torch"
WHEEL_SOURCES = (
    "hydrus_video_deduplicator_tpu", "hydrus_video_deduplicator_tpu_torch",
    "hydrusvideodeduplicator", "setup.py", "pyproject.toml", "README.md",
)
BUILD_OUTPUTS = ("__pycache__", "build", "_build", "*.so", "*.o")
#: phase 13: the keys of bench_torch.py's last line, and its measurements
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "search_projected_1m_videos_sec",
    "search_vs_60s_target", "search_projected_1m_mean71_sec", "search_mean71_vs_60s_target",
    "measurements", "device", "launches",
)
BENCH_MEASUREMENTS = (
    "pdq_hash_fused", "pdq_filter_kernel", "search_tile", "search_row_tile", "mean71_sweep",
)
#: the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
#: a frame pair of the similarity kernels: one 256-deep product, 512
#: operations (256 multiply-adds of ±1 bytes, or 256 ANDs and popcount adds)
OPS_PER_FRAME_PAIR = 512
#: the binary tensor cores' rate, which the data sheet does not give: the
#: highest that mma_rates.py measured for mma.sync.m16n8k256.b1.and.popc
#: ("b1_and_popc", 2.02e13 frame pairs/s on an NVIDIA H100 80GB HBM3 at
#: 700 W), about 5.1x the int8 rate for the same frame pairs
B1_OPS_PER_S = OPS_PER_FRAME_PAIR * 2.02e13


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def file_hash(i: int) -> str:
    """The Hydrus file hash of video i of a stage-4 library."""
    return f"{i:016x}" + "00" * 24


def card_lines() -> list[str]:
    """Every visible card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls after warmup calls."""
    import torch

    for _ in range(warmup):
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

    def build(name):
        t0 = time.perf_counter()
        so = _build.library_path(name)
        return so, time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, together
        built = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
    for name, (so, sec) in built.items():
        log(f"kernel build {name} (nvcc, sm_90a): {sec:.3f} s -> {os.path.relpath(so, ROOT)}")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
        if name in MMA_LIBRARIES:
            sass = subprocess.run(
                [_build.cuda_tool("cuobjdump"), "--dump-sass", str(so)],
                capture_output=True, text=True, check=True,
            ).stdout
            counts: dict[str, int] = {}
            for op in MMA_OPCODES.findall(sass):
                counts[op] = counts.get(op, 0) + 1
            log(f"  SASS tensor-core MMA instructions: {counts or 'none'}")
            if not counts:
                raise AssertionError(f"phase 0: {name} holds no tensor-core MMA instruction")
        _build.load_library(name)


def peak_rss() -> str:
    """This process's peak resident set so far."""
    import resource

    return f"peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB"


def build_library(n: int, clip: int = 512, long_plants=(0, 0, 0), median: float = 48.0):
    """The seed-7 scene library of n videos, frames clipped at ``clip``, at
    the frame-count profile of ``median`` (48: mean 71; 84: mean 120; 160:
    mean 200): (blobs, expected undirected pairs, empty hashes, min_sim).
    Logs the frame profile and the planted pairs in the words of the JAX
    package's artifacts/sweep_scenes.py."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch import scene_library as sl

    counts = sl.frame_counts(np.random.default_rng(7), n, clip, median)
    log(
        f"frame profile: mean {counts.mean():.1f}, median {np.median(counts):.0f}, "
        f"p90 {np.percentile(counts, 90):.0f}, max {counts.max()}, total {counts.sum()}"
    )
    t0 = time.perf_counter()
    blobs, expected, n_empty, planted = sl.build_corpus(
        n, seed=7, clip=clip, long_plants=long_plants, median=median, with_plants=True
    )
    pairs = {(a, b) for (a, b) in expected if a < b}
    log(
        f"corpus built in {time.perf_counter() - t0:.1f}s; planted pairs >= {sl.MIN_SIM}: "
        f"{len(pairs)}/{len(planted)}"
    )
    lens = [len(b) // 32 for b in blobs]
    n_long = sum(1 for k in lens if k > sl.SEG_MAX_FRAMES)
    long_pairs = sum(1 for a, b in pairs if max(lens[a], lens[b]) > sl.SEG_MAX_FRAMES)
    n_short_plants = sum(map(len, sl.plant_layout(n)[:2]))
    log(
        f"library: N={n}, clip {clip}, median {median:g}: {sum(lens)} frames after the plants "
        f"(mean {sum(lens) / n:.1f}, max {max(lens)}), {n_long} videos of more than "
        f"{sl.SEG_MAX_FRAMES} frames, {len(planted) - n_short_plants} long plants placed of "
        f"{sum(long_plants)} asked, {long_pairs} planted pairs >= {sl.MIN_SIM} with a long side; "
        f"{peak_rss()}"
    )
    return blobs, pairs, n_empty, sl.MIN_SIM


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over their peak."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def hamming_bound(frame_pairs: int, *tensors) -> tuple[float, str, float]:
    """bound() of a Hamming-threshold kernel's call, its inputs and output
    read or written once and each real frame pair one 256-deep binary
    product (popc(a & b), which with the frames' own popcounts gives the
    distance) at the binary tensor-core rate; and, like for like with the
    bounds before the binary form, the bound with each pair a 256-wide
    int8 dot at the int8 rate (ms)."""
    n_bytes, ops = tensor_bytes(*tensors), OPS_PER_FRAME_PAIR * frame_pairs
    return (*bound(n_bytes, ops, B1_OPS_PER_S), bound(n_bytes, ops, INT8_OPS_PER_S)[0])


def segment_frame_pairs(slot_a, slot_b, valid) -> int:
    """Real frame pairs of one sweep-shaped call: every non-padding row
    frame against every non-padding frame of the valid column steps."""
    live_b = (slot_b.view(valid.shape[0], -1) >= 0) & (valid[:, None] != 0)
    return int((slot_a >= 0).sum()) * int(live_b.sum())


def int_mm_yardstick(rows, cols) -> tuple[float, int]:
    """(ms, frame pairs) of torch._int_mm over every row against every
    column, both [n, 256] ±1 int8 rows, in column chunks whose int32
    output holds at most YARDSTICK_CHUNK_ENTRIES entries. It is the inner
    product of the similarity kernels alone (no threshold, no reduction to
    videos), a yardstick of the card's int8 GEMM, and the port never calls
    it."""
    import torch

    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))  # noqa: E731
    m = rows.shape[0]
    rows = pad(rows, max(24, -(-m // 8) * 8) - m)  # _int_mm: more than 16 rows, 8 | rows
    chunk = max(8, YARDSTICK_CHUNK_ENTRIES // rows.shape[0] // 8 * 8)
    parts = [cols[c0 : c0 + chunk] for c0 in range(0, cols.shape[0], chunk)]
    parts = [pad(p, -p.shape[0] % 8).contiguous() for p in parts]

    def run():
        for p in parts:
            torch._int_mm(rows, p.t())

    return cuda_time_ms(run, 3, warmup=1), m * cols.shape[0]


def report_work(phase: str, a_words, slot_a, b_words, slot_b, valid, kernel_ms: float) -> None:
    """Prints the work of a sweep-shaped call (every 16-frame row fragment
    and 32-frame run of column frames holding a real frame, of every (row
    block, valid step) pair, against the slot pairs and the real pairs) and
    the yardstick, torch._int_mm over the same real frames as ±1 rows."""
    from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim

    n_steps = valid.shape[0]
    steps = valid != 0
    live_b = (slot_b.view(n_steps, -1) >= 0) & steps[:, None]
    row_frags = int((slot_a.view(-1, 16) >= 0).any(1).sum())
    col_runs = int(live_b.view(n_steps, -1, 32).any(2).sum())
    slot_pairs = (slot_a.shape[0] // 2048) * int(steps.sum()) * 2048 * 2048
    computed = row_frags * 16 * col_runs * 32
    real = segment_frame_pairs(slot_a, slot_b, valid)
    log(
        f"phase {phase} work: {slot_pairs} slot pairs, {computed} in live fragments, {real} real "
        f"frame pairs: {slot_pairs / real:.4f} and {computed / real:.4f} per real pair"
    )
    yard_ms, yard_pairs = int_mm_yardstick(
        ops_sim.unpack_pm1(a_words[slot_a >= 0]), ops_sim.unpack_pm1(b_words[live_b.flatten()])
    )
    log(
        f"phase {phase} yardstick, torch._int_mm over the same real frames as ±1 rows (the inner "
        f"product alone, int32 out): {yard_ms:.4f} ms, {yard_pairs} pairs, "
        f"{yard_pairs / (yard_ms / 1e3):.4g} pairs/s; the kernel {kernel_ms:.4f} ms, "
        f"{real / (kernel_ms / 1e3):.4g} real pairs/s"
    )


def phase1_inputs(blobs, dev):
    """The sweep's arguments at the main path's shapes (phase 1): one row
    tile of 2 row blocks of scene leaders of the first 1,000 videos against
    the whole column corpus of leaders, an all-zero real frame at each
    side, padding, every seventh step invalid. Returns (a_words, slot_a,
    b_words, slot_b, valid)."""
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import reps as reps_mod
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
    return a_words, slot_a, b_words, cols["slots"], valid


def phase1_kernel_vs_plain(blobs, dev):
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

    args = phase1_inputs(blobs, dev)
    slot_a, slot_b, valid = args[1], args[3], args[4]
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
        pairs = segment_frame_pairs(slot_a, slot_b, valid)
        bound_ms, bound_by, int8_ms = hamming_bound(pairs, *args, got)
        log(
            f"phase 1 tol {tol}: bit-equal ({n_bits} bits set); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call; {pairs} real frame pairs, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {int8_ms:.4f} ms at the int8 rate)"
        )
        result[tol] = {
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "frame_pairs": pairs,
        }
    report_work("1", *args, result[79]["ms"])
    return result


class StageTimers:
    """Wall time of the engine's stages during a phase, by wrapping them."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.events: dict[str, list] = {}  # kernel wrapper -> CUDA events per call
        self.work: dict[str, list] = {}  # kernel wrapper -> work per call
        self.member_events: dict[str, list] = {}  # kernel wrapper -> each member's CUDA events
        self.spans: list | None = None  # the recorder's spans, from record_spans() on
        self._recording: tuple | None = None  # (recorder switch before, since ns)
        self._restore = []

    def wrap(self, owner, name: str, label: str):
        """Time each call."""
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

    def wrap_kernel(self, module, name: str, work=None):
        """Time each call of a kernel wrapper with CUDA events; with work,
        also keep work(*args) (an int or a device scalar, read afterwards)."""
        import torch

        real = getattr(module, name)

        def launched(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            if work is not None:
                self.work.setdefault(name, []).append(work(*args))
            return out

        setattr(module, name, launched)
        self._restore.append((module, name, real))

    def count_inside(self, owner, name: str, inner, inner_name: str) -> list:
        """Count the calls of inner.inner_name made while owner.name runs;
        returns a one-element list holding the count."""
        real, real_inner = getattr(owner, name), getattr(inner, inner_name)
        depth, calls = [0], [0]

        def outer(*args, **kwargs):
            depth[0] += 1
            try:
                return real(*args, **kwargs)
            finally:
                depth[0] -= 1

        def counted(*args, **kwargs):
            calls[0] += depth[0] > 0
            return real_inner(*args, **kwargs)

        setattr(owner, name, outer)
        setattr(inner, inner_name, counted)
        self._restore += [(owner, name, real), (inner, inner_name, real_inner)]
        return calls

    def patch(self, owner, name: str, value):
        """Set owner.name to value until restore()."""
        self._restore.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def count_members(self, mesh, module, name: str, counter: dict, key: str) -> list:
        """Launches of kernel wrapper module.name per member of ``mesh``: a
        call that raised counter[key] launched on the member whose device
        and stream were current. Returns the per-member counts (a list);
        ``member_ms(name)`` gives each member's device time of those calls
        (CUDA events on the member's stream)."""
        import torch

        real = getattr(module, name)
        counts = [0] * mesh.size
        events = self.member_events[name] = [[] for _ in range(mesh.size)]

        def member_of(dev) -> int:
            handle = torch.cuda.current_stream(dev).cuda_stream
            for k, (d, stream) in enumerate(zip(mesh.devices, mesh.streams())):
                if d == dev and (stream is None or stream.cuda_stream == handle):
                    return k
            raise AssertionError(f"a launch on {dev} ran on no member's stream")

        def counted(*args):
            before = counter[key]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args)
            end.record()
            if counter[key] > before:
                k = member_of(args[0].device)
                counts[k] += counter[key] - before
                events[k].append((start, end))
            return out

        setattr(module, name, counted)
        self._restore.append((module, name, real))
        return counts

    def member_ms(self, name: str) -> list[float]:
        """Each member's device ms of the calls count_members counted."""
        import torch

        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
        return [sum(s.elapsed_time(e) for s, e in calls) for calls in self.member_events[name]]

    def capture(self, owner, name: str, sink: list):
        """Wrap a method so each instance it runs on is appended to sink."""
        real = getattr(owner, name)

        def method(obj, *args, **kwargs):
            if obj not in sink:
                sink.append(obj)
            return real(obj, *args, **kwargs)

        setattr(owner, name, method)
        self._restore.append((owner, name, real))

    def record_spans(self):
        """Switch the port's span recorder on until restore(), which keeps
        the spans closed meanwhile in ``spans``."""
        from hydrus_video_deduplicator_tpu_torch.utils import profiling

        self._recording = (profiling.enable(True), time.perf_counter_ns())

    def restore(self):
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)
        if self._recording is not None:
            from hydrus_video_deduplicator_tpu_torch.utils import profiling

            was, since = self._recording
            self.spans = [r for r in profiling.records() if r.start >= since]
            profiling.enable(was)
            if not was:
                profiling.clear()
            self._recording = None

    def kernel_ms(self, name: str) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events.get(name, []))

    def launches(self, name: str) -> int:
        return len(self.events.get(name, []))

    def work_done(self, name: str) -> int:
        return sum(int(w) for w in self.work.get(name, []))

    def span_seconds(self, name: str) -> float:
        """Seconds of the recorded spans of ``name``, summed."""
        return sum(r.seconds for r in self.spans or () if r.name == name)

    def span_count(self, name: str) -> int:
        """The recorded count ``name``, summed over the spans."""
        return sum(r.counts.get(name, 0) for r in self.spans or ())

    def drain(self) -> tuple[float, float, int]:
        """The segment routes' drain split, summed, from the recorder's
        spans once restore() has run: (fetch s, host s, row tiles), host
        being the bit decode with the hits' similarities."""
        return (
            self.span_seconds("seg.drain.fetch"),
            self.span_seconds("seg.drain.decode") + self.span_seconds("seg.similarities"),
            self.span_count("seg.tiles"),
        )


def kernel_work() -> dict:
    """Each search kernel's wrapper: (its module, its work per call):
    (row block, valid step) slot pairs of 2048 x 2048 frames for the
    segment kernels, real frame pairs for the bucketed one."""
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

    return {
        "exists_mask_sweep": (seg, lambda *a: a[0].shape[0] // 2048 * a[4].sum() * 2048 * 2048),
        "similarity_segments": (seg, lambda *a: a[0].shape[0] // 2048 * a[6].sum() * 2048 * 2048),
        "similarity_block": (
            sb, lambda *a: a[1].to(torch.int64).sum() * a[3].to(torch.int64).sum()
        ),
    }


def search_timers(kernels: set) -> StageTimers:
    """StageTimers over stage 4's engine stages, with each kernel of
    ``kernels`` timed by CUDA events beside its work per call."""
    from hydrus_video_deduplicator_tpu_torch.ops import pair_verify
    from hydrus_video_deduplicator_tpu_torch.ops import reps as reps_mod
    from hydrus_video_deduplicator_tpu_torch.parallel import engine
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

    timers = StageTimers()
    timers.wrap(reps_mod, "extract_reps", "host clustering (reps)")
    timers.wrap(GpuSearchEngine, "_stage_columns", "column staging")
    timers.wrap(GpuSearchEngine, "_segment_route", "segment route (launches + drain)")
    timers.wrap(GpuSearchEngine, "_bucket_pair", "bucketed route (staging, launches, hits)")
    timers.wrap(engine.CorpusIndex, "bucket_arrays", "bucket packing (host)")
    timers.wrap(engine, "_emptied", "complement inputs (host)")
    timers.wrap(pair_verify, "verify_pairs", "stage B (verify)")
    timers.wrap(engine, "_with_similarities", "hit similarities (matchHashBytes)")
    timers.record_spans()
    work = kernel_work()
    for name in kernels:
        timers.wrap_kernel(work[name][0], name, work[name][1])
    return timers


def log_search_timers(phase, timers: StageTimers, kernels: set, total: float | None = None) -> None:
    """Prints what search_timers measured; with ``total``, the seconds of
    the run they were taken in, also what no timer covered (SQLite, the
    marking and the rest: the timed stages do not nest)."""
    for label, sec in timers.seconds.items():
        log(f"phase {phase}   {label}: {sec:.3f} s")
    if total is not None:
        rest = total - sum(timers.seconds.values())
        log(f"phase {phase}   remainder (SQLite, marking and the rest): {rest:.3f} s")
    fetch, host, tiles = timers.drain()
    if tiles:
        log(f"phase {phase}   drain of the segment routes: fetch (torch.nonzero and the copies, "
            f"waiting on the kernels) {fetch:.3f} s, host (decode, slot mapping) {host:.3f} s "
            f"over {tiles} row tiles; {timers.span_count('seg.device_sims')} similarities "
            f"read from kernel 3's hit lists, {timers.span_count('seg.host_hits')} scored on "
            f"the host ({timers.span_count('seg.sims_overflow')} slabs overflowed)")
    for name in sorted(kernels):
        kernel_ms = timers.kernel_ms(name)
        done = timers.work_done(name)
        unit = "real frame pairs" if name == "similarity_block" else (
            "frame-pair slots ((row block, valid step) pairs x 2048 x 2048)"
        )
        log(
            f"phase {phase}   {name} device time: {kernel_ms:.3f} ms over "
            f"{timers.launches(name)} launches, {done} {unit}, "
            f"{done / max(kernel_ms / 1e3, 1e-9):.4g} per s"
        )


def search_counters() -> tuple:
    """The LAUNCHES counters of the search kernels' modules."""
    from hydrus_video_deduplicator_tpu_torch.ops import pair_verify as pv
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

    return seg.LAUNCHES, sb.LAUNCHES, pv.LAUNCHES


def search_launches() -> dict:
    """Every search kernel's launch count."""
    return {name: n for counter in search_counters() for name, n in counter.items()}


def zero_search_launches() -> None:
    for counter in search_counters():
        for name in counter:
            counter[name] = 0


def check_launches(phase, launches: dict, kernels: set) -> None:
    """Every kernel of ``kernels`` launched, and no other search kernel. A
    pruned search (stage A's sweep among ``kernels``) also launches stage
    B's kernel: every library of these phases has near-copy plants of at
    most 512 frames, pairs of two different blobs that stage B scores."""
    if "exists_mask_sweep" in kernels:
        kernels = kernels | {"pair_verify"}
    idle = sorted(name for name in kernels if launches[name] == 0)
    if idle:
        raise AssertionError(f"phase {phase}: {idle} never launched")
    others = {name: n for name, n in launches.items() if name not in kernels and n}
    if others:
        raise AssertionError(f"phase {phase}: other kernels launched: {others}")


def unsearched_files(db, search_threshold: int) -> int:
    return db.execute(
        "SELECT count(*) FROM shape_search_cache WHERE searched_distance IS NULL"
        " OR searched_distance < ?",
        (search_threshold,),
    ).fetchone()[0]


def stage4_orchestrator(
    phase, blobs, expected, n_empty, min_sim, kernels: set, mesh=None,
    save_db: str | None = None, from_db: str | None = None, after=None,
    workdir: str | None = None, release_blobs: bool = False, search: bool = True, **kwargs
):
    """Stage 4 of a fresh library through deduplicate(skip_hashing=True)
    with the port's orchestrator (kwargs go to its constructor): the marked
    set must be the planted set, every kernel of ``kernels`` must have
    launched and no other search kernel, and no torch.matmul may run inside
    the bucketed route. With ``mesh``, the orchestrator's _device_mesh
    returns it, and every kernel of ``kernels`` must have launched on every
    member. ``save_db`` copies the database there once stage 2 and the
    maintenance are done, and with ``search=False`` the run ends there
    (returning None); ``from_db`` starts from a copy of such a file
    instead of filling the queue and running stage 2, and then reads only
    len(blobs) (phase 11 so reuses the libraries of phases 2 and 9).
    ``after(deduper, db, server, seconds)`` runs on the live database
    once the re-run has passed (phase 2b), with this run's stage-2,
    maintenance and stage-4 seconds, its database's GB, the split of
    search_timers ("split": label -> s), the drain's ("drain": fetch s,
    host s, row tiles) and, with ``mesh``, each kernel's launches and
    device ms per member ("members": name -> (launches, ms)). With
    ``mesh`` it prints those per-member launches and ms. The database lies in a
    temporary directory under ``workdir`` (default: tempfile's);
    ``release_blobs`` empties the list ``blobs`` once they are queued, so
    stage 4 streams them from SQLite alone, as a user's run does. The
    stage lines use the words of the JAX package's
    artifacts/library_1m_fresh.py. Returns the launch counts of every
    search kernel; records the stage-2 and stage-4 seconds in
    STAGE2_S and STAGE4_S under (phase, search_prefilter)."""
    import torch

    from hydrus_video_deduplicator_tpu_torch import dedup
    from hydrus_video_deduplicator_tpu_torch.client import HVDClient
    from hydrus_video_deduplicator_tpu_torch.db import DedupeDB, vptree
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    n_videos = len(blobs)
    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)
    assert max(1, 101 - search_threshold) == min_sim

    os.environ.setdefault("HVD_SQLITE_CACHE_MB", "1024")
    server = FakeHydrus({})
    server.start()
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_", dir=workdir) as workdir:
        try:
            DedupeDB.set_db_dir(workdir)
            if from_db:
                shutil.copyfile(from_db, DedupeDB.get_db_file_path())
            else:
                DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            t_queue = t_stage2 = t_maint = 0.0
            t0 = time.perf_counter()
            if not from_db:
                for i0 in range(0, n_videos, 50_000):
                    db.conn.executemany(
                        "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash)"
                        " VALUES (?, ?)",
                        [(file_hash(i), blobs[i]) for i in range(i0, min(i0 + 50_000, n_videos))],
                    )
                db.commit()
                t_queue = time.perf_counter() - t0
                log(f"phase {phase}: queue filled: {n_videos} rows in {t_queue:.3f}s; {peak_rss()}")
                if release_blobs:
                    blobs.clear()

            deduper = dedup.HydrusVideoDeduplicator(
                db, client=client, search_backend="gpu", **kwargs
            )
            deduper.threshold = THRESHOLD
            if not from_db:
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
            if save_db:
                shutil.copyfile(DedupeDB.get_db_file_path(), save_db)
            n_files = db.execute("SELECT count(*) FROM files").fetchone()[0]
            left = db.execute("SELECT count(*) FROM phashed_file_queue").fetchone()[0]
            if from_db:
                log(f"phase {phase}: from {os.path.basename(from_db)}: files={n_files}")
            else:
                log(
                    f"phase {phase}: STAGE2: drained {n_videos} rows in {t_stage2:.3f}s "
                    f"({n_videos / t_stage2:.0f} rows/s), maintenance {t_maint:.3f}s; "
                    f"files={n_files} queue_left={left}; {peak_rss()}"
                )
                STAGE2_S[(phase, kwargs.get("search_prefilter", "auto"))] = t_stage2
            db_gb = os.path.getsize(DedupeDB.get_db_file_path()) / 1e9
            log(f"phase {phase}: DB size {db_gb:.2f}G")
            assert n_files == n_videos and left == 0, (n_files, left)
            if not search:
                db.close()
                return None

            timers = search_timers(kernels)
            per_member = {}
            if mesh is not None:
                timers.patch(dedup.HydrusVideoDeduplicator, "_device_mesh", lambda self: mesh)
                work = kernel_work()
                for name in kernels:
                    module = work[name][0]
                    per_member[name] = timers.count_members(
                        mesh, module, name, module.LAUNCHES, name
                    )
            matmuls = timers.count_inside(GpuSearchEngine, "_bucket_pair", torch, "matmul")
            zero_search_launches()
            t0 = time.perf_counter()
            try:
                pairs = deduper.deduplicate(skip_hashing=True)
            finally:
                timers.restore()
            t_search = time.perf_counter() - t0
            STAGE4_S[(phase, kwargs.get("search_prefilter", "auto"))] = t_search
            launches = search_launches()
            log(
                f"phase {phase}: STAGE4: fresh deduplicate() at {n_videos}x{n_videos}: reported "
                f"{pairs} pairs in {t_search:.3f}s; {peak_rss()}"
            )

            idx = {file_hash(i): i for i in range(n_videos)}
            got = {tuple(sorted((idx[a], idx[b]))) for a, b in server.relationships}
            unsearched = unsearched_files(db, search_threshold)
            log(
                f"phase {phase}: verify: marked {len(got)} pairs (expected {len(expected)}); "
                f"missing {len(expected - got)}, extras {len(got - expected)}; unsearched left "
                f"{unsearched}"
            )
            log(
                f"phase {phase}: N={n_videos} ({n_empty} empty hashes), {kwargs}: kernel "
                f"launches {launches}; torch.matmul calls inside the bucketed route {matmuls[0]}"
            )
            if got != expected or pairs != len(expected):
                raise AssertionError(f"phase {phase}: the marked pairs differ from the planted set")
            if unsearched:
                raise AssertionError(f"phase {phase}: {unsearched} files left unsearched")
            check_launches(phase, launches, kernels)
            if matmuls[0]:
                raise AssertionError(f"phase {phase}: the bucketed route ran torch.matmul")
            members = {name: (counts, timers.member_ms(name)) for name, counts in per_member.items()}
            for name, (counts, ms) in sorted(members.items()):
                log(f"phase {phase}   {name} per member of {mesh}: launches {counts}, device ms "
                    + ", ".join(f"{x:.3f}" for x in ms))
                if not all(counts):
                    raise AssertionError(f"phase {phase}: {name} never launched on some member")
            t0 = time.perf_counter()
            pairs2 = deduper.deduplicate(skip_hashing=True)
            t_rerun = time.perf_counter() - t0
            log(f"phase {phase}: re-run: {pairs2} pairs in {t_rerun:.3f}s (expected 0)")
            if pairs2 != 0:
                raise AssertionError(f"phase {phase}: re-run marked {pairs2} pairs")
            log_search_timers(phase, timers, kernels, total=t_search)
            if after is not None:
                after(deduper, db, server, {
                    "stage 2": t_stage2, "maintenance": t_maint, "DB GB": db_gb,
                    "stage 4": t_search, "split": dict(timers.seconds), "drain": timers.drain(),
                    "members": members,
                })
            db.close()
        finally:
            server.stop()
    return launches


class Tee(io.TextIOBase):
    """A text stream that writes through to ``stream`` and keeps a copy."""

    def __init__(self, stream):
        self.stream = stream
        self.copy = io.StringIO()

    def write(self, text: str) -> int:
        self.stream.write(text)
        return self.copy.write(text)

    def flush(self) -> None:
        self.stream.flush()


@contextlib.contextmanager
def debug_timing_run():
    """HVD_DEBUG_TIMING=1 inside the block, stdout and stderr teed, and the
    hits of every stage-4 chunk's search counted (each outermost call of
    find_pairs_pruned or find_pairs: what the chunk loop hands mark_hits).
    Yields a dict: "out" and "err", the streams' copies (StringIO), and
    "hits", the hits counted."""
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
    from hydrus_video_deduplicator_tpu_torch.utils.profiling import DEBUG_TIMING_ENV

    seen = {"out": Tee(sys.stdout), "err": Tee(sys.stderr), "hits": 0}
    depth = [0]
    real = {name: getattr(GpuSearchEngine, name) for name in ("find_pairs_pruned", "find_pairs")}

    def counted(name):
        def search(self, *args, **kwargs):
            depth[0] += 1
            try:
                hits = real[name](self, *args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                seen["hits"] += len(hits)
            return hits

        return search

    before = os.environ.get(DEBUG_TIMING_ENV)
    os.environ[DEBUG_TIMING_ENV] = "1"
    for name in real:
        setattr(GpuSearchEngine, name, counted(name))
    try:
        with contextlib.redirect_stdout(seen["out"]), contextlib.redirect_stderr(seen["err"]):
            yield seen
    finally:
        for name, fn in real.items():
            setattr(GpuSearchEngine, name, fn)
        if before is None:
            del os.environ[DEBUG_TIMING_ENV]
        else:
            os.environ[DEBUG_TIMING_ENV] = before
        seen["out"], seen["err"] = seen["out"].copy.getvalue(), seen["err"].copy.getvalue()


def stage4_split(phase, seen: dict, n_rows: int, t_stage4: float, pruned: bool = True) -> None:
    """Reads the timing lines of one stage-4 run (``debug_timing_run``) of
    n_rows unsearched rows and prints the split of its t_stage4 seconds:
    the chunks' fetch, search (the prune laps and, as what no lap covers,
    the complements), mark and cache-update, and what lies outside the
    chunks; then stage A's segment laps and stage B's verify split. Raises
    unless there is one chunk line per checkpoint chunk, spanning the rows
    in order, whose hits add up to what the searches handed the marking;
    every tag is there ([verify-timing] on stderr); and the chunks' parts
    add up to at most t_stage4 (plus the printed tenths' rounding).
    ``pruned=False`` reads a run on the unpruned route, which prints no
    [prune-timing] or [verify-timing] line: its search is the segment
    route, whose drain host seconds hold the hits' similarities."""
    from hydrus_video_deduplicator_tpu_torch.dedup import HydrusVideoDeduplicator as D

    out, err = seen["out"], seen["err"]
    chunks = [m.groups() for m in CHUNK_LINE.finditer(out)]
    rows = max(D.SEARCH_CHECKPOINT_ROWS, -(-n_rows // D.SEARCH_MAX_CHUNKS))
    spans = [(int(c[0]), int(c[1])) for c in chunks]
    want = [(k, min(k + rows, n_rows)) for k in range(0, n_rows, rows)]
    if spans != want:
        raise AssertionError(f"phase {phase}: chunk lines {spans}, checkpoint chunks {want}")
    hits = sum(int(c[5]) for c in chunks)
    if hits != seen["hits"]:
        raise AssertionError(
            f"phase {phase}: the chunk lines hold {hits} hits, the marking got {seen['hits']}"
        )
    tags = [
        ("[chunk-timing]", chunks), ("[seg-timing]", SEG_LAP.search(out)),
        ("drain split", DRAIN_SPLIT.search(out)),
    ]
    if pruned:
        tags += [
            ("[prune-timing]", PRUNE_LAP.search(out)),
            ("[verify-timing] on stderr", VERIFY_LINE.search(err)),
        ]
    missing = [tag for tag, found in tags if not found]
    if missing:
        raise AssertionError(f"phase {phase}: no {missing} line")
    sums = {part: sum(float(c[k]) for c in chunks) for k, part in (
        (2, "fetch"), (3, "search"), (4, "mark"), (6, "cache-update"),
    )}
    in_chunks = sum(sums.values())
    if in_chunks > t_stage4 + 0.05 * 4 * len(chunks):
        raise AssertionError(f"phase {phase}: the chunks' parts {in_chunks:.1f} s exceed stage 4")
    laps = {label: 0.0 for label in PRUNE_LAPS}
    for label, _count, sec in PRUNE_LAP.findall(out):
        laps[label] += float(sec)
    seg: dict = {}
    for label, sec in SEG_LAP.findall(out):
        label = re.sub(r"^row tile \d+ dispatched$", "row tile k dispatched", label)
        seg[label] = seg.get(label, 0.0) + float(sec)
    drain = [tuple(map(float, m)) for m in DRAIN_SPLIT.findall(out)]
    verify = [tuple(map(float, m)) for m in VERIFY_LINE.findall(err)]
    # each part sums lines printed in tenths: up to 0.05 s off a line
    outside = t_stage4 - in_chunks
    complements = sums["search"] - sum(laps.values())
    n_laps = len(PRUNE_LAP.findall(out))
    search = (
        f"col reps {laps['col reps']:.1f}, row reps {laps['row reps']:.1f}, stage A "
        f"{laps['stage-A sweep']:.1f}, verify-blob fetch {laps['verify-blob fetch']:.1f}, "
        f"verify {laps['verify']:.1f}, complements (search less its laps) {complements:.1f} "
        f"+- {0.05 * (len(chunks) + n_laps):.2f}" if pruned else "the unpruned find_pairs"
    )
    log(
        f"phase {phase}: stage 4 {t_stage4:.3f} s over {len(chunks)} chunks, {hits} hits, in "
        f"sums of the lines' tenths (each up to 0.05 s off): fetch {sums['fetch']:.1f}, search "
        f"{sums['search']:.1f} ({search}), mark {sums['mark']:.1f}, cache-update "
        f"{sums['cache-update']:.1f}, outside the chunks {outside:.1f} +- "
        f"{0.05 * 4 * len(chunks):.2f} s; card: {card_line()}"
    )
    log(
        f"phase {phase}   {'stage A' if pruned else 'the search'}'s segment laps (s): "
        + ", ".join(f"{label} {sec:.1f}" for label, sec in seg.items())
        + f"; drain fetch {sum(d[0] for d in drain):.1f}, host {sum(d[1] for d in drain):.1f} "
        f"over {int(sum(d[2] for d in drain))} row tiles, {int(sum(d[4] for d in drain))} "
        f"device sims, {int(sum(d[5] for d in drain))} overflowed slabs"
        + (
            f"; stage B (verify): bucket {sum(v[0] for v in verify):.1f}, pack "
            f"{sum(v[1] for v in verify):.1f}, dispatch {sum(v[2] for v in verify):.1f}, drain "
            f"{sum(v[3] for v in verify):.1f} over {int(sum(v[4] for v in verify))} device chunks"
            if pruned else " (the host seconds hold the overflowed slabs' similarities)"
        )
    )


def phase2d_timing(lib, db2: str, phase2_sweeps: int) -> None:
    """Phase 2d: stage 4 once more from the database phase 2 saved after
    stage 2, with HVD_DEBUG_TIMING=1 for this run only
    (``debug_timing_run``): held as phase 2 (the planted set, the cache
    fully marked, a re-run marking 0, the sweep and no other kernel), with
    as many sweep launches as phase 2, and its timing lines read and its
    stage-4 seconds split by ``stage4_split``."""
    with debug_timing_run() as seen:
        launches = stage4_orchestrator(
            "2d", *lib, {"exists_mask_sweep"}, from_db=db2, search_prefilter="auto"
        )
    stage4_split("2d", seen, len(lib[0]), STAGE4_S[("2d", "auto")])
    log(
        f"phase 2d: sweep launches {launches['exists_mask_sweep']} (phase 2: {phase2_sweeps}); "
        f"stage 4 {STAGE4_S[('2d', 'auto')]:.3f} s (phase 2, without the lines: "
        f"{STAGE4_S[(2, 'auto')]:.3f} s)"
    )
    if launches["exists_mask_sweep"] != phase2_sweeps:
        raise AssertionError("phase 2d: the sweep launched otherwise than in phase 2")


def phase2b_delta(lib, deduper, db, server, before: dict) -> dict:
    """Phase 2b, the delta: N_DELTA new videos of scene_library.build_delta
    added to the library that phase 2 has just searched (``deduper``,
    ``db`` and ``server`` are phase 2's, after its re-run), listed by the
    fake server and queued in the database, then one
    deduplicate(skip_hashing=True) with the user's default
    search_prefilter="auto". Stage 2 must drain only the new rows; the
    server's relationships must be phase 2's plants and the delta's, every
    POST of the run one pair of the delta's (none between two searched
    videos, none twice); the returned count must follow the reference's
    rule, a hit against a searched video one event and a hit between two
    new videos two, halved; the search cache must be fully marked, a
    re-run must mark 0, and the sweep and stage B's kernel must have
    launched and no other search kernel. Prints the run's stage-2 and
    stage-4 seconds beside phase 2's (``before``). Returns the search
    kernels' launches."""
    from hydrus_video_deduplicator_tpu_torch import scene_library as sl
    from hydrus_video_deduplicator_tpu_torch.db import vptree

    blobs, expected, _n_empty, _min_sim = lib
    n = len(blobs)
    t0 = time.perf_counter()
    new, delta = sl.build_delta(blobs, N_DELTA)
    delta_pairs = {(a, b) for a, b in delta if a < b}
    n_cross = sum(1 for a, _ in delta_pairs if a < n)
    want_count = (n_cross + 2 * (len(delta_pairs) - n_cross)) // 2
    log(
        f"phase 2b delta: {N_DELTA} new videos ({sum(map(len, new)) // 32} frames) on the "
        f"{n} searched ones: {n_cross} re-encodes of searched videos (the first of video "
        f"{min(a for a, _ in delta_pairs)}, the last of {max(a for a, b in delta_pairs if a < n)}), "
        f"{len(delta_pairs) - n_cross} pairs among the new videos; "
        f"{time.perf_counter() - t0:.1f} s to build"
    )
    server.files.update({file_hash(n + k): b"" for k in range(N_DELTA)})
    t0 = time.perf_counter()
    db.conn.executemany(
        "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
        [(file_hash(n + k), blob) for k, blob in enumerate(new)],
    )
    db.commit()
    t_queue = time.perf_counter() - t0

    kernels = {"exists_mask_sweep"}
    timers = search_timers(kernels)
    drained: list[int] = []
    drain = db.drain_phashed_queue_batch
    timers.patch(db, "drain_phashed_queue_batch", lambda limit: drained.append(drain(limit)) or drained[-1])
    timers.wrap(deduper, "process_phashed_file_queue", "stage 2")
    timers.wrap(deduper, "find_potential_duplicates", "stage 4 search+mark")
    posts0 = len(server.relationship_posts)
    zero_search_launches()
    t0 = time.perf_counter()
    try:
        pairs = deduper.deduplicate(skip_hashing=True)
    finally:
        timers.restore()
    t_run = time.perf_counter() - t0
    launches = search_launches()
    STAGE4_S[("2b", "auto")] = timers.seconds["stage 4 search+mark"]

    idx = {file_hash(i): i for i in range(n + N_DELTA)}
    pair = lambda a, b: tuple(sorted((idx[a], idx[b])))  # noqa: E731
    got = {pair(a, b) for a, b in server.relationships}
    posted = [pair(r["hash_a"], r["hash_b"]) for r in server.relationship_posts[posts0:]]
    old = [p for p in posted if max(p) < n]
    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)
    unsearched = unsearched_files(db, search_threshold)
    n_files = db.execute("SELECT count(*) FROM files").fetchone()[0]
    log(
        f"phase 2b: stage 2 drained {sum(drained)} rows in {len(drained)} batches, files "
        f"{n_files}; marked {len(got)} pairs in all (phase 2's {len(expected)} + the delta's "
        f"{len(delta_pairs)}), POSTed {len(posted)} ({len(set(posted))} distinct, {len(old)} "
        f"between searched videos), missing {len((expected | delta_pairs) - got)}, extras "
        f"{len(got - (expected | delta_pairs))}, unsearched left {unsearched}; reported {pairs} "
        f"(the rule: ({n_cross} + 2 x {len(delta_pairs) - n_cross}) // 2 = {want_count}); "
        f"kernel launches {launches}"
    )
    if sum(drained) != N_DELTA or n_files != n + N_DELTA:
        raise AssertionError(f"phase 2b: stage 2 drained {sum(drained)} rows, not {N_DELTA}")
    if got != expected | delta_pairs:
        raise AssertionError("phase 2b: the marked pairs differ from phase 2's and the delta's")
    if old or len(posted) != len(set(posted)) or set(posted) != delta_pairs:
        raise AssertionError("phase 2b: the run POSTed other pairs than the delta's, once each")
    if pairs != want_count:
        raise AssertionError(f"phase 2b: reported {pairs}, the reference's rule gives {want_count}")
    if unsearched:
        raise AssertionError(f"phase 2b: {unsearched} files left unsearched")
    check_launches("2b", launches, kernels)
    t0 = time.perf_counter()
    pairs2 = deduper.deduplicate(skip_hashing=True)
    t_rerun = time.perf_counter() - t0
    if pairs2 != 0 or len(server.relationship_posts) != posts0 + len(posted):
        raise AssertionError(f"phase 2b: re-run marked {pairs2} pairs")
    log(
        f"phase 2b stage times (s): queue fill {t_queue:.3f}, stage 2 "
        f"{timers.seconds['stage 2']:.3f} (phase 2: {before['stage 2']:.3f}), stage 4 "
        f"search+mark {timers.seconds['stage 4 search+mark']:.3f} (phase 2: "
        f"{before['stage 4']:.3f}), deduplicate() {t_run:.3f}, re-run {t_rerun:.3f}"
    )
    log_search_timers("2b", timers, kernels)
    return launches


def delta_rehearsal(n_corpus: int, n_new: int) -> None:
    """The JAX package's library rehearsal (artifacts/library_10m_rehearsal.py)
    through the port's orchestrator on the card: n_corpus videos of
    REHEARSAL_FRAMES random 256-bit frames (seed 7) queued and drained by
    stage 2, the corpus then marked searched, and n_new new videos (seed
    11) queued, of which new video k < REHEARSAL_PLANTS is corpus video
    k * stride with one bit flipped per frame (similarity 100); then one
    deduplicate(skip_hashing=True) with the user's default
    search_prefilter="auto", which declines the prune on random frames, so
    stage 4 runs the segment similarity kernel and the host similarities.
    The marked set must be the planted pairs exactly, the reported count
    REHEARSAL_PLANTS // 2 (a new-against-searched hit is one event,
    halved), nothing left unsearched, a re-run must mark 0, and the
    segment similarity kernel must have launched and no other search
    kernel. Prints each part's seconds, kernel 3's launches and device
    time, and the peak host RSS. Not part of main()."""
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch import dedup
    from hydrus_video_deduplicator_tpu_torch.client import HVDClient
    from hydrus_video_deduplicator_tpu_torch.db import DedupeDB, vptree
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    if not torch.cuda.is_available():
        raise RuntimeError("delta_rehearsal: CUDA is not available")
    os.environ.setdefault("HVD_SQLITE_CACHE_MB", "4096")
    n_plant = min(REHEARSAL_PLANTS, n_new)
    stride = max(1, n_corpus // (n_plant + 1))
    frame_bytes = REHEARSAL_FRAMES * 32
    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)

    def new_hash(k: int) -> str:
        return f"{k:016x}" + "ff" + "00" * 23

    server = FakeHydrus({})
    server.start()
    with tempfile.TemporaryDirectory(prefix="hvd_delta_rehearsal_") as workdir:
        try:
            log(f"delta rehearsal: corpus {n_corpus} + new {n_new} ({n_plant} planted, stride "
                f"{stride}), {REHEARSAL_FRAMES} frames a video; {shutil.disk_usage(workdir).free / 1e9:.1f} "
                f"GB free; card: {card_line()}")
            DedupeDB.set_db_dir(workdir)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            insert = "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)"

            t0 = time.perf_counter()
            rng = np.random.default_rng(7)
            targets: dict[int, bytes] = {}
            for i0 in range(0, n_corpus, 100_000):
                raw = rng.integers(0, 256, (min(100_000, n_corpus - i0), frame_bytes), dtype=np.uint8)
                for t in range(-(-i0 // stride) * stride, i0 + len(raw), stride):
                    if t // stride < n_plant:
                        targets[t] = raw[t - i0].tobytes()
                db.conn.executemany(insert, ((file_hash(i0 + k), r.tobytes()) for k, r in enumerate(raw)))
                if (i0 // 100_000) % 10 == 9:
                    db.commit()
            db.commit()
            log(f"delta rehearsal: corpus queued in {time.perf_counter() - t0:.3f} s; {peak_rss()}")

            deduper = dedup.HydrusVideoDeduplicator(db, client=client, search_backend="gpu")
            deduper.threshold = THRESHOLD
            t0 = time.perf_counter()
            db.begin_transaction()
            with db.conn:
                deduper.process_phashed_file_queue()
            t_stage2 = time.perf_counter() - t0
            db.begin_transaction()
            with db.conn:
                deduper.run_maintenance()
            n_files = db.execute("SELECT count(*) FROM files").fetchone()[0]
            log(f"delta rehearsal: stage 2 drained the corpus in {t_stage2:.3f} s "
                f"({n_corpus / t_stage2:.0f} rows/s), files {n_files}, database "
                f"{os.path.getsize(DedupeDB.get_db_file_path()) / 1e9:.2f} GB; {peak_rss()}")
            if n_files != n_corpus:
                raise AssertionError(f"delta rehearsal: {n_files} files after stage 2")
            t0 = time.perf_counter()
            db.conn.execute("UPDATE shape_search_cache SET searched_distance = ?", (search_threshold,))
            db.commit()
            log(f"delta rehearsal: corpus marked searched in {time.perf_counter() - t0:.3f} s")

            rng = np.random.default_rng(11)
            planted = set()
            rows = []
            for k in range(n_new):
                if k < n_plant:
                    arr = np.frombuffer(targets[k * stride], dtype=np.uint8).copy()
                    arr = arr.reshape(REHEARSAL_FRAMES, 32)
                    arr[:, k % 32] ^= np.uint8(1 << (k % 8))
                    blob = arr.tobytes()
                    planted.add(tuple(sorted((new_hash(k), file_hash(k * stride)))))
                else:
                    blob = rng.integers(0, 256, frame_bytes, dtype=np.uint8).tobytes()
                rows.append((new_hash(k), blob))
            db.conn.executemany(insert, rows)
            db.commit()
            del rows

            kernels = {"similarity_segments"}
            timers = search_timers(kernels)
            timers.wrap(deduper, "process_phashed_file_queue", "stage 2")
            timers.wrap(GpuSearchEngine, "pick_prefilter", "prefilter choice (clustering)")
            timers.wrap(deduper, "find_potential_duplicates", "stage 4 search+mark")
            zero_search_launches()
            t0 = time.perf_counter()
            try:
                pairs = deduper.deduplicate(skip_hashing=True)
            finally:
                timers.restore()
            t_run = time.perf_counter() - t0
            launches = search_launches()
            got = {tuple(sorted(p)) for p in server.relationships}
            unsearched = unsearched_files(db, search_threshold)
            log(f"delta rehearsal: deduplicate(skip_hashing=True) at {n_new} x {n_corpus + n_new}: "
                f"{t_run:.3f} s, reported {pairs}; marked {len(got)} pairs (planted {len(planted)}), "
                f"missing {len(planted - got)}, extras {len(got - planted)}, unsearched left "
                f"{unsearched}; kernel launches {launches}; {peak_rss()}")
            log_search_timers("rehearsal", timers, kernels)
            if got != planted or pairs != n_plant // 2:
                raise AssertionError("delta rehearsal: the marked pairs or the count are not the plants'")
            if unsearched:
                raise AssertionError(f"delta rehearsal: {unsearched} files left unsearched")
            check_launches("rehearsal", launches, kernels)
            t0 = time.perf_counter()
            pairs2 = deduper.deduplicate(skip_hashing=True)
            log(f"delta rehearsal: re-run {time.perf_counter() - t0:.3f} s, marked {pairs2}; "
                f"{peak_rss()}; card: {card_line()}")
            if pairs2 != 0:
                raise AssertionError(f"delta rehearsal: the re-run marked {pairs2} pairs")
            db.close()
        finally:
            server.stop()


def phase2c_mean200() -> dict:
    """Phase 2c, the mean-200 profile: the seed-7 scene library of N_MEAN200
    videos at the median MEAN200_MEDIAN (the JAX package's
    artifacts/library_1m_fresh_mean200_r05.log at a hundredth of its size)
    through stage4_orchestrator with search_prefilter="auto", held as phase
    2 is: the planted set, the cache fully marked, a re-run marking 0, the
    sweep and stage B's kernel launched and no other search kernel. Prints
    its stage-2 and stage-4 seconds beside phase 2's and its whole time.
    Returns the search kernels' launches."""
    t0 = time.perf_counter()
    lib = build_library(N_MEAN200, median=MEAN200_MEDIAN)
    launches = stage4_orchestrator("2c", *lib, {"exists_mask_sweep"}, search_prefilter="auto")
    log(
        f"phase 2c stage times (s), N={N_MEAN200} at the mean-200 profile: stage 2 "
        f"{STAGE2_S[('2c', 'auto')]:.3f} (phase 2, N={N_VIDEOS} at mean 71: "
        f"{STAGE2_S[(2, 'auto')]:.3f}), stage 4 search+mark {STAGE4_S[('2c', 'auto')]:.3f} "
        f"(phase 2: {STAGE4_S[(2, 'auto')]:.3f}); phase 2c in all {time.perf_counter() - t0:.3f}"
    )
    return launches


def check_free_space(
    who: str, n: int, clip: int, median: float, workdir: str, databases: int = 1
) -> tuple[int, int, int]:
    """(frames, bytes asked, bytes free): the seed-7 scene library of n
    videos (``build_library``'s draws) holds ``frames`` frames, and
    ``workdir`` must have FRESH_BYTES_PER_FRAME bytes free for each frame
    of each of ``databases`` databases; raises RuntimeError otherwise,
    before anything is built."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch import scene_library as sl

    frames = int(sl.frame_counts(np.random.default_rng(7), n, clip, median).sum())
    need = databases * FRESH_BYTES_PER_FRAME * frames
    free = shutil.disk_usage(workdir).free
    if need > free:
        raise RuntimeError(
            f"{who}: {databases} database(s) of {frames} frames need about {need / 1e9:.2f} GB, "
            f"{workdir} has {free / 1e9:.2f} GB free"
        )
    return frames, need, free


def fresh_rehearsal(
    n: int, median: float = 48.0, clip: int = 512, long_plants=(0, 0, 0),
    workdir: str | None = None, timing: bool = False,
) -> None:
    """The JAX package's fresh-library rehearsal
    (artifacts/library_1m_fresh.py) through the port on the card: the
    seed-7 scene library of n videos (``build_library``) queued into a
    fresh database under ``workdir`` (default: tempfile's), stage 2,
    maintenance and deduplicate(skip_hashing=True) with
    search_prefilter="auto" against a fake Hydrus server
    (``stage4_orchestrator``, the blobs dropped once queued). It raises
    before building anything unless ``workdir`` has FRESH_BYTES_PER_FRAME
    bytes free for each frame of the library, and then unless the marked
    set is the planted set, the search cache is fully marked, a re-run
    marks 0, the sweep launched and, with clip above 512, the bucketed
    similarity kernel too, and no other search kernel. It prints the JAX
    log's lines in its words and order (frame profile, planted pairs,
    queue filled, STAGE2, DB size, STAGE4, verify, re-run, SUMMARY), the
    stage split of search_timers, each kernel's launches and device time
    and the peak host RSS. With ``timing``, the run prints the port's
    HVD_DEBUG_TIMING lines too, and ``stage4_split`` checks them and splits
    its stage-4 seconds (phase 2d's line). Not part of main()."""
    import torch

    from hydrus_video_deduplicator_tpu_torch import scene_library as sl

    if not torch.cuda.is_available():
        raise RuntimeError("fresh_rehearsal: CUDA is not available")
    workdir = workdir or tempfile.gettempdir()
    frames, need, free = check_free_space("fresh_rehearsal", n, clip, median, workdir)
    log(
        f"fresh rehearsal: N={n}, median {median:g}, clip {clip}, long plants {long_plants}: "
        f"{frames} frames, {need / 1e9:.2f} GB asked ({FRESH_BYTES_PER_FRAME} bytes a frame), "
        f"{free / 1e9:.2f} GB free under {workdir}; card: {card_line()}"
    )
    blobs, pairs, n_empty, min_sim = build_library(n, clip, long_plants, median)
    kernels = {"exists_mask_sweep"}
    if clip > sl.SEG_MAX_FRAMES:
        kernels.add("similarity_block")
    seconds: dict = {}
    with debug_timing_run() if timing else contextlib.nullcontext() as seen:
        stage4_orchestrator(
            "fresh", blobs, pairs, n_empty, min_sim, kernels,
            after=lambda *a: seconds.update(a[-1]), workdir=workdir, release_blobs=True,
            search_prefilter="auto",
        )
    if timing:
        stage4_split("fresh", seen, n, seconds["stage 4"])
    total = seconds["stage 2"] + seconds["maintenance"] + seconds["stage 4"]
    log(
        f"SUMMARY: fresh {n}-video library (scene profile, median {median:g}, clip {clip}, "
        f"{n_empty} empty): stage2 {seconds['stage 2']:.3f}s, maintenance "
        f"{seconds['maintenance']:.3f}s, search+mark {seconds['stage 4']:.3f}s ({len(pairs)} "
        f"pairs marked, exact), total {total:.3f}s on one card; DB size {seconds['DB GB']:.2f}G; "
        f"{peak_rss()}; card: {card_line()}. CORRECTNESS: exact"
    )


def sweep_log(n: int, chunk: int, mode: str, lengths: str):
    """The JAX package's log of artifacts/sweep_1m.py at these arguments
    (SWEEP_LOGS): (its path, its corpus line's (videos, lengths, frames,
    empty), its chunk hits), or None where it has none."""
    path = SWEEP_LOGS.get((n, chunk, mode, lengths))
    if path is None:
        return None
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    videos, kind, frames, empty = SWEEP_CORPUS_LINE.search(text).groups()
    hits = [int(h) for h in SWEEP_CHUNK_LINE.findall(text)]
    return path, (int(videos), kind, int(frames), int(empty)), hits


def sweep_want(lens, expected: dict, chunk: int, mode: str) -> list[int]:
    """The hits the planted truth gives each row chunk of a sweep: the
    chunk's non-empty videos (self-matches), and each planted (row, col)
    direction whose row lies in the chunk and whose column lies below the
    chunk's end (triangle) or anywhere (square)."""
    n = len(lens)
    want = []
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        limit = i1 if mode == "triangle" else n
        planted = sum(1 for a, b in expected if i0 <= a < i1 and b < limit)
        want.append(sum(1 for k in range(i0, i1) if lens[k]) + planted)
    return want


def sweep_tally(hits, i0: int, expected: dict, tally: dict) -> None:
    """artifacts/sweep_1m.py's checks of one chunk's hits (row i of the
    chunk is video i0 + i), added to ``tally``: "self" (each must score
    100), "planted" (each at its expected similarity), "extras" and
    "wrong" (lists of (row, col, similarity))."""
    for i, j, s in hits:
        gi = i + i0
        if gi == j:
            tally["self"] += 1
            if s != 100:
                tally["wrong"].append((gi, j, s))
        elif (gi, j) in expected:
            tally["planted"] += 1
            if s != expected[(gi, j)]:
                tally["wrong"].append((gi, j, s))
        else:
            tally["extras"].append((gi, j, s))


def kernel3_rate() -> float:
    """Kernel 3's frame comparisons a second on one row tile against the
    whole column corpus (``bench_search_torch.measure``'s ``row_tile``,
    whose 1M projection PERF.md quotes; about a second on the card); its
    launches come before any count is set to 0."""
    import bench_search_torch

    return bench_search_torch.measure()["row_tile"]["frame_comparisons_per_s"]


def sweep_rehearsal(
    n: int = 1_000_000, chunk: int = 131_072, mode: str = "triangle", lengths: str = "uniform"
) -> dict:
    """The JAX package's measured exact all-pairs sweep
    (artifacts/sweep_1m.py's main) through the port's find_pairs on the
    card: ``scene_library.build_sweep_corpus(n, lengths)`` (seed 42), then
    row chunks of ``chunk`` videos through one GpuSearchEngine with one
    shared col_state, each against the corpus prefix ending at itself
    (``mode="triangle"``: col_limit, stage 4's schedule) or against all of
    it (``"square"``). It prints the JAX script's lines (corpus, chunk
    k/K, DONE, the checks, CORRECTNESS) so the two logs read side by side,
    and raises unless every chunk's hits equal what the planted truth
    gives it (``sweep_want``) and, where SWEEP_LOGS has a JAX log at these
    arguments, that log's corpus line and chunk hits; every non-empty
    video matches itself at 100, every planted direction is found at its
    similarity, nothing else is found, and kernel 3 launched and no other
    search kernel. Before the DONE line it prints the column staging
    seconds, kernel 3's launches and device seconds (CUDA events) and the
    frame-pair slots it computed, the drain's fetch and host seconds, the
    hits' similarities, peak host RSS and device memory, and the wall time
    beside kernel 3's projection (``kernel3_rate``) scaled to this corpus
    and mode. Raises without CUDA before anything runs. Returns kernel 3's
    launches and the chunks' hits. Not part of main(); phase 7b runs it."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("sweep_rehearsal: CUDA is not available")
    if mode not in ("triangle", "square"):
        raise ValueError(f"mode must be 'triangle' or 'square', got {mode!r}")
    from hydrus_video_deduplicator_tpu_torch import scene_library as sl
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

    log(f"sweep rehearsal: N={n}, chunk {chunk}, {mode}, {lengths}; card: {card_line()}")
    reference = sweep_log(n, chunk, mode, lengths)
    rate = kernel3_rate()
    t0 = time.perf_counter()
    blobs, expected, n_empty = sl.build_sweep_corpus(n, lengths)
    lens = np.fromiter((len(b) // 32 for b in blobs), dtype=np.int64, count=n)
    frames = int(lens.sum())
    n_far = sum(1 for a, b in expected if a < b and b - a == n // 2)
    log(
        f"corpus: {n} videos ({lengths}, {frames} frames, {n_empty} empty), "
        f"{len(expected) // 2 - n_far} near + {n_far} far planted pairs "
        f"(synth {time.perf_counter() - t0:.1f}s)"
    )
    want = sweep_want(lens, expected, chunk, mode)
    if reference is not None:
        path, corpus, jax_hits = reference
        log(f"sweep rehearsal: held against {path}: corpus {corpus}, chunk hits {jax_hits}")
        if corpus != (n, lengths, frames, n_empty) or jax_hits != want:
            raise AssertionError(f"sweep rehearsal: the corpus or its truth differs from {path}")

    eng = GpuSearchEngine()
    timers = search_timers({"similarity_segments"})
    row_blocks = [0]  # the row blocks of every launch
    launch = seg.similarity_segments

    def counted(*args):
        row_blocks[0] += args[0].shape[0] // seg.ROW_FRAMES
        return launch(*args)

    timers.patch(seg, "similarity_segments", counted)
    col_state: dict = {}
    tally = {"self": 0, "planted": 0, "extras": [], "wrong": []}
    got = []
    n_chunks = -(-n // chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_search_launches()
    t_start = time.perf_counter()
    try:
        for k, i0 in enumerate(range(0, n, chunk)):
            t_c = time.perf_counter()
            before = search_launches()["similarity_segments"]
            limit = min(i0 + chunk, n) if mode == "triangle" else None
            hits = eng.find_pairs(
                blobs[i0 : i0 + chunk], blobs, sl.MIN_SIM, col_state=col_state, col_limit=limit
            )
            sweep_tally(hits, i0, expected, tally)
            got.append(len(hits))
            now = time.perf_counter()
            log(
                f"chunk {k + 1}/{n_chunks}: {len(hits)} hits, {now - t_c:.1f}s (cum "
                f"{now - t_start:.1f}s); the planted truth {want[k]}; kernel 3 launches "
                f"{search_launches()['similarity_segments'] - before}"
            )
    finally:
        timers.restore()
    wall = time.perf_counter() - t_start
    launches = search_launches()
    peak_device = torch.cuda.max_memory_allocated()

    sims = timers.seconds.get("hit similarities (matchHashBytes)", 0.0)
    n_hits = timers.span_count("seg.host_hits")
    device_sims = timers.span_count("seg.device_sims")
    fetch = timers.span_seconds("seg.drain.fetch")
    drain_host = timers.span_seconds("seg.drain.decode")
    kernel_s = timers.kernel_ms("similarity_segments") / 1e3
    slots = timers.work_done("similarity_segments")
    n_steps = col_state["seg_cols"]["n_steps"]
    square_slots = row_blocks[0] * n_steps * seg.STEP_FRAMES * seg.ROW_FRAMES
    compared = frames * frames // 2 if mode == "triangle" else frames * frames
    projected = compared / rate
    route = timers.seconds["segment route (launches + drain)"]
    log(
        f"sweep rehearsal: column staging {timers.seconds['column staging']:.3f} s "
        f"({n_steps} column steps); segment route {route:.3f} s; "
        f"kernel 3 {kernel_s:.3f} s device time (CUDA events) over "
        f"{timers.launches('similarity_segments')} launches ({launches['similarity_segments']} "
        f"counted), {slots} frame-pair slots computed ((row block, valid step) pairs x 2048 x "
        f"2048; {slots / max(kernel_s, 1e-9):.4g} per s), {slots / square_slots:.4f} of its "
        f"{row_blocks[0]} row blocks against every step; drain fetch {fetch:.3f} s, host decode "
        f"{drain_host:.3f} s over {timers.span_count('seg.tiles')} row tiles; hit "
        f"similarities {sims:.3f} s over {n_hits} hits scored on the host, {device_sims} "
        f"read from kernel 3's hit lists ({timers.span_count('seg.sims_overflow')} slabs "
        f"overflowed)"
    )
    log(
        f"sweep rehearsal: {peak_rss()}; device memory peak {peak_device / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated); wall {wall:.3f} s against kernel 3's projection "
        f"{projected:.3f} s ({compared:.4g} frame comparisons at {rate:.4g} a second, "
        f"bench_search_torch.measure's row tile in this process): {wall / projected:.3f}x; "
        f"card: {card_line()}"
    )
    pairs = n * n // 2 if mode == "triangle" else n * n
    log(
        f"DONE [{mode}]: {n}x{n} -> {pairs:.3g} compared pairs in {wall:.1f}s wall "
        f"({pairs / wall:.3g} pairs/s end-to-end, one card)"
    )
    want_self = n - n_empty
    want_planted = sum(want) - want_self
    log(
        f"self-matches {tally['self']}/{want_self}; planted hit events "
        f"{tally['planted']}/{want_planted}; false positives {len(tally['extras'])}; wrong "
        f"similarity {len(tally['wrong'])}"
    )
    if got != want:
        raise AssertionError(f"sweep rehearsal: chunk hits {got}, the planted truth {want}")
    if tally["self"] != want_self or tally["planted"] != want_planted:
        raise AssertionError("sweep rehearsal: self-matches or planted hit events missing")
    if tally["extras"] or tally["wrong"]:
        raise AssertionError(
            f"sweep rehearsal: false positives {tally['extras'][:5]}, wrong similarity "
            f"{tally['wrong'][:5]}"
        )
    check_launches("sweep rehearsal", launches, {"similarity_segments"})
    log("CORRECTNESS: exact")
    return {"launches": launches["similarity_segments"], "chunk_hits": got}


def sweep_orchestrator(
    n: int = 1_000_000, lengths: str = "uniform", workdir: str | None = None
) -> dict:
    """sweep_rehearsal's library through the program's own stage 4, the
    run a user with a library of short clips makes:
    ``scene_library.build_sweep_corpus(n, lengths)`` queued into a fresh
    database under ``workdir`` (default: tempfile's), stage 2, maintenance
    and deduplicate(skip_hashing=True) with search_prefilter="auto",
    which declines the prune on random frames, against a fake Hydrus
    server (``stage4_orchestrator``, the blobs dropped once queued), with
    HVD_DEBUG_TIMING=1 for this run only (``debug_timing_run``). Raises
    without CUDA before anything runs, and unless the marked set is the
    planted pairs, the search cache is fully marked, a re-run marks 0, and
    kernel 3 launched and no other search kernel (kernel 1 not). Prints
    stage 2, maintenance and stage 4 seconds, the split of stage 4 that
    the timing lines give (``stage4_split``: the chunks' fetch, search,
    mark and cache-update, the search's segment laps and its drain split,
    whose host seconds hold the hits' similarities), peak host RSS and
    device memory, and the card. Returns the stage seconds and kernel 3's
    launches. Not part of main()."""
    import torch

    from hydrus_video_deduplicator_tpu_torch import scene_library as sl

    if not torch.cuda.is_available():
        raise RuntimeError("sweep_orchestrator: CUDA is not available")
    log(f"sweep orchestrator: N={n}, {lengths}; card: {card_line()}")
    t0 = time.perf_counter()
    blobs, expected, n_empty = sl.build_sweep_corpus(n, lengths)
    pairs = {(a, b) for a, b in expected if a < b}
    log(
        f"corpus: {n} videos ({lengths}, {sum(len(b) for b in blobs) // 32} frames, {n_empty} "
        f"empty), {len(pairs)} planted pairs (synth {time.perf_counter() - t0:.1f}s)"
    )
    seconds: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with debug_timing_run() as seen:
        launches = stage4_orchestrator(
            "sweep", blobs, pairs, n_empty, sl.MIN_SIM, {"similarity_segments"},
            after=lambda *a: seconds.update(a[-1]), workdir=workdir, release_blobs=True,
            search_prefilter="auto",
        )
    stage4_split("sweep", seen, n, seconds["stage 4"], pruned=False)
    log(
        f"SUMMARY: sweep library of {n} videos ({lengths}, {n_empty} empty) through stage 4: "
        f"stage2 {seconds['stage 2']:.3f}s, maintenance {seconds['maintenance']:.3f}s, "
        f"search+mark {seconds['stage 4']:.3f}s ({len(pairs)} pairs marked, exact), kernel 3 "
        f"launches {launches['similarity_segments']}; DB size {seconds['DB GB']:.2f}G; "
        f"{peak_rss()}; device memory peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated); card: {card_line()}. CORRECTNESS: exact"
    )
    return {**seconds, "launches": launches["similarity_segments"]}


def phase3_cli():
    from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
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
        seg.LAUNCHES["exists_mask_sweep"] = 0
        pdq_filter.LAUNCHES["pdq_filter"] = 0
        t0 = time.perf_counter()
        try:
            runpy.run_module("hydrus_video_deduplicator_tpu_torch", run_name="__main__")
        except SystemExit as exc:  # click's normal exit; a failure re-raises
            if exc.code not in (0, None):
                raise RuntimeError(f"the CLI exited with {exc.code}") from exc
        finally:
            sys.argv = argv
            server.stop()
        launches = (seg.LAUNCHES["exists_mask_sweep"], pdq_filter.LAUNCHES["pdq_filter"])
        return set(server.relationships), time.perf_counter() - t0, launches

    gpu_args = ["--search-backend", "gpu", "--search-prefilter", "reps"]
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_cli_") as tmp:
        gpu, t_gpu, l_gpu = run(["--hash-backend", "native", *gpu_args], os.path.join(tmp, "gpu"))
        tree, t_tree, _ = run(["--search-backend", "tree"], os.path.join(tmp, "tree"))
        ghash, t_ghash, l_ghash = run(["--hash-backend", "gpu", *gpu_args], os.path.join(tmp, "ghash"))
    log(
        f"phase 3: CLI native hash + gpu search marked {len(gpu)} pairs in {t_gpu:.1f} s "
        f"(sweep launches {l_gpu[0]}); CLI tree marked {len(tree)} pairs in {t_tree:.1f} s; "
        f"CLI gpu hash + gpu search marked {len(ghash)} pairs in {t_ghash:.1f} s (sweep "
        f"launches {l_ghash[0]}, pdq_filter launches {l_ghash[1]})"
    )
    if gpu != tree or not gpu or l_gpu[0] == 0:
        raise AssertionError("phase 3: gpu and tree pair sets differ, or are empty")
    if ghash != gpu or l_ghash[0] == 0 or l_ghash[1] == 0:
        raise AssertionError("phase 3: the gpu-hash run differs from the native-hash run")
    phase3_replay()


def phase3_replay() -> None:
    """The JAX package's recorded Hydrus session (tests/fixtures/
    cassette_main.json.zip) replayed through the port's entrypoint.main()
    on the card with hash_backend="gpu": every request must match the
    recording in order, every recorded request must be made, the pair
    count must be the recorded one, and the PDQ kernel must have launched.
    The session's four files are below GPU_ENGINE_MIN_BATCH, so the search
    takes the VP-tree, as in the recording: the device search POSTs each
    pair once, in one batch, where the recorded session POSTs each
    direction alone, so no run of the device search can replay it; the
    CLI runs above hold the sweep."""
    import requests

    from hydrus_video_deduplicator_tpu_torch import entrypoint
    from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
    from tests import cassette
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY

    data = cassette.load_cassette(cassette.CASSETTE_PATH)
    replayer = cassette.Replayer(data["interactions"])
    real = requests.Session.request
    requests.Session.request = lambda self, method, url, **kw: replayer(self, method, url, **kw)
    pdq_filter.LAUNCHES["pdq_filter"] = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_replay_") as tmp:
            pairs = entrypoint.main(
                api_key=DEFAULT_ACCESS_KEY, api_url="http://localhost:45869",  # never contacted
                dedup_database_dir=os.path.join(tmp, "db"), hash_backend="gpu",
            )
    finally:
        requests.Session.request = real
    launches = pdq_filter.LAUNCHES["pdq_filter"]
    log(
        f"phase 3: the recorded session replayed through main(hash_backend='gpu') in "
        f"{time.perf_counter() - t0:.1f} s: {replayer.cursor} of {len(replayer.interactions)} "
        f"requests, {pairs} pairs (recorded {data['pairs']}), pdq_filter launches {launches}"
    )
    replayer.assert_exhausted()
    if pairs != data["pairs"] or launches == 0:
        raise AssertionError("phase 3: the replay's pairs differ, or the PDQ kernel never launched")


def pdq_test_frames(n: int = 512):
    """[n, 512, 512, 3] uint8 frames from numpy seed 11 and the test corpus,
    with the kind of each."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch.decode import extract_frames

    rng = np.random.default_rng(11)
    frames, kinds = [], []

    def add(kind, fs):
        frames.extend(fs)
        kinds.extend([kind] * len(fs))

    videos = os.path.join(ROOT, "tests", "corpus", "videos")
    corpus = []
    for scene in sorted(os.listdir(videos)):
        if not scene.startswith("scene_"):
            continue
        for name in sorted(os.listdir(os.path.join(videos, scene))):
            corpus.extend(list(extract_frames(os.path.join(videos, scene, name)))[:3])
    add("corpus", corpus[:128])
    x = np.linspace(0, 255, 512)
    ramp = np.add.outer(x, x) / 2
    add("smooth", [
        np.stack([np.roll(ramp, 7 * i, axis=i % 2)] * 3, -1).astype(np.uint8) for i in range(48)
    ])
    add("smooth+noise", [
        np.clip(ramp[..., None] + rng.normal(0, 4 + i, (512, 512, 3)), 0, 255).astype(np.uint8)
        for i in range(48)
    ])
    add("constant", [np.full((512, 512, 3), v, np.uint8) for v in rng.integers(1, 255, 24)])
    add("all-0", [np.zeros((512, 512, 3), np.uint8)] * 8)
    add("all-255", [np.full((512, 512, 3), 255, np.uint8)] * 8)
    add("noise", list(rng.integers(0, 256, (n - len(frames), 512, 512, 3), dtype=np.uint8)))
    return np.stack(frames), kinds


def phase4_pdq_kernel_vs_plain(dev):
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch.models import pdq as mpdq
    from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
    from hydrus_video_deduplicator_tpu_torch.vpdq import python_ref

    t0 = time.perf_counter()
    frames, kinds = pdq_test_frames()
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(dev)
    counts = {k: kinds.count(k) for k in dict.fromkeys(kinds)}
    log(f"phase 4 inputs: {x.shape[0]} planar frames {counts}; "
        f"{time.perf_counter() - t0:.1f} s to build")
    got = pdq_filter.pdq_filter_batch(x)
    want = pdq_filter.pdq_filter_batch_plain(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"phase 4: kernel != plain: max abs error {err}")
    words, quality = pdq_filter.pdq_hash_batch_fused(x)
    blobs = mpdq.words_to_blobs(words.cpu().numpy())
    quality = quality.cpu().numpy()
    checked = range(0, x.shape[0], 8)  # 64 frames across every kind
    for i in checked:
        want_blob, want_q = python_ref.pdq_hash_frame(frames[i])
        if blobs[i] != want_blob or int(quality[i]) != want_q:
            raise AssertionError(f"phase 4: frame {i} ({kinds[i]}) hash differs from the oracle")
    plain_words, plain_quality = mpdq.pdq_hash_batch(torch.from_numpy(frames).to(dev))
    if not (torch.equal(plain_words, words) and torch.equal(plain_quality.cpu(), torch.from_numpy(quality))):
        raise AssertionError("phase 4: the fused hash differs from the plain hash")
    ms = cuda_time_ms(lambda: pdq_filter.pdq_filter_batch(x), 20)
    plain_ms = cuda_time_ms(lambda: pdq_filter.pdq_filter_batch_plain(x), 3)
    hash_ms = cuda_time_ms(lambda: pdq_filter.pdq_hash_batch_fused(x), 5)
    log(
        f"phase 4: kernel bit-equal to plain on {x.shape[0]} frames, fused hash == oracle on "
        f"{len(checked)} frames and == plain hash on all; B={x.shape[0]}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, fused hash (kernel + tail) {hash_ms:.4f} ms"
    )
    # the function's float32 adds and multiplies per 8-row band (csrc/pdq_filter.cu):
    # luma (3 multiplies, 2 adds) and rep 1's rows pass (3 adds, 1 multiply)
    # on 7 staged rows, rep 1's cols pass on 4 rows, rep 2's cols pass on 1
    # row and its rows pass at the 64 sites
    band_ops = 5 * 7 * 512 + 4 * 7 * 512 + 4 * 4 * 512 + 4 * 512 + 4 * 64
    # the bytes the function needs: output row k reads frame rows 8k+2 ..
    # 8k+8 below 512 (447 of a frame's 512 rows) of each plane, once; the
    # reciprocals; the output
    read_rows = sum(min(8 * k + 9, 512) - (8 * k + 2) for k in range(64))
    n_bytes = x.shape[0] * 3 * read_rows * 512 * x.element_size() + tensor_bytes(
        mpdq._constants(dev)[0], got
    )
    bound_ms, bound_by = bound(n_bytes, x.shape[0] * 64 * band_ops, FP32_OPS_PER_S)
    rate = n_bytes / (ms / 1e3)
    log(
        f"phase 4: bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.3f}x; the kernel moves "
        f"the {n_bytes} bytes the function needs ({read_rows} rows a frame plane) at "
        f"{rate:.4g} B/s, {100 * rate / HBM_BYTES_PER_S:.1f} % of {HBM_BYTES_PER_S:.4g}"
    )
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def build_stage1_store(n_scenes: int = STAGE1_SCENES):
    """{sha256: MJPG AVI bytes} of n_scenes scenes x 2 versions, with
    (scene, version) per hash."""
    from pathlib import Path

    import numpy as np

    from tests.fake_hydrus import sha256_hex
    from tests.make_corpus import scene_frames, write_avi_mjpg

    def scene(s, workdir):
        frames = scene_frames(1000 + s, STAGE1_SECONDS, STAGE1_DIM, STAGE1_DIM)
        r = np.random.default_rng(7 * 100_000 + s)
        noisy = [
            np.clip(f.astype(np.int16) + r.integers(-6, 6, f.shape), 0, 255).astype(np.uint8)
            for f in frames
        ]
        out = []
        for version, fs in enumerate((frames, noisy)):
            path = Path(workdir) / f"v_{s}_{version}.avi"
            if not write_avi_mjpg(path, fs, fps=1):
                raise RuntimeError("OpenCV cannot write MJPG AVI files here")
            out.append((s, version, path.read_bytes()))
            path.unlink()
        return out

    store, label = {}, {}
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_avi_") as workdir:
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            for videos in pool.map(lambda s: scene(s, workdir), range(n_scenes)):
                for s, version, data in videos:
                    h = sha256_hex(data)
                    store[h], label[h] = data, (s, version)
    if len(store) != 2 * n_scenes:
        raise AssertionError("two generated videos have the same bytes")
    return store, label


def host_frame_split(videos) -> tuple[str, dict[str, float], int]:
    """One decode thread's per-frame ms on this host, step by step, as the
    hasher's decode workers run them: the backend's decode (with its own
    512x512 rescale if it makes one), resize_nearest_512, the planar
    transpose. Every frame is a 1 fps sample here, so each one counts."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch.decode import backends
    from hydrus_video_deduplicator_tpu_torch.decode.frames import resize_nearest_512

    ms = {"decode": 0.0, "resize": 0.0, "transpose": 0.0}
    n, name = 0, ""
    for data in videos:
        backend = backends.choose_backend(data, None)
        name = type(backend).__name__
        frames = backend.decode(data, None)
        while True:
            t0 = time.perf_counter()
            raw = next(frames, None)
            t1 = time.perf_counter()
            if raw is None:
                break
            f = raw[0] if backend.emits_sampled_512 else resize_nearest_512(raw[0])
            t2 = time.perf_counter()
            np.ascontiguousarray(f.transpose(2, 0, 1))
            t3 = time.perf_counter()
            ms["decode"] += t1 - t0
            ms["resize"] += t2 - t1
            ms["transpose"] += t3 - t2
            n += 1
    return name, {k: 1e3 * v / max(n, 1) for k, v in ms.items()}, n


def phase5_stage1(phase: int = 5, n_scenes: int = STAGE1_SCENES, n_sample: int = STAGE1_SAMPLE,
                  mesh=None):
    """Stage 1 of n_scenes x 2 MJPG videos through the orchestrator (phase
    5, and phase 11 with ``mesh``: the orchestrator's _device_mesh returns
    it and the PDQ kernel must launch on every member). Returns the PDQ
    kernel's launches."""
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch import dedup, hashing
    from hydrus_video_deduplicator_tpu_torch.client import HVDClient
    from hydrus_video_deduplicator_tpu_torch.db import DedupeDB
    from hydrus_video_deduplicator_tpu_torch.models.vpdq import GpuVideoHasher
    from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    t0 = time.perf_counter()
    store, label = build_stage1_store(n_scenes)
    mb = sum(map(len, store.values())) / 1e6
    log(f"phase {phase} corpus: {len(store)} MJPG videos ({mb:.1f} MB), "
        f"{time.perf_counter() - t0:.1f} s to build")
    planted = {(s, s) for s in range(n_scenes)}

    def marked(server):
        return {tuple(sorted(label[h][0] for h in pair)) for pair in server.relationships}

    def fresh_run(hash_backend: str, workdir: str):
        server = FakeHydrus(store)
        server.start()
        DedupeDB.set_db_dir(workdir)
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
        deduper = dedup.HydrusVideoDeduplicator(
            db, client=client, hash_backend=hash_backend, search_backend="gpu",
            search_prefilter="auto",
        )
        deduper.threshold = THRESHOLD
        return server, db, deduper

    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_s1_") as workdir:
        server, db, deduper = fresh_run("gpu", os.path.join(workdir, "gpu"))
        try:
            queued: dict[str, bytes] = {}
            add_to_queue = db.add_to_phashed_files_queue

            def record(file_hash, phash):
                queued[file_hash] = phash
                return add_to_queue(file_hash, phash)

            db.add_to_phashed_files_queue = record
            stage1: dict = {}
            add_hashes = deduper.add_perceptual_hashes_to_db

            def timed_stage1(video_hashes):
                t = time.perf_counter()
                stats = add_hashes(video_hashes)
                torch.cuda.synchronize()
                stage1["seconds"], stage1["stats"] = time.perf_counter() - t, stats
                return stats

            deduper.add_perceptual_hashes_to_db = timed_stage1
            timers, hashers = StageTimers(), []
            timers.wrap_kernel(pdq_filter, "pdq_filter_batch")
            timers.capture(GpuVideoHasher, "hash_videos", hashers)
            per_member = None
            if mesh is not None:
                timers.patch(dedup.HydrusVideoDeduplicator, "_device_mesh", lambda self: mesh)
                per_member = timers.count_members(
                    mesh, pdq_filter, "pdq_filter_batch", pdq_filter.LAUNCHES, "pdq_filter"
                )
            for name in seg.LAUNCHES:
                seg.LAUNCHES[name] = 0
            pdq_filter.LAUNCHES["pdq_filter"] = 0
            t0 = time.perf_counter()
            try:
                pairs = deduper.deduplicate(skip_hashing=False)
            finally:
                timers.restore()
            t_all = time.perf_counter() - t0
            launches = pdq_filter.LAUNCHES["pdq_filter"]
            sims = seg.LAUNCHES["similarity_segments"]
            sweeps = seg.LAUNCHES["exists_mask_sweep"]

            stats = stage1["stats"]
            failed = stats.failed_from_api_errors_count + stats.failed_from_phash_count
            n_files = db.execute("SELECT count(*) FROM files").fetchone()[0]
            hs = hashers[0].stats
            sec = stage1["seconds"]
            STAGE1_S[phase] = sec, hs["frames"]
            log(
                f"phase {phase}: stage 1 hashed {stats.success_hash_count} videos, {failed} failed, "
                f"{hs['frames']} frames in {hs['batches']} device batches; files in the "
                f"database {n_files}; pdq_filter launches {launches}, similarity_segments "
                f"launches {sims}, sweep launches {sweeps}"
            )
            log(
                f"phase {phase} stage 1: {sec:.3f} s, {hs['frames'] / sec:.1f} hashed frames/s; "
                f"kernel device time {timers.kernel_ms('pdq_filter_batch'):.3f} ms over "
                f"{timers.launches('pdq_filter_batch')} "
                f"launches; {hs['hash_s']:.3f} s inside the hasher, whose batch loop waited "
                f"{hs['decode_wait_s']:.3f} s on decode ({100 * hs['decode_wait_s'] / sec:.1f} % "
                f"of stage 1) and {hs['device_wait_s']:.3f} s on the device "
                f"({100 * hs['device_wait_s'] / sec:.1f} %); whole deduplicate() {t_all:.3f} s"
            )
            if failed or stats.success_hash_count != len(store) or n_files != len(store):
                raise AssertionError(f"phase {phase}: a file failed to hash or was not stored")
            if launches == 0:
                raise AssertionError(f"phase {phase}: the PDQ filter kernel never launched")
            if per_member is not None:
                ms = timers.member_ms("pdq_filter_batch")
                log(f"phase {phase}   pdq_filter per member of {mesh}: launches {per_member}, "
                    "device ms " + ", ".join(f"{x:.3f}" for x in ms))
                if not all(per_member):
                    raise AssertionError(f"phase {phase}: pdq_filter never launched on some member")
            if sims == 0:
                raise AssertionError(
                    f"phase {phase}: the segment similarity kernel never launched (did auto prune?)"
                )

            sample = sorted(np.random.default_rng(3).choice(sorted(store), n_sample, replace=False))
            t0 = time.perf_counter()
            with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
                refs = list(pool.map(lambda h: hashing.compute_phash(store[h], 1).bytes, sample))
            bad = [h for h, ref in zip(sample, refs) if queued[h] != ref]
            log(f"phase {phase}: {len(sample)} sampled queued hashes vs compute_phash: {len(bad)} "
                f"differ ({time.perf_counter() - t0:.1f} s)")
            if bad:
                raise AssertionError(
                    f"phase {phase}: {len(bad)} queued hashes differ from compute_phash"
                )
            backend, split, n_split = host_frame_split([store[h] for h in sample[:50]])
            log(f"phase {phase} host split, one thread, {n_split} frames of {STAGE1_DIM}x{STAGE1_DIM} "
                f"MJPG ({backend}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                + " per frame")

            got = marked(server)
            if got == planted and pairs == len(planted):
                held = "the planted set"
            else:  # the synthetic scenes match each other: hold to native hashing
                n_server, n_db, n_deduper = fresh_run("native", os.path.join(workdir, "native"))
                try:
                    n_deduper.deduplicate(skip_hashing=False)
                    native = marked(n_server)
                finally:
                    n_server.stop()
                    n_db.close()
                held = "the native-hash run's set"
                if got != native:
                    raise AssertionError(
                        f"phase {phase}: marked {len(got)} pairs; planted {len(planted)}, native "
                        f"{len(native)}: neither equal"
                    )
            log(f"phase {phase}: marked {len(got)} pairs, reported {pairs}; equal to {held} "
                f"(missing from planted {len(planted - got)}, extras {len(got - planted)})")

            server.requests_seen.clear()
            t0 = time.perf_counter()
            pairs2 = deduper.deduplicate(skip_hashing=False)
            fetched = server.requests_seen.count("/get_files/file")
            log(f"phase {phase} re-run: {time.perf_counter() - t0:.3f} s, marked {pairs2}, "
                f"fetched {fetched} files")
            if pairs2 != 0 or fetched:
                raise AssertionError(f"phase {phase}: the re-run fetched files or marked pairs")
        finally:
            server.stop()
            db.close()
    return launches


def sorted_hits(hits, n_cols: int):
    """(hit count, records sorted by row then column) of a kernel 3 hit
    list, its records those it holds."""
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

    n = int(seg.hit_count(hits))
    records = hits[1 : 1 + min(n, hits.shape[0] - 1)].to(torch.int64)
    return n, records[torch.argsort(records[:, 0] * n_cols + records[:, 1])]


def short_list_holds_its_capacity(sims_args, plain_hits, dev) -> None:
    """Kernel 3 at min_sim 1 with a hit list of half the hits' capacity, a
    prefix of a larger list of sentinels: the count is every hit, the
    records are distinct hits of the plain list (plain_hits, which holds
    them all), and no record past the capacity is written."""
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

    n_hits = int(seg.hit_count(plain_hits))
    capacity = n_hits // 2
    sentinel = -7
    room = seg.hit_list(n_hits, dev).fill_(sentinel)
    mask = seg.similarity_segments(*sims_args, 1, room[: capacity + 1])
    n, records = sorted_hits(room[: capacity + 1], mask.shape[1])
    held = set(map(tuple, records.tolist()))
    want = set(map(tuple, sorted_hits(plain_hits, mask.shape[1])[1].tolist()))
    if n != n_hits or len(held) != capacity or not held <= want:
        raise AssertionError(
            f"phase 6 short list: count {n} of {n_hits} hits, {len(held)} distinct records of "
            f"{capacity}, {len(held - want)} not hits of the plain list"
        )
    if not bool((room[capacity + 1 :] == sentinel).all()):
        raise AssertionError(f"phase 6 short list: records written past the capacity {capacity}")
    log(f"phase 6 short list: capacity {capacity} of {n_hits} hits at min_sim 1: count exact, "
        f"{capacity} distinct plain hits held, nothing written past the capacity")


def phase6_similarity_vs_plain(blobs, dev):
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    t0 = time.perf_counter()
    columns = engine.seg_columns(engine.CorpusIndex(blobs))
    cols = engine.GpuSearchEngine(device=dev)._stage_columns(columns)
    # the first and the last videos in staging order: the first and the
    # last column steps hold a dense self-diagonal
    ends = [columns.indices[:300], columns.indices[-300:]]
    first, last = (
        seg.pack_blocks([(int(i), blobs[i]) for i in e], seg.ROW_FRAMES, seg.ROW_SLOTS) for e in ends
    )
    packed, slot_a, counts_a, _ = seg.stack_blocks(
        [first[0], last[-1]], 2, seg.ROW_FRAMES, seg.ROW_SLOTS
    )
    a_words = ops_sim.to_words(packed, dev)
    a_words[5] = 0  # a real row frame with every bit clear
    slot_a = torch.from_numpy(slot_a).to(dev)
    counts_a = torch.from_numpy(counts_a.reshape(-1)).to(dev)
    b_words = cols["words"].clone()
    b_words[7] = 0  # a real column frame with every bit clear
    slot_b, counts_b, n_steps = cols["slots"], cols["counts"], cols["n_steps"]
    valid = torch.ones(n_steps, dtype=torch.int32, device=dev)
    valid[3::7] = 0
    valid[-2:] = 1
    n_pad = int((slot_b < 0).sum())
    n_empty = int((counts_a == 0).sum()) + int((counts_b == 0).sum())
    log(
        f"phase 6 inputs: {n_steps} column steps ({b_words.shape[0]} frames, {n_pad} padding), "
        f"2 row blocks, {int((valid == 0).sum())} invalid steps, {n_empty} empty slots; "
        f"{time.perf_counter() - t0:.1f} s to build"
    )
    staged = int((torch.from_numpy(cols["smaps"]) >= 0).sum())
    assert staged == len(columns.indices) and n_steps >= 2
    assert n_pad > 0 and n_empty > 0 and int(slot_a[5]) >= 0
    sims_args = (a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid)
    sweep_args = (a_words, slot_a, b_words, slot_b)
    # the unpruned route's form: the mask with a hit list, the kernel's and
    # the plain version's each of the plain count's capacity
    lists = {}  # label -> (the kernel's hit list, the plain version's)
    for min_sim in (75, 1):
        probe = seg.hit_list(0, dev)
        seg.similarity_mask_plain(*sims_args, min_sim, probe)
        n_hits = int(seg.hit_count(probe))
        lists[f"mask {min_sim} + list"] = (seg.hit_list(n_hits, dev), seg.hit_list(n_hits, dev))
    cases = {  # label -> (kernel call, plain call)
        "sims": (
            lambda: seg.similarity_segments(*sims_args),
            lambda: seg.similarity_segments_plain(*sims_args),
        ),
        "mask 75 + list": (
            lambda: seg.similarity_segments(*sims_args, 75, lists["mask 75 + list"][0]),
            lambda: seg.similarity_mask_plain(*sims_args, 75, lists["mask 75 + list"][1]),
        ),
        "mask 1 + list": (
            lambda: seg.similarity_segments(*sims_args, 1, lists["mask 1 + list"][0]),
            lambda: seg.similarity_mask_plain(*sims_args, 1, lists["mask 1 + list"][1]),
        ),
        "mask 75": (
            lambda: seg.similarity_segments(*sims_args, 75),
            lambda: seg.similarity_mask_plain(*sims_args, 75),
        ),
        "mask 1": (
            lambda: seg.similarity_segments(*sims_args, 1),
            lambda: seg.similarity_mask_plain(*sims_args, 1),
        ),
        "counts 31": (
            lambda: seg.exists_counts(a_words, slot_a, b_words, slot_b, valid, 31),
            lambda: seg.exists_counts_plain(a_words, slot_a, b_words, slot_b, valid, 31),
        ),
        "counts 79": (
            lambda: seg.exists_counts(a_words, slot_a, b_words, slot_b, valid, 79),
            lambda: seg.exists_counts_plain(a_words, slot_a, b_words, slot_b, valid, 79),
        ),
        "every-step sweep 79": (
            lambda: seg.exists_mask_kernel(*sweep_args, 79),
            lambda: seg.exists_mask_kernel_plain(*sweep_args, 79),
        ),
    }
    every_step = torch.ones_like(valid)
    result = {}
    for label, (kernel, plain) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        n_nonzero = int((want != 0).sum())
        if not torch.equal(got, want):
            raise AssertionError(f"phase 6 {label}: kernel != plain: max abs error {err}")
        if n_nonzero == 0:
            raise AssertionError(f"phase 6 {label}: the plain version found nothing")
        written = ()  # the hit list's header and records, as the kernel writes them
        if label in lists:
            (n_got, got_records), (n_want, want_records) = (
                sorted_hits(h, got.shape[1]) for h in lists[label]
            )
            if n_got != n_want or not torch.equal(got_records, want_records):
                raise AssertionError(
                    f"phase 6 {label}: the kernel's hit list != plain: {n_got} hits, plain {n_want}"
                )
            written = (lists[label][0][: n_got + 1],)
        if label.startswith("every-step"):
            inputs, steps = sweep_args, every_step
        elif label.startswith("counts"):
            inputs, steps = (a_words, slot_a, b_words, slot_b, valid), valid
        else:
            inputs, steps = sims_args, valid
        pairs = segment_frame_pairs(slot_a, slot_b, steps)
        bound_ms, bound_by, int8_ms = hamming_bound(pairs, *inputs, got, *written)
        del got, want
        ms = cuda_time_ms(kernel, 10)
        plain_ms = cuda_time_ms(plain, 1, warmup=0)  # the check above warmed it
        log(
            f"phase 6 {label}: bit-equal ({n_nonzero} nonzero outputs); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call; {pairs} real frame pairs, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {int8_ms:.4f} ms at the int8 rate)"
        )
        result[label] = {
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    short_list_holds_its_capacity(sims_args, lists["mask 1 + list"][1], dev)
    report_work(
        "6 (mask 75 + list)", a_words, slot_a, b_words, slot_b, valid,
        result["mask 75 + list"]["ms"],
    )
    report_work(
        "6 (every-step sweep 79)", a_words, slot_a, b_words, slot_b, every_step,
        result["every-step sweep 79"]["ms"],
    )
    return result


def phase8_block_vs_plain(blobs, dev):
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
    from hydrus_video_deduplicator_tpu_torch.dedup import HydrusVideoDeduplicator as D
    from hydrus_video_deduplicator_tpu_torch.parallel import engine

    t0 = time.perf_counter()
    index = engine.CorpusIndex(blobs)
    # rows of one launch: the long videos of the first checkpoint chunk, as
    # the orchestrator sizes its chunks
    chunk_rows = max(D.SEARCH_CHECKPOINT_ROWS, -(-len(blobs) // D.SEARCH_MAX_CHUNKS))

    def tile(pad: int, first_chunk: bool):
        """(words, counts) of bucket ``pad``, as the route stages it (only
        the first checkpoint chunk's videos for a row tile), with the edge
        cases: an empty video, counts of 1, pad - 1 and pad (frames past
        the real count then hold zero words), a real all-zero frame."""
        if pad == 1:  # the library holds few one-frame videos: take 1-frame clips
            idx = np.arange(chunk_rows)
            frames = np.stack([ops_sim.blobs_to_packed(blobs[i][:32] or bytes(32)) for i in idx])
            counts = np.ones(len(idx), dtype=np.int32)
        else:
            idx, frames, counts = index.bucket_arrays(pad)
        if first_chunk:
            frames, counts = frames[idx < chunk_rows], counts[idx < chunk_rows]
        frames, counts = frames.copy(), counts.copy()
        for k, c in enumerate([0, 1, pad - 1, pad][: len(counts)]):
            counts[k] = c
        if len(counts) > 4:
            frames[4, 0] = 0
        return ops_sim.to_words(frames, dev), torch.from_numpy(counts).to(dev)

    long_rows, long_cols = tile(1024, True), tile(1024, False)
    cases = {f"1024 x {pb}": (long_rows, tile(pb, False), 1024, pb) for pb in (1, 64, 512)}
    cases["1024 x 1024"] = (long_rows, long_cols, 1024, 1024)
    cases["64 x 1024"] = (tile(64, True), long_cols, 64, 1024)
    log(
        "phase 8 inputs (row videos x column videos): "
        + ", ".join(f"{k}: {len(r[1])} x {len(c[1])}" for k, (r, c, _, _) in cases.items())
        + f"; {time.perf_counter() - t0:.1f} s to build"
    )
    result = {}
    for label, ((rw, rc), (cw, cc), pa, pb) in cases.items():
        args = (rw, rc, cw, cc, pa, pb)
        got = sb.similarity_block(*args)
        want = sb.similarity_block_plain(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"phase 8 {label}: kernel != plain: max abs error {err}")
        n_nonzero, n_100 = int((want != 0).sum()), int((want == 100).sum())
        if n_nonzero == 0 or (pa == pb and n_100 == 0):
            raise AssertionError(f"phase 8 {label}: the plain version found too little")
        pairs = int(rc.clamp(0, pa).to(torch.int64).sum()) * int(
            cc.clamp(0, pb).to(torch.int64).sum()
        )
        bound_ms, bound_by, int8_ms = hamming_bound(pairs, rw, rc, cw, cc, got)
        del got, want
        ms = cuda_time_ms(lambda: sb.similarity_block(*args), 10)
        plain_ms = cuda_time_ms(lambda: sb.similarity_block_plain(*args), 1, warmup=0)
        real_a = torch.arange(pa, device=dev)[None, :] < rc[:, None]
        real_b = torch.arange(pb, device=dev)[None, :] < cc[:, None]
        yard_ms, _ = int_mm_yardstick(
            ops_sim.unpack_pm1(rw[real_a]), ops_sim.unpack_pm1(cw[real_b])
        )
        log(
            f"phase 8 {label}: bit-equal ({n_nonzero} nonzero, {n_100} at 100); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms per call; {pairs} real frame pairs, "
            f"{pairs / (ms / 1e3):.4g} per s, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{int8_ms:.4f} ms at the int8 rate); real frames "
            f"{float(real_b.float().mean()):.4f} of the column pads; "
            f"yardstick torch._int_mm over the same real frames {yard_ms:.4f} ms, "
            f"{pairs / (yard_ms / 1e3):.4g} pairs/s"
        )
        result[label] = {
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    return result


def traced(fn, *args, **kwargs):
    """fn(*args, **kwargs) inside the port's trace_to; logs the share of
    the traced window in which a CUDA kernel ran, and returns fn's result."""
    from hydrus_video_deduplicator_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_trace_") as log_dir:
        t0 = time.perf_counter()
        with profiling.trace_to(log_dir):
            out = fn(*args, **kwargs)
        t_traced = time.perf_counter() - t0
        trace = os.path.join(log_dir, profiling.TRACE_FILE)
        mb = os.path.getsize(trace) / 1e6
        busy, window, kernels = profiling.device_busy_share(trace)
    log(
        f"traced {fn.__name__}: {kernels} CUDA kernels busy {busy:.3f} s of a {window:.3f} s "
        f"traced window: busy share {100 * busy / max(window, 1e-9):.2f} %, idle "
        f"{100 * (1 - busy / max(window, 1e-9)):.2f} % ({t_traced:.3f} s with the trace's "
        f"export, {mb:.1f} MB)"
    )
    return out


def vit_params(seed: int, pixel_identity: bool = False) -> dict:
    """ViT-B/32's shape from make_synthetic_params: random weights (every
    kernel and the projection redrawn with variance 1 / fan-in, so that
    the embedding follows the frame's content through every layer) with
    CLIP's pre-layernorm and quick_gelu, or the pixel-identity tower."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch.models import embed

    rng = np.random.default_rng(seed)
    params = embed.make_synthetic_params(rng, pixel_identity=pixel_identity, **VIT_B32)
    if not pixel_identity:
        for k, v in params.items():
            if k.endswith("kernel") or k == "proj":
                fan_in = int(np.prod(v.shape[:-1]))
                params[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
        width = VIT_B32["width"]
        params["pre_ln/scale"] = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        params["pre_ln/bias"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
    params["act"] = np.asarray("quick_gelu")
    return params


def vit_flops(params: dict, frames: int) -> int:
    """The tower's matmul operations (a multiply-add is two) for ``frames``
    frames, from its shapes: patch embedding, every block's qkv, logits,
    weighted sum, output and MLP, and the projection."""
    p, d = params["patch_embed/kernel"].shape[0], params["cls_token"].shape[0]
    img, hidden = int(params["image_size"]), params["blocks.0.mlp/fc1_kernel"].shape[1]
    n = (img // p) ** 2
    t = n + 1
    per_block = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * hidden
    layers = sum(1 for k in params if k.endswith("mlp/fc1_kernel"))
    per_frame = 2 * n * p * p * 3 * d + layers * per_block + 2 * d * params["proj"].shape[1]
    return frames * per_frame


def phase10_tower(dev) -> None:
    """The tower on the card against the tower on the CPU at ViT-B/32's
    shape, random weights, one video of RERANK_FRAMES frames; timed with
    the port's device_timer (CUDA events)."""
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch.models import embed
    from hydrus_video_deduplicator_tpu_torch.utils import device_timer

    params = vit_params(10)
    rng = np.random.default_rng(10)
    blocks = rng.integers(0, 256, (RERANK_FRAMES, 16, 16, 3), dtype=np.uint8)
    frames = np.repeat(np.repeat(blocks, 32, 1), 32, 2)  # 512 x 512 x 3
    card = embed.embedder_from_params(params, dev)
    if not all(t.device == dev for t in card.params.values()):
        raise AssertionError("phase 10: the tower's parameters are not on the card")
    got = card.embed_frames(frames)
    t0 = time.perf_counter()
    want = embed.embedder_from_params(params, "cpu").embed_frames(frames)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    a, b = np.arange(0, 2 * RERANK_FRAME_PAIRS, 2), np.arange(1, 2 * RERANK_FRAME_PAIRS, 2)
    cos_card, cos_cpu = (got[a] * got[b]).sum(1), (want[a] * want[b]).sum(1)
    cos_err = float(np.abs(cos_card - cos_cpu).max())
    x = torch.from_numpy(frames).to(dev)
    with torch.inference_mode():
        sec = device_timer(lambda i: card.forward(x), iters=20, warmup=3)
    flops = vit_flops(params, RERANK_FRAMES)
    log(
        f"phase 10 tower (ViT-B/32: width 768, 12 layers, 12 heads, patch 32, 224, 512, "
        f"quick_gelu, pre_ln; random weights): card vs CPU on {RERANK_FRAMES} frames max abs "
        f"error {err:.3e}, cosine of {RERANK_FRAME_PAIRS} frame pairs {cos_err:.3e} (tolerance "
        f"{TOWER_TOL}; cosines {cos_cpu.min():.4f}..{cos_cpu.max():.4f}); card "
        f"{1e3 * sec:.4f} ms a {RERANK_FRAMES}-frame video (device_timer, CUDA events, uint8 "
        f"frames on the card), {RERANK_FRAMES / sec:.1f} frames/s, {flops / 1e9:.3f} GFLOP "
        f"of matmuls, {flops / sec / 1e12:.3f} TFLOP/s float32 ({100 * flops / sec / FP32_OPS_PER_S:.1f} "
        f"% of 67 TFLOP/s); CPU {t_cpu:.3f} s; {card_line()}"
    )
    if err > TOWER_TOL or cos_err > TOWER_TOL:
        raise AssertionError(f"phase 10: the tower on the card differs from the CPU: {err}, {cos_err}")


def phase10_rerank(device=None) -> None:
    """deduplicate() with rerank="clip" on RERANK_SCENES scenes of the
    phase-5 generator, the GPU hasher and the GPU search, pixel-identity
    weights at ViT-B/32's shape: at 0.6 the planted pairs are marked, at
    1.01 (the same database, its search cache cleared, the same gate) none;
    the PDQ and segment kernels launched and the tower sits on the card."""
    import numpy as np

    from hydrus_video_deduplicator_tpu_torch import dedup
    from hydrus_video_deduplicator_tpu_torch.client import HVDClient
    from hydrus_video_deduplicator_tpu_torch.db import DedupeDB
    from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
    from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    store, label = build_stage1_store(RERANK_SCENES)
    planted = {(s, s) for s in range(RERANK_SCENES)}
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_rerank_") as workdir:
        weights = os.path.join(workdir, "vit_b32.npz")
        np.savez(weights, **vit_params(11, pixel_identity=True))
        server = FakeHydrus(store)
        server.start()
        try:
            DedupeDB.set_db_dir(workdir)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            deduper = dedup.HydrusVideoDeduplicator(
                db, client=client, hash_backend="gpu", search_backend="gpu",
                rerank="clip", rerank_weights=weights, rerank_threshold=0.6, device=device,
            )
            deduper.threshold = THRESHOLD
            rr = deduper.reranker
            on = rr.embedder.device
            if (device is None and on.type != "cuda") or any(
                t.device != on for t in rr.embedder.params.values()
            ):
                raise AssertionError("phase 10: the tower's parameters are not on the card")
            for counter in (seg.LAUNCHES, pdq_filter.LAUNCHES):
                for name in counter:
                    counter[name] = 0
            t0 = time.perf_counter()
            pairs = deduper.deduplicate(skip_hashing=False)
            t_run = time.perf_counter() - t0
            launches = {**pdq_filter.LAUNCHES, **seg.LAUNCHES}
            got = {tuple(sorted(label[h][0] for h in pair)) for pair in server.relationships}
            log(
                f"phase 10 rerank 0.6: {len(store)} MJPG videos, deduplicate() {t_run:.3f} s; "
                f"marked {len(got)} pairs (planted {len(planted)}), reported {pairs}; gate "
                f"rejected {rr.pairs_rejected} of {rr.pairs_checked}; {len(rr._cache)} videos "
                f"embedded; kernel launches {launches}"
            )
            if got != planted or pairs != len(planted):
                raise AssertionError("phase 10: the marked pairs differ from the planted set")
            if not launches["pdq_filter"] or not launches["similarity_segments"]:
                raise AssertionError("phase 10: the PDQ or the segment kernel never launched")
            if not rr.pairs_checked:
                raise AssertionError("phase 10: the gate saw no pair")
            rr.threshold, rr.pairs_checked, rr.pairs_rejected = 1.01, 0, 0
            db.begin_transaction()
            with db.conn:
                db.clear_search_cache()
            n_marked = len(server.relationships)
            t0 = time.perf_counter()
            pairs2 = deduper.deduplicate(skip_hashing=True)
            log(
                f"phase 10 rerank 1.01: {time.perf_counter() - t0:.3f} s, reported {pairs2}, "
                f"gate rejected {rr.pairs_rejected} of {rr.pairs_checked}"
            )
            if pairs2 or len(server.relationships) != n_marked:
                raise AssertionError("phase 10: the gate at 1.01 let a pair through")
            if rr.pairs_rejected != rr.pairs_checked or not rr.pairs_checked:
                raise AssertionError("phase 10: at 1.01 the gate did not reject every pair")
            db.close()
        finally:
            server.stop()


def phase11_choose_mesh():
    """(mesh, how): one member per card where several are visible, else
    MESH_MEMBERS_ON_ONE_CARD members sharing the one card."""
    import torch

    from hydrus_video_deduplicator_tpu_torch.parallel import mesh as mesh_mod

    if torch.cuda.device_count() > 1:
        return mesh_mod.build_mesh(), "one member per card"
    members = [torch.device("cuda", 0)] * MESH_MEMBERS_ON_ONE_CARD
    return mesh_mod.Mesh(members), "members sharing the one card, each on a stream of its own"


def phase11_dryrun(mesh=None) -> dict:
    """``parallel.dryrun.dryrun_multidevice`` on ``mesh`` (default
    phase11_choose_mesh's): stages 1-7 each equal to one device, stage 5
    on the layout the dry run builds (each device twice, device-major);
    it raises on a difference. Logs and returns the dry run's summary."""
    from hydrus_video_deduplicator_tpu_torch.parallel import dryrun
    from tests.fake_hydrus import FakeHydrus

    mesh = mesh or phase11_choose_mesh()[0]
    t0 = time.perf_counter()
    summary = dryrun.dryrun_multidevice(mesh, FakeHydrus)
    log(f"phase 11 dry run on {mesh}: {time.perf_counter() - t0:.3f} s, every stage equal to one "
        f"device: {summary}")
    return summary


#: mesh_turns' and mesh_rehearsal's stage-4 runs in order: one card, the
#: mesh, the mesh, one card
MESH_TURNS = ("one", "mesh", "mesh", "one")

#: the parts of a stage-4 turn that stage4_turns prints, by the label of
#: search_timers' stage they are read from
TURN_PARTS = {
    "clustering": "host clustering (reps)",
    "staging": "column staging",
    "route": "segment route (launches + drain)",
    "verify": "stage B (verify)",
}


def turn_split(split: dict, stage4_s: float) -> dict:
    """A stage-4 run's seconds by part: TURN_PARTS from search_timers'
    ``split`` (label -> s), the other timed stages, and the rest, which no
    timer covered (SQLite, the marking, what lies outside the chunks)."""
    parts = {part: split.get(label, 0.0) for part, label in TURN_PARTS.items()}
    parts["other timed stages"] = sum(split.values()) - sum(parts.values())
    parts["rest"] = stage4_s - sum(split.values())
    return parts


def turn_meshes():
    """({"one": a one-member mesh on cuda:0, "mesh": phase11_choose_mesh's},
    how the mesh was chosen). With several cards visible the orchestrator's
    own choice is the mesh, so "one card" has to be a mesh of one."""
    import torch

    from hydrus_video_deduplicator_tpu_torch.parallel.mesh import Mesh

    mesh, how = phase11_choose_mesh()
    return {"one": Mesh([torch.device("cuda", 0)]), "mesh": mesh}, how


def stage4_turns(
    phase, n: int, lib, kernels: set, saved: str, meshes: dict,
    workdir: str | None = None, timing: bool = False, **kwargs
) -> list[dict]:
    """Stage 4 of an n-video library once per turn of MESH_TURNS, each
    from a copy of ``saved`` (its database after stage 2) on
    ``meshes[turn]``, held as stage4_orchestrator holds a run: the planted
    set (lib = (expected, empty hashes, min_sim)), the cache fully marked,
    a re-run marking 0, every kernel of ``kernels`` launched on every
    member. Each turn prints its stage-4 seconds, their split
    (``turn_split``), the drain's fetch and host seconds, each member's
    launches and device ms, and each card's device memory peak; with
    ``timing`` also the HVD_DEBUG_TIMING lines, checked and split by
    stage4_split. Returns one dict a turn (stage4_orchestrator's ``after``
    seconds, with "turn" and "peak GB")."""
    import torch

    cards = range(torch.cuda.device_count())
    out = []
    for k, turn in enumerate(MESH_TURNS, 1):
        name = f"{phase} turn {k} {turn}"
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        seconds: dict = {"turn": turn}
        with debug_timing_run() if timing else contextlib.nullcontext() as seen:
            stage4_orchestrator(
                name, range(n), *lib, kernels, mesh=meshes[turn], from_db=saved,
                after=lambda *a: seconds.update(a[-1]), workdir=workdir, **kwargs,
            )
        if timing:
            stage4_split(name, seen, n, seconds["stage 4"])
        seconds["peak GB"] = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
        parts = turn_split(seconds["split"], seconds["stage 4"])
        fetch, host, tiles = seconds["drain"]
        members = "; ".join(
            f"{kernel} launches {counts}, device ms [" + ", ".join(f"{x:.3f}" for x in ms) + "]"
            for kernel, (counts, ms) in sorted(seconds["members"].items())
        )
        log(
            f"{name} on {meshes[turn]}: stage 4 {seconds['stage 4']:.3f} s: "
            + ", ".join(f"{label} {sec:.3f}" for label, sec in parts.items())
            + f"; drain fetch {fetch:.3f} s, host {host:.3f} s over {tiles} row tiles; "
            f"{members}; device peak GB per card "
            + ", ".join(f"{x:.3f}" for x in seconds["peak GB"])
        )
        out.append(seconds)
    return out


def mesh_turns() -> None:
    """Phase 11's mesh against one device in turns (MESH_TURNS: one, mesh,
    mesh, one): stage 4 of phase 2's library (auto) and of phase 9's
    N_NONE library (none), each turn from a copy of its library's database
    after one stage 2 (``stage4_turns``), then stage 1 of phase 10's 400
    videos as phase 5 runs it (the hasher's decode wait, device wait and
    hash seconds, and the PDQ kernel's launches and device ms per member).
    "One device" is a one-member mesh on cuda:0 (``turn_meshes``). Not
    part of main()."""
    phase0_build()
    meshes, how = turn_meshes()
    log(f"turns: {meshes['one']} against {meshes['mesh']} ({how}); cards: "
        + "; ".join(card_lines()))
    lib2 = build_library(N_VIDEOS)
    lib_none = build_library(N_NONE, LONG_CLIP, LONG_PLANTS["none"])
    runs = (
        (lib2, {"exists_mask_sweep"}, "auto"),
        (lib_none, {"similarity_segments", "similarity_block"}, "none"),
    )
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_turns_") as kept:
        for lib, kernels, prefilter in runs:
            saved = os.path.join(kept, f"{prefilter}.sqlite")
            stage4_orchestrator(
                11, *lib, kernels, save_db=saved, search=False, search_prefilter=prefilter
            )
            done = stage4_turns(
                f"11 {prefilter}", len(lib[0]), lib[1:], kernels, saved, meshes,
                search_prefilter=prefilter,
            )
            log(f"turns stage 4 {prefilter} N={len(lib[0])}: " + ", ".join(
                f"{t['turn']} {t['stage 4']:.3f} s" for t in done
            ))
    for label in MESH_TURNS:
        phase5_stage1(11, RERANK_SCENES, MESH_STAGE1_SAMPLE, mesh=meshes[label])
        sec, frames = STAGE1_S[11]
        log(f"turns stage 1 {label}: {sec:.3f} s, {frames / sec:.1f} hashed frames/s")
    log("turns done; cards: " + "; ".join(card_lines()))


def mesh_rehearsal(
    n: int, median: float = 48.0, clip: int = 512, long_plants=(0, 0, 0),
    workdir: str | None = None, timing: bool = False,
) -> list[dict]:
    """The fresh-library rehearsal (``fresh_rehearsal``'s library) on the
    mesh against one card, in turns: it raises before building anything
    unless ``workdir`` (default: tempfile's) has FRESH_BYTES_PER_FRAME
    bytes free for each frame of two databases (the saved one and a
    turn's copy); builds the library and runs stage 2 and the maintenance
    once (``stage4_orchestrator(..., save_db=, search=False)``, the blobs
    dropped once queued), saving the database in a temporary directory of
    its own under ``workdir``; after one small warm-up run on each mesh
    (every card's context and kernels loaded, the first deduplicate() of
    the process done), runs stage 4 with search_prefilter="auto" once per
    turn of MESH_TURNS (one card, mesh, mesh, one card), each from a copy
    of that database (``stage4_turns``; "mesh" is phase11_choose_mesh's,
    one member per card where several are visible). It raises unless
    every turn marks the planted set, leaves the cache fully marked, a
    re-run marks 0, and every kernel of the route (the sweep and, with
    clip above 512, kernel 5) launched on every member and no other
    search kernel. Each turn prints its seconds, split, drain and
    per-member kernels (``stage4_turns``); with ``timing``, its
    HVD_DEBUG_TIMING lines too. It ends with one SUMMARY line: each turn's
    stage-4 seconds, the mesh's mean over one card's, and every card's
    name and power limit. Returns stage4_turns' dicts. Not part of
    main()."""
    import torch

    from hydrus_video_deduplicator_tpu_torch import scene_library as sl

    if not torch.cuda.is_available():
        raise RuntimeError("mesh_rehearsal: CUDA is not available")
    workdir = workdir or tempfile.gettempdir()
    frames, need, free = check_free_space("mesh_rehearsal", n, clip, median, workdir, databases=2)
    log(
        f"mesh rehearsal: N={n}, median {median:g}, clip {clip}, long plants {long_plants}: "
        f"{frames} frames, {need / 1e9:.2f} GB asked for two databases, {free / 1e9:.2f} GB free "
        f"under {workdir}; {os.cpu_count()} host cores"
    )
    blobs, pairs, n_empty, min_sim = build_library(n, clip, long_plants, median)
    with tempfile.TemporaryDirectory(prefix="hvd_mesh_rehearsal_", dir=workdir) as kept:
        saved = os.path.join(kept, "stage2.sqlite")
        stage4_orchestrator(
            "mesh", blobs, pairs, n_empty, min_sim, set(), save_db=saved, search=False,
            workdir=kept, release_blobs=True, search_prefilter="auto",
        )
        db_gb = os.path.getsize(saved) / 1e9
        meshes, how = turn_meshes()
        log(
            f"mesh rehearsal: from {saved} ({db_gb:.2f} GB); turns {', '.join(MESH_TURNS)}: "
            f"{meshes['one']} and {meshes['mesh']} ({how}); cards: " + "; ".join(card_lines())
        )
        phase0_build()
        kernels = {"exists_mask_sweep"}
        if clip > sl.SEG_MAX_FRAMES:
            kernels.add("similarity_block")
        warm = build_library(2_000, median=median)
        for label, mesh in meshes.items():
            stage4_orchestrator(
                f"mesh warm-up {label}", *warm, {"exists_mask_sweep"}, mesh=mesh,
                workdir=kept, search_prefilter="auto",
            )
        done = stage4_turns(
            "mesh", n, (pairs, n_empty, min_sim), kernels, saved, meshes, workdir=kept,
            timing=timing, search_prefilter="auto",
        )
    mean = {
        label: sum(t["stage 4"] for t in done if t["turn"] == label) / MESH_TURNS.count(label)
        for label in meshes
    }
    log(
        f"SUMMARY: mesh rehearsal, {n}-video library (scene profile, median {median:g}, clip "
        f"{clip}, {n_empty} empty), stage 2 {STAGE2_S[('mesh', 'auto')]:.3f}s once; stage 4 "
        f"search+mark per turn: " + ", ".join(f"{t['turn']} {t['stage 4']:.3f}s" for t in done)
        + f"; mesh / one card {mean['mesh'] / mean['one']:.4f} ({meshes['mesh']} against "
        f"{meshes['one']}); {len(pairs)} pairs marked in every turn, exact; {peak_rss()}; "
        f"cards: " + "; ".join(card_lines()) + ". CORRECTNESS: exact"
    )
    return done


def phase11_mesh(lib2, lib_none, db2: str, db_none: str) -> None:
    """The multi-device path: a mesh over every visible card, or
    MESH_MEMBERS_ON_ONE_CARD members sharing the one card, each on a stream
    of its own; the dry run on it; phase 2's library pruned (auto) and the
    long-tail library's N_NONE run (none) through stage 4 on it, each from
    its phase's database after stage 2 (db2, db_none); and stage 1 of phase
    10's 400 videos on it."""
    import torch

    mesh, how = phase11_choose_mesh()
    log(f"phase 11 mesh: {mesh}, {how}; card: {card_line()}")
    phase11_dryrun(mesh)
    # phases 2 and 9 ran with the orchestrator's own choice: one device
    # where one card is visible, else a mesh over all of them
    default = f"the orchestrator's default over {torch.cuda.device_count()} visible card(s)"
    stage4_orchestrator(
        11, *lib2, {"exists_mask_sweep"}, mesh=mesh, from_db=db2, search_prefilter="auto"
    )
    log(f"phase 11 stage 4, pruned, N={len(lib2[0])}: {STAGE4_S[(11, 'auto')]:.3f} s on {mesh}, "
        f"phase 2 {STAGE4_S[(2, 'auto')]:.3f} s on {default}; card: {card_line()}")
    stage4_orchestrator(
        11, *lib_none, {"similarity_segments", "similarity_block"}, mesh=mesh, from_db=db_none,
        search_prefilter="none",
    )
    log(f"phase 11 stage 4, none, N={len(lib_none[0])}: {STAGE4_S[(11, 'none')]:.3f} s on {mesh}, "
        f"phase 9 {STAGE4_S[(9, 'none')]:.3f} s on {default}; card: {card_line()}")
    phase5_stage1(11, RERANK_SCENES, MESH_STAGE1_SAMPLE, mesh=mesh)


#: sitecustomize of phase 12's console-script runs: at the interpreter's
#: exit it writes report_<pid>.json beside itself (where the port was
#: imported from, the kernels' launch counts, the kernel build directory,
#: whether jax or the JAX package was imported), then hands over to the
#: sitecustomize it shadows, if any
PROBE_SITECUSTOMIZE = """
import atexit, importlib.machinery, importlib.util, json, os, sys

_here = os.path.dirname(os.path.abspath(__file__))


def _report():
    port = "hydrus_video_deduplicator_tpu_torch"
    mods = dict(sys.modules)
    launches = {}
    for name in ("ops.similarity_segments", "ops.similarity_block", "ops.pdq_filter",
                 "ops.pair_verify"):
        launches.update(getattr(mods.get(port + "." + name), "LAUNCHES", {}))
    build = mods.get(port + ".ops._build")
    report = {
        "port": getattr(mods.get(port), "__file__", None),
        "launches": launches,
        "build_dir": str(build.build_dir()) if build else None,
        "reference": sorted(
            m for m in mods if m.split(".")[0] in ("jax", "hydrus_video_deduplicator_tpu")
        ),
    }
    with open(os.path.join(_here, "report_%d.json" % os.getpid()), "w") as f:
        json.dump(report, f)


atexit.register(_report)
_path = [p for p in sys.path if os.path.abspath(p or ".") != _here]
_spec = importlib.machinery.PathFinder.find_spec("sitecustomize", _path)
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


class StampedLog(list):
    """The fake server's request log, keeping each request's time too."""

    def __init__(self):
        super().__init__()
        self.times: list[float] = []

    def append(self, path):
        self.times.append(time.perf_counter())
        super().append(path)

    def since(self, start: int, path: str) -> list[float]:
        """Times of the requests for ``path`` from entry ``start`` on."""
        return [t for p, t in zip(self[start:], self.times[start:]) if p == path]


def run_checked(cmd, log_path: str, **kwargs) -> subprocess.CompletedProcess:
    """Run cmd, its output kept in log_path; raise with its tail unless it exits 0."""
    proc = subprocess.run(cmd, capture_output=True, text=True, stdin=subprocess.DEVNULL, **kwargs)
    with open(log_path, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(map(str, cmd))} exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        )
    return proc


def phase12_installed(lib2, db2: str) -> None:
    """The port as users install and run it: a wheel built from a copy of
    the sources, installed with --target, its console script run twice on
    phase 2's library from a copy of phase 2's database after stage 2."""
    import sqlite3

    import torch

    from hydrus_video_deduplicator_tpu_torch.db import DedupeDB, vptree
    from hydrus_video_deduplicator_tpu_torch.ops import _build
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    blobs, expected, _n_empty, _min_sim = lib2
    n_videos = len(blobs)
    port = "hydrus_video_deduplicator_tpu_torch"
    names = {k: _build.library_name(k) for k in _build.KERNELS}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the runs are other processes on this card
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_installed_") as tmp:
        src, site, probe, outside = (os.path.join(tmp, d) for d in ("src", "site", "probe", "cwd"))
        for d in (src, probe, outside):
            os.makedirs(d)
        t0 = time.perf_counter()
        for name in WHEEL_SOURCES:
            path = os.path.join(ROOT, name)
            if os.path.isdir(path):
                shutil.copytree(path, os.path.join(src, name),
                                ignore=shutil.ignore_patterns(*BUILD_OUTPUTS))
            else:
                shutil.copy2(path, src)
        t_copy = time.perf_counter() - t0
        pip = [sys.executable, "-m", "pip"]
        offline = ["--no-index", "--disable-pip-version-check"]
        t0 = time.perf_counter()
        run_checked([*pip, "wheel", "--no-deps", "--no-build-isolation", *offline, "-w",
                     os.path.join(tmp, "dist"), src], os.path.join(tmp, "wheel.log"), cwd=tmp)
        t_wheel = time.perf_counter() - t0
        (wheel,) = os.listdir(os.path.join(tmp, "dist"))
        t0 = time.perf_counter()
        run_checked([*pip, "install", "--no-deps", *offline, "--target", site,
                     os.path.join(tmp, "dist", wheel)], os.path.join(tmp, "install.log"), cwd=tmp)
        t_install = time.perf_counter() - t0
        log(f"phase 12: copy {t_copy:.3f} s, pip wheel {t_wheel:.3f} s ({wheel}), "
            f"pip install --target {t_install:.3f} s")

        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = site
        code = "; ".join([
            "import json",
            f"import {port} as port",
            f"from {port} import native",
            f"from {port}.ops import _build",
            "lib = native.get_lib()",
            "print(json.dumps({'port': port.__file__, 'native': lib and lib._name,"
            " 'names': {k: _build.library_name(k) for k in _build.KERNELS}}))",
        ])
        t0 = time.perf_counter()
        proc = run_checked([sys.executable, "-c", code], os.path.join(tmp, "report.log"),
                           cwd=outside, env=env)
        report = json.loads(proc.stdout.splitlines()[-1])
        log(f"phase 12: the installed copy ({time.perf_counter() - t0:.3f} s): {report}")
        installed = os.path.join(site, port)
        if os.path.dirname(report["port"]) != installed:
            raise AssertionError(f"phase 12: the port imported from {report['port']}")
        if report["names"] != names:
            raise AssertionError(f"phase 12: library names {report['names']} != {names}")
        if report["native"] != os.path.join(installed, "native", "build", "libhvdaccel.so"):
            raise AssertionError(f"phase 12: the native library loaded from {report['native']}")

        db_dir = os.path.join(tmp, "db")
        os.makedirs(db_dir)
        db_file = os.path.join(db_dir, DedupeDB.get_db_name())
        shutil.copyfile(db2, db_file)
        sweep_so = os.path.join(installed, "csrc", "build", names["exists_mask_sweep"])
        if os.path.exists(sweep_so):
            raise AssertionError("phase 12: the sweep library existed before the run")
        with open(os.path.join(probe, "sitecustomize.py"), "w") as f:
            f.write(PROBE_SITECUSTOMIZE)
        env["PYTHONPATH"] = os.pathsep.join([site, probe])
        server = FakeHydrus({file_hash(i): b"" for i in range(n_videos)})
        server.requests_seen = StampedLog()
        server.start()
        cmd = [
            os.path.join(site, "bin", CONSOLE_SCRIPT), "--api-key", DEFAULT_ACCESS_KEY,
            "--api-url", server.url, "--dedup-database-dir", db_dir, "--threshold",
            str(THRESHOLD), "--search-backend", "gpu",
        ]
        runs = []
        try:
            for run in (1, 2):
                start, posts = len(server.requests_seen), len(server.relationship_posts)
                t0 = time.perf_counter()
                proc = subprocess.Popen(
                    cmd, cwd=outside, env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                out, _ = proc.communicate()
                t_run = time.perf_counter() - t0
                with open(os.path.join(tmp, f"cli{run}.log"), "w") as f:
                    f.write(out)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"phase 12: the console script exited {proc.returncode}:\n{out[-4000:]}"
                    )
                with open(os.path.join(probe, f"report_{proc.pid}.json")) as f:
                    seen = json.load(f)
                listed = server.requests_seen.since(start, "/get_files/search_files")
                counts = server.requests_seen.since(
                    start, "/manage_file_relationships/get_potentials_count"
                )
                fetched = server.requests_seen[start:].count("/get_files/file")
                runs.append({
                    "s": t_run, "stage4_s": counts[1] - counts[0],
                    "list_s": counts[0] - listed[0],
                    "marked": len(server.relationship_posts) - posts,
                    "fetched": fetched, **seen,
                })
                log(f"phase 12 run {run}: {runs[-1]}")
                if run == 1:
                    built = os.path.exists(sweep_so)
        finally:
            server.stop()
        idx = {file_hash(i): i for i in range(n_videos)}
        got = {tuple(sorted((idx[a], idx[b]))) for a, b in server.relationships}
        conn = sqlite3.connect(db_file)
        try:
            unsearched = unsearched_files(conn, vptree.fix_vpdq_similarity(THRESHOLD))
        finally:
            conn.close()
        first, second = runs
        log(f"phase 12: marked {len(got)} pairs (planted {len(expected)}), missing "
            f"{len(expected - got)}, extras {len(got - expected)}, unsearched left {unsearched}; "
            f"the sweep library {names['exists_mask_sweep']} built in the installed copy: {built}")
        if first["port"] is None or os.path.dirname(first["port"]) != installed:
            raise AssertionError(f"phase 12: the console script ran the port from {first['port']}")
        if first["reference"] or second["reference"]:
            raise AssertionError(f"phase 12: the console script imported {first['reference']}")
        if first["fetched"] or second["fetched"]:
            raise AssertionError("phase 12: stage 1 fetched files")
        if got != expected:
            raise AssertionError("phase 12: the marked pairs differ from the planted set")
        if unsearched:
            raise AssertionError(f"phase 12: {unsearched} files left unsearched")
        if second["marked"]:
            raise AssertionError(f"phase 12: the second run marked {second['marked']} pairs")
        if not built or first["build_dir"] != os.path.join(installed, "csrc", "build"):
            raise AssertionError("phase 12: the sweep library was not built in the installed copy")
        launched = {k: n for k, n in first["launches"].items() if n}
        if set(launched) != {"exists_mask_sweep", "pair_verify"}:
            raise AssertionError(f"phase 12: kernel launches {first['launches']}")
        log(f"phase 12 seconds: installed CLI run 1 {first['s']:.3f} (stage 4 "
            f"{first['stage4_s']:.3f}, stage 1 listing to stage 4 {first['list_s']:.3f}), run 2 "
            f"{second['s']:.3f} (stage 4 {second['stage4_s']:.3f}); phase 2 stage 4 search+mark "
            f"{STAGE4_S[(2, 'auto')]:.3f} in this process; card: {card_line()}")


def phase13_bench(sweep_timing: dict, pdq_timing: dict) -> None:
    """bench_torch.py in its own process, its last line checked (module
    docstring, phase 13); phase 1's tolerance-79 and phase 4's timings
    for comparison."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the benchmark is another process on this card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_bench_") as tmp:
        proc = run_checked([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                           os.path.join(tmp, "bench.log"), cwd=ROOT)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"phase 13 bench: {line}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    missing += [k for k in BENCH_MEASUREMENTS if k not in line.get("measurements", {})]
    if missing:
        raise AssertionError(f"phase 13: the benchmark's line lacks {missing}")
    if line["device"].get("name") != torch.cuda.get_device_name(0):
        raise AssertionError(f"phase 13: the benchmark ran on {line['device']}")
    m = line["measurements"]
    rates = {k: line[k] for k in ("value", "vs_baseline", "search_projected_1m_videos_sec",
                                  "search_projected_1m_mean71_sec")}
    rates.update({f"{name}.{k}": v for name, entry in m.items() for k, v in entry.items()
                  if k.endswith("_per_s")})
    bad = {k: v for k, v in rates.items() if not (isinstance(v, (int, float)) and v > 0)}
    if bad:
        raise AssertionError(f"phase 13: rates not positive: {bad}")
    idle = [k for k in ("pdq_filter", "similarity_segments", "exists_mask_sweep")
            if not line["launches"].get(k)]
    if idle:
        raise AssertionError(f"phase 13: kernels never launched: {idle} ({line['launches']})")
    sweep, filt = m["mean71_sweep"], m["pdq_filter_kernel"]
    phase1_rate = sweep_timing["frame_pairs"] / (sweep_timing["ms"] / 1e3)
    log(f"phase 13: bench_torch.py exited 0 in {seconds:.1f} s: {line['value']:.1f} frames/s, "
        f"1M projections {line['search_projected_1m_videos_sec']:.3f} s (8-frame videos) and "
        f"{line['search_projected_1m_mean71_sec']:.3f} s (mean-71 stage A), one card; launches "
        f"{line['launches']}")
    log(f"phase 13: PDQ filter kernel {filt['median_ms']:.4f} ms median (phase 4: "
        f"{pdq_timing['ms']:.4f} ms, {filt['median_ms'] / pdq_timing['ms'] - 1:+.1%}); sweep "
        f"{sweep['frame_comparisons_per_s']:.4g} frame comparisons/s (phase 1 at tolerance 79: "
        f"{phase1_rate:.4g} real pairs/s, {sweep['frame_comparisons_per_s'] / phase1_rate - 1:+.1%})")
    for name in ("search_tile", "search_row_tile", "mean71_sweep"):
        entry = m[name]
        bound_ms, bound_by = bound(
            entry["bytes"], OPS_PER_FRAME_PAIR * entry["frame_comparisons"], B1_OPS_PER_S
        )
        log(f"phase 13: {name} {entry['median_ms']:.4f} ms median ({entry['min_ms']:.4f}-"
            f"{entry['max_ms']:.4f}, host {entry['host_ms']:.4f} ms a call), bound "
            f"{bound_ms:.4f} ms ({bound_by}), {entry['median_ms'] / bound_ms:.2f}x; "
            f"card: {line['device']['nvidia_smi']}")


def pair_verify_timing(n: int = 1_000_000, chunk: int = 131_072, at: int = 4, iters: int = 20):
    """Phase 2e, stage B's kernel alone (csrc/pair_verify.cu) on one
    find_pairs_pruned call's device pairs: row chunk ``at`` of the seed-7
    mean-71 scene library of ``n`` videos, as the scene1m-pruned cell's
    step calls it.

    Logs the call's pairs and frame pairs, the kernel's CUDA-event time a
    launch (``iters`` launches after a warm-up) beside its bound (the
    uploaded bytes at 3.35 TB/s, the real frame pairs at 2.02e13/s), the
    host-to-device copy of its input, and the host time of the plain
    version on the card (``_verify_plain``: the float16 bmm chain that the
    kernel replaced, a bucket's chunks drained together), and requires the
    kernel's similarities to equal it. Returns the numbers as a dict, with
    the keys of the ``kernels`` line (``ms``, ``plain_ms``, ``bound_ms``,
    ``bound_by``, ``max_abs_err``)."""
    import numpy as np
    import torch

    from hydrus_video_deduplicator_tpu_torch.ops import pair_verify as pv
    from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine
    from hydrus_video_deduplicator_tpu_torch.utils import device_timer

    dev = torch.device("cuda")
    log(f"card: {card_line()}")
    blobs, _pairs, _n_empty, min_sim = build_library(n)
    calls = []
    real = pv.verify_pairs
    pv.verify_pairs = lambda pairs, rb, cb, *a, **k: calls.append((pairs, rb, cb)) or real(
        pairs, rb, cb, *a, **k
    )
    try:
        i0 = at * chunk
        GpuSearchEngine(device=dev).find_pairs_pruned(
            blobs[i0 : i0 + chunk], blobs, min_sim, col_state={},
            col_limit=min(i0 + chunk, n), rows_at=i0,
        )
    finally:
        pv.verify_pairs = real
    pairs, row_blob, col_blob = calls[-1]
    t0 = time.perf_counter()
    split = pv._split(pairs, row_blob, col_blob)
    t_split = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, order = pv._pack(split)
    t_pack = time.perf_counter() - t0
    n_pairs = len(order)
    frame_pairs = int((split.table[:, 1].astype(np.int64) * split.table[:, 3]).sum())
    nbytes = host.numel() * 4 + n_pairs * 4
    buf = host.to(dev)
    torch.cuda.synchronize()
    copy_s = device_timer(lambda i: buf.copy_(host, non_blocking=True), iters=iters)
    kernel_s = device_timer(lambda i: pv._launch(buf, n_pairs), iters=iters)
    got = np.empty(n_pairs, dtype=np.int32)
    got[order] = pv._launch(buf, n_pairs).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pv._verify_plain(split, dev)
    plain_s = time.perf_counter() - t0
    if not n_pairs or not np.array_equal(got, plain):
        raise AssertionError(
            f"phase 2e: {int((got != plain).sum())} of {n_pairs} similarities differ"
        )
    bytes_s, ops_s = nbytes / 3.35e12, frame_pairs / 2.02e13
    bound_s = max(bytes_s, ops_s)
    out = {
        "candidates": len(pairs), "device_pairs": n_pairs, "frame_pairs": frame_pairs,
        "bytes": nbytes, "ms": kernel_s * 1e3, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "ops",
        "roofline_pct": 100 * bound_s / kernel_s, "copy_ms": copy_s * 1e3,
        "split_ms": t_split * 1e3, "pack_ms": t_pack * 1e3, "plain_ms": plain_s * 1e3,
        "max_abs_err": int(np.abs(got - plain).max()),
    }
    log(f"phase 2e: pair_verify at row chunk {at}: {json.dumps(out)}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    phase0_build()
    # phases 11 and 12 start from the databases of phase 2 and phase 9's "none" run
    kept = tempfile.TemporaryDirectory(prefix="hvd_chip_smoke_db_")
    db2, db_none = (os.path.join(kept.name, f"{name}.sqlite") for name in ("phase2", "phase9_none"))
    lib2 = build_library(N_VIDEOS)
    timing = phase1_kernel_vs_plain(lib2[0], dev)
    delta_launches = []  # phase 2b runs on phase 2's database after its re-run
    phase2_launches = stage4_orchestrator(
        2, *lib2, {"exists_mask_sweep"}, save_db=db2,
        after=lambda *state: delta_launches.append(phase2b_delta(lib2, *state)),
    )
    main_path = (phase2_launches, delta_launches[0], phase2c_mean200())
    sweep_launches = sum(run["exists_mask_sweep"] for run in main_path)
    verify_launches = sum(run["pair_verify"] for run in main_path)
    phase2d_timing(lib2, db2, phase2_launches["exists_mask_sweep"])
    verify_timing = pair_verify_timing()
    phase3_cli()
    pdq_timing = phase4_pdq_kernel_vs_plain(dev)
    pdq_launches = phase5_stage1()
    seg_timing = phase6_similarity_vs_plain(lib2[0], dev)
    seg_launches = stage4_orchestrator(7, *lib2, {"similarity_segments"}, search_prefilter="none")
    sweep_launches_7b = sum(sweep_rehearsal(*args)["launches"] for args in SWEEP_SMOKE)
    blobs, expected, n_empty, min_sim = build_library(N_VIDEOS, LONG_CLIP, LONG_PLANTS["auto"])
    block_timing = phase8_block_vs_plain(blobs, dev)
    block_launches = stage4_orchestrator(
        9, blobs, expected, n_empty, min_sim, {"exists_mask_sweep", "similarity_block"},
        search_prefilter="auto",
    )["similarity_block"]
    del blobs
    lib_none = build_library(N_NONE, LONG_CLIP, LONG_PLANTS["none"])
    stage4_orchestrator(
        9, *lib_none, {"similarity_segments", "similarity_block"}, save_db=db_none,
        search_prefilter="none",
    )
    phase10_tower(dev)
    traced(phase10_rerank)
    phase11_mesh(lib2, lib_none, db2, db_none)
    phase12_installed(lib2, db2)
    kept.cleanup()
    phase13_bench(timing[79], pdq_timing)
    reference = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "hydrus_video_deduplicator_tpu")
    )
    if reference:
        raise AssertionError(f"the run imported jax or the JAX package: {reference[:10]}")

    def entry(launches, timings, *labels):
        """(launches on its path, max abs error, and the first label's kernel
        ms, plain ms, bound ms and bound)."""
        first = timings[labels[0]]
        return (
            launches, max(timings[k]["max_abs_err"] for k in labels),
            first["ms"], first["plain_ms"], first["bound_ms"], first["bound_by"],
        )

    # ms at the path's mode: tolerance 79 for the sweep, the mask for kernel
    # 3, the long rows against the 33-64-frame bucket (the most column
    # frames) for kernel 5
    measured = {
        "exists_mask_sweep": entry(sweep_launches, timing, 79, 31),
        "pdq_filter": entry(pdq_launches, {"b512": pdq_timing}, "b512"),
        "similarity_segments": entry(
            seg_launches["similarity_segments"] + sweep_launches_7b, seg_timing,
            "mask 75 + list", "mask 1 + list", "mask 75", "mask 1", "sims",
        ),
        "exists_counts": entry(
            seg_launches["exists_counts"], seg_timing, "counts 31", "counts 79"
        ),
        "exists_mask_kernel": entry(
            seg_launches["exists_mask_kernel"], seg_timing, "every-step sweep 79"
        ),
        "similarity_block": entry(block_launches, block_timing, "1024 x 64", *block_timing),
        "pair_verify": entry(verify_launches, {"2e": verify_timing}, "2e"),
    }
    print(card_line())
    print(json.dumps({
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": f"hydrus_video_deduplicator_tpu_torch/csrc/{KERNELS[name][0]}.cu",
                "replaces": f"hydrus_video_deduplicator_tpu/{KERNELS[name][1]}",
                "launches": launches,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
            for name, (launches, err, ms, plain_ms, bound_ms, bound_by) in measured.items()
        ]
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
