"""The port's all-pairs search benchmark on one GPU (the counterpart of
bench_search.py, which times the JAX package's Pallas kernels on a TPU).

    python3 bench_search_torch.py [--device cpu]

It times two of the port's hand-written kernels through their wrappers,
on random packed hashes made from numpy seeds, at the shapes
bench_search.py timed, and projects the 1M-video search on ONE card:

- ``measure``: kernel 3 (``ops.similarity_segments.similarity_segments``
  in its similarity mode, ``csrc/similarity_segments.cu``) on 8-frame
  videos: (a) bench_search.py's tile of TR x TC videos, whose grid of 2
  row blocks x 8 column steps holds 16 blocks for the card's 132 SMs, and
  (b) the same row videos against TC_WIDE column videos in one launch
  (1,024 steps), as ``GpuSearchEngine`` launches a row tile against the
  whole column corpus. The projection
  divides the 1M-video triangle, 10^12 / 2 video pairs, by (b)'s rate.
- ``measure_mean71``: kernel 1 (``ops.similarity_segments.exists_mask_sweep``,
  ``csrc/exists_mask_sweep.cu``) at the pruned route's tolerance,
  ``ops.reps.prune_tolerance()``, on one row tile against
  MEAN71_COL_TILES column tiles; the projection is stage A of the pruned
  search at the 1M mean-71 library, (R_REPS_1M_MEAN71^2 / 2) frame
  comparisons over the measured rate.

Before any timing, each kernel's first output is held bit for bit against
its plain PyTorch version on the same inputs; a difference raises. Times
are CUDA events around ``iters`` back-to-back calls after warm-up calls,
in ROUNDS rounds: the median, min and max of the rounds' ms per call, and
the host's ms to enqueue one call (a call whose host time reaches its
device time is launch-bound). With random hashes almost no frame pair
lies within the tolerance, so both kernels run their fast path (the
binary products of every live fragment) almost everywhere, as on
bench_search.py's random hashes: a warp takes the slow path only where it
holds a match, here the planted copies (every PLANT_STRIDE-th column video
is a row video a few bits away), so that the checks compare matches too.

Without CUDA the script exits non-zero and measures nothing, unless
``--device cpu`` is given: then the wrappers run their plain versions at
the small sizes of CPU_TILE and CPU_SWEEP, and every time and rate is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from hydrus_video_deduplicator_tpu_torch._device import resolve_device
from hydrus_video_deduplicator_tpu_torch.ops import reps
from hydrus_video_deduplicator_tpu_torch.ops import similarity as ops_sim
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

PAD = 8  # frames per video (1 fps, ~8 s clips)
TR, TC = 512, 2048  # bench_search.py's tile: (TR*PAD) x (TC*PAD) frames
#: the row tile's column corpus in one launch: 1,024 steps, 2,097,152 frames
TC_WIDE = 262_144
#: bench_search.py's mean-71 sweep: one row tile of TILE_ROW_BLOCKS row
#: blocks against MEAN71_COL_TILES column tiles of TILE_COL_STEPS steps
#: (the JAX package's TILE_ROW_BLOCKS and TILE_COL_STEPS, and the
#: bench_dot_floor6 shape)
TILE_ROW_BLOCKS = 2
TILE_COL_STEPS = 8
MEAN71_COL_TILES = 128
#: the frame steps of the wide call held against the plain version
CHECK_STEPS = 8
#: every PLANT_STRIDE-th column video is a copy of a row video with bit 0
#: of each word flipped (Hamming distance 8 a frame), so the outputs the
#: check compares hold matches, not only zeros
PLANT_STRIDE = 1024
#: rounds of every measurement, and warm-up calls before them
ROUNDS = 5
WARMUP = 2
#: the 1M-video all-pairs triangle, in video pairs
ALLPAIRS_1M = 1_000_000 * 1_000_000 / 2
TARGET_S = 60.0

#: measured total scene-leader count of the seed-7 1M mean-71 scene-model
#: corpus (reps: 13346205 of 71115089 frames — artifacts/sweep_scenes_1m_r04a.log;
#: the same constant reproduces in every r03/r04 sweep of that corpus)
R_REPS_1M_MEAN71 = 13_346_205

#: the arguments of measure and measure_mean71 for --device cpu, where
#: the plain versions run
CPU_TILE = {"tr": 4, "tc": 8, "tc_wide": 64}
CPU_SWEEP = {"row_blocks": 1, "col_tiles": 1}

NO_TIMES = {"median_ms": None, "min_ms": None, "max_ms": None, "host_ms": None,
            "launch_bound": None}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_or_exit(device: "str | None", program: str) -> torch.device:
    """resolve_device(device), or exit 1 with the reason: without CUDA
    nothing runs unless the caller names the CPU."""
    try:
        return resolve_device(device)
    except RuntimeError as exc:
        log(f"{program}: {exc}; nothing was measured")
        raise SystemExit(1) from exc


def time_rounds(fn, iters: int) -> dict:
    """Device ms per call of fn() on the current CUDA stream: WARMUP calls,
    then ROUNDS rounds of ``iters`` back-to-back calls between two CUDA
    events; the median, min and max of the rounds, the median host ms to
    enqueue one call, and whether the calls are launch-bound (the host's
    enqueue time reaches 90 % of the device time)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    device_ms, host_ms = [], []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms.append(1e3 * (time.perf_counter() - t0) / iters)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end) / iters)
    median, host = statistics.median(device_ms), statistics.median(host_ms)
    return {"median_ms": median, "min_ms": min(device_ms), "max_ms": max(device_ms),
            "host_ms": host, "launch_bound": host >= 0.9 * median}


def timed(dev: torch.device, fn, iters: int) -> dict:
    """time_rounds on the card; NO_TIMES on the CPU, where nothing is timed."""
    return time_rounds(fn, iters) if dev.type == "cuda" else dict(NO_TIMES)


def per_s(count: float, times: dict) -> "float | None":
    """count per second at the median time, or None where nothing was timed."""
    return None if times["median_ms"] is None else count / (times["median_ms"] / 1e3)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def packed_videos(
    rng: np.random.Generator, n_videos: int, frames_per_block: int, slots_per_block: int,
    block_multiple: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random PAD-frame videos from ``rng``, laid out as
    ``seg.pack_blocks`` and ``seg.stack_blocks`` lay them out: each block
    holds exactly slots_per_block videos (PAD x slots_per_block ==
    frames_per_block), so video v takes frames v*PAD .. v*PAD + PAD - 1 and
    global slot v. Returns (words [n_blocks * frames_per_block, 8] uint32,
    block-local slot ids [n_blocks * frames_per_block] int32 with -1
    padding, frame counts [n_blocks * slots_per_block] int32), the block
    count rounded up to a multiple of ``block_multiple``. Built with numpy
    alone: a Python packer loop over 262,144 videos would dominate the
    run."""
    assert PAD * slots_per_block == frames_per_block
    n_blocks = -(-n_videos // slots_per_block)
    n_blocks = -(-n_blocks // block_multiple) * block_multiple
    n_frames = n_videos * PAD
    words = np.zeros((n_blocks * frames_per_block, ops_sim.LANES), dtype=np.uint32)
    words[:n_frames] = rng.integers(0, 2**32, (n_frames, ops_sim.LANES), dtype=np.uint32)
    slots = np.full(n_blocks * frames_per_block, -1, dtype=np.int32)
    slots[:n_frames] = np.repeat(np.arange(n_videos, dtype=np.int32) % slots_per_block, PAD)
    counts = np.zeros(n_blocks * slots_per_block, dtype=np.int32)
    counts[:n_videos] = PAD
    return words, slots, counts


def plant(a_words: np.ndarray, b_words: np.ndarray, n_rows: int, n_cols: int) -> None:
    """Overwrite every PLANT_STRIDE-th of the n_cols column videos in
    b_words with one of the n_rows row videos of a_words, in turn, bit 0 of
    each word flipped."""
    cols = np.arange(0, n_cols, PLANT_STRIDE)
    rows = np.arange(len(cols)) % n_rows
    b_words.reshape(-1, PAD, ops_sim.LANES)[cols] = (
        a_words.reshape(-1, PAD, ops_sim.LANES)[rows] ^ np.uint32(1)
    )


def _to_device(dev: torch.device, words, slots, counts) -> tuple[torch.Tensor, ...]:
    return (ops_sim.to_words(words, dev), torch.from_numpy(slots).to(dev),
            torch.from_numpy(counts).to(dev))


def tile_operands(dev: torch.device, n_rows: int, n_cols: int) -> tuple[torch.Tensor, ...]:
    """``similarity_segments``' arguments for n_rows row videos (numpy
    seed 0) against n_cols column videos (seed 1, with the plants) of PAD
    frames, every column step valid: (a_words, slot_a, counts_a, b_words,
    slot_b, counts_b, valid)."""
    a = packed_videos(np.random.default_rng(0), n_rows, seg.ROW_FRAMES, seg.ROW_SLOTS)
    b = packed_videos(
        np.random.default_rng(1), n_cols, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS, seg.N_SPLIT
    )
    plant(a[0], b[0], n_rows, n_cols)
    a_words, slot_a, counts_a = _to_device(dev, *a)
    b_words, slot_b, counts_b = _to_device(dev, *b)
    valid = torch.ones(b_words.shape[0] // seg.STEP_FRAMES, dtype=torch.int32, device=dev)
    return a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid


def _check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: the kernel differs from its plain version in {bad} entries")


def run_tile(
    operands, iters: int, check_steps: "int | None" = None
) -> tuple[dict, torch.Tensor]:
    """One call of kernel 3's similarity mode on ``operands``
    (``tile_operands``), held bit for bit against
    ``similarity_segments_plain`` over its first ``check_steps`` column
    steps (all with None), then timed. Returns (the measurement, the first
    call's output)."""
    a_words, slot_a, counts_a, b_words, slot_b, counts_b, valid = operands
    dev = a_words.device
    out = seg.similarity_segments(*operands)
    n_steps = valid.shape[0]
    k = n_steps if check_steps is None else min(check_steps, n_steps)
    cols = slice(0, k * seg.STEP_FRAMES)
    want = seg.similarity_segments_plain(
        a_words, slot_a, counts_a, b_words[cols], slot_b[cols],
        counts_b[: k * seg.STEP_SLOTS], valid[:k],
    )
    _check_equal("similarity_segments", out[:, : k * seg.STEP_SLOTS], want)
    row_frames = int((slot_a >= 0).sum())
    col_frames = int((slot_b >= 0).sum())
    times = timed(dev, lambda: seg.similarity_segments(*operands), iters)
    result = {
        **times,
        "video_pairs": (row_frames // PAD) * (col_frames // PAD),
        "frame_comparisons": row_frames * col_frames,
        "bytes": tensor_bytes(*operands, out),
        "checked_steps": k,
        "checksum": int(out.sum(dtype=torch.int64)),
    }
    result["video_pairs_per_s"] = per_s(result["video_pairs"], times)
    result["frame_comparisons_per_s"] = per_s(result["frame_comparisons"], times)
    return result, out


def measure(
    device: "str | torch.device | None" = None, tr: int = TR, tc: int = TC,
    tc_wide: int = TC_WIDE,
) -> dict:
    """Kernel 3 on 8-frame videos: (a) ``tile``, tr x tc videos
    (bench_search.py's tile), and (b) ``row_tile``, the same tr row videos
    against tc_wide column videos in one launch (its first CHECK_STEPS
    steps held against the plain version); the 1M-video projection on one
    card from (b)'s rate."""
    dev = resolve_device(device)
    tile, _ = run_tile(tile_operands(dev, tr, tc), iters=100)
    log(f"search tile {tr} x {tc} videos of {PAD} frames: {describe(tile)}")
    operands = tile_operands(dev, tr, tc_wide)
    row_tile, _ = run_tile(operands, iters=10, check_steps=CHECK_STEPS)
    del operands
    log(f"search row tile {tr} x {tc_wide} videos in one launch: {describe(row_tile)}")
    rate = row_tile["video_pairs_per_s"]
    projected = None if rate is None else ALLPAIRS_1M / rate
    if projected is not None:
        log(f"projected 1M-video all-pairs on one card: {projected:.3f} s")
    return {
        "tile": tile, "row_tile": row_tile, "projected_1m_sec": projected,
        "vs_60s_target": None if projected is None else TARGET_S / projected,
    }


def sweep_operands(dev: torch.device, row_blocks: int, n_steps: int) -> tuple[torch.Tensor, ...]:
    """``exists_mask_sweep``'s frame arguments as bench_search.py's
    ``measure_mean71`` builds them: random words from numpy seed 0 (rows,
    then columns), every frame real, each slot PAD frames, every step
    valid; with the plants: (a_words, slot_a, b_words, slot_b, valid)."""
    rng = np.random.default_rng(0)
    n_rows, n_cols = row_blocks * seg.ROW_SLOTS, n_steps * seg.STEP_SLOTS
    a = packed_videos(rng, n_rows, seg.ROW_FRAMES, seg.ROW_SLOTS)
    b = packed_videos(rng, n_cols, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    plant(a[0], b[0], n_rows, n_cols)
    a_words, slot_a, _ = _to_device(dev, *a)
    b_words, slot_b, _ = _to_device(dev, *b)
    valid = torch.ones(n_steps, dtype=torch.int32, device=dev)
    return a_words, slot_a, b_words, slot_b, valid


def run_sweep(operands, tolerance: int, iters: int) -> tuple[dict, torch.Tensor]:
    """One call of kernel 1 on ``operands`` (``sweep_operands``), held bit
    for bit against ``exists_mask_sweep_plain``, then timed. Returns (the
    measurement, the first call's masks)."""
    a_words, b_words = operands[0], operands[2]
    masks = seg.exists_mask_sweep(*operands, tolerance)
    _check_equal("exists_mask_sweep", masks, seg.exists_mask_sweep_plain(*operands, tolerance))
    times = timed(a_words.device, lambda: seg.exists_mask_sweep(*operands, tolerance), iters)
    result = {
        **times,
        "tolerance": tolerance,
        "frame_comparisons": a_words.shape[0] * b_words.shape[0],
        "bytes": tensor_bytes(*operands, masks),
        "checksum": int(np.unpackbits(masks.cpu().numpy().view(np.uint8)).sum()),
    }
    result["frame_comparisons_per_s"] = per_s(result["frame_comparisons"], times)
    return result, masks


def measure_mean71(
    device: "str | torch.device | None" = None, row_blocks: int = TILE_ROW_BLOCKS,
    col_tiles: int = MEAN71_COL_TILES,
) -> dict:
    """Kernel 1 at ``reps.prune_tolerance()`` on one row tile of
    ``row_blocks`` row blocks against ``col_tiles`` column tiles, and
    stage A of the 1M mean-71 pruned search on one card projected from
    its rate: (R_REPS_1M_MEAN71^2 / 2) frame comparisons."""
    dev = resolve_device(device)
    operands = sweep_operands(dev, row_blocks, col_tiles * TILE_COL_STEPS)
    sweep, _ = run_sweep(operands, reps.prune_tolerance(), iters=20)
    del operands
    log(f"mean-71 mask sweep, {row_blocks} row blocks x {col_tiles} column tiles: "
        f"{describe(sweep)}")
    rate = sweep["frame_comparisons_per_s"]
    projected = None if rate is None else (R_REPS_1M_MEAN71**2 / 2) / rate
    if projected is not None:
        log(f"projected 1M mean-71 stage A on one card: {projected:.3f} s")
    return {
        "sweep": sweep, "projected_1m_sec": projected,
        "vs_60s_target": None if projected is None else TARGET_S / projected,
    }


def describe(m: dict, rate: str = "frame_comparisons_per_s") -> str:
    """One log line's worth of a measurement."""
    if m["median_ms"] is None:
        return f"checksum {m['checksum']}, not timed (CPU)"
    return (
        f"{m['median_ms']:.4f} ms median ({m['min_ms']:.4f}-{m['max_ms']:.4f} over {ROUNDS} "
        f"rounds; host {m['host_ms']:.4f} ms a call{', launch-bound' if m['launch_bound'] else ''}"
        f"), {m[rate]:.4g} {rate.removesuffix('_per_s').replace('_', ' ')}/s, "
        f"checksum {m['checksum']}"
    )


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cpu: the plain versions at CPU_TILE and CPU_SWEEP (default: the card)")
    dev = device_or_exit(parser.parse_args(argv).device, "bench_search_torch")
    on_cpu = dev.type == "cpu"
    print(json.dumps(measure(dev, **(CPU_TILE if on_cpu else {}))))
    print(json.dumps(measure_mean71(dev, **(CPU_SWEEP if on_cpu else {}))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
