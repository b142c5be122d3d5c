"""The port's headline benchmark on one GPU: PDQ frames hashed per second
(the counterpart of bench.py, which times the JAX package's Pallas hash on
a TPU).

    python3 bench_torch.py [--seed 0] [--device cpu]

It times the port's fused PDQ hash, ``ops.pdq_filter.pdq_hash_batch_fused``
(the hand-written filter kernel ``csrc/pdq_filter.cu`` and the eager
PyTorch tail of ``models/pdq.py``), on B = BATCH planar frames [B, 3, 512,
512] uint8 made on the card from a ``torch.Generator`` seeded with
``--seed``, the batch ``GpuVideoHasher`` copies to the card; and the filter
kernel alone, so that the tail's share shows. The frames (402.7 MB) exceed
the 50 MB L2, so no call finds them cached. Then it runs
bench_search_torch's ``measure`` and ``measure_mean71`` (kernels 3 and 1),
as bench.py runs bench_search; a failure there is not caught.

Before any timing, the first call's words and quality are held against the
plain hash, ``models.pdq.pdq_hash_batch``, for every frame, bit for bit.
Every measurement is timed as bench_search_torch.time_rounds times it
(CUDA events, warm-up, ROUNDS rounds: median, min and max).

Diagnostics go to stderr. The last stdout line is one JSON object:
``metric`` "pdq_hash_frames_per_sec_per_chip", ``value`` (B over the fused
hash's median time), ``unit`` and ``vs_baseline`` (value over 50,000
frames/s, BASELINE.md), as bench.py prints them;
``search_projected_1m_videos_sec`` and ``search_vs_60s_target``;
``search_projected_1m_mean71_sec`` and ``search_mean71_vs_60s_target``
(each on ONE card: nothing is multiplied by a chip count); every
measurement with its median, min and max ms, host ms a call, rate, work
counts and checksum (``measurements``); the card's name, power limit and
the device count (``device``); and each of the three kernels' launches
during the run (``launches``, from the port's LAUNCHES counters).

Without CUDA the script exits 1 and measures nothing: it never falls back
to the CPU. ``--device cpu`` runs the plain versions at small sizes (B =
CPU_BATCH, bench_search_torch.CPU_TILE and CPU_SWEEP), a rehearsal of the
script's path: every time and rate in its line is null. The kernels build
at first use from the checkout's sources (``ops/_build.py``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import bench_search_torch as bs
from hydrus_video_deduplicator_tpu_torch.models import pdq as mpdq
from hydrus_video_deduplicator_tpu_torch.ops import pdq_filter
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg

BATCH = 512
CPU_BATCH = 2
#: bench.py's north-star target: bit-exact VPDQ frames/s on one chip (BASELINE.md)
BASELINE_FRAMES_PER_S = 50_000.0
#: the kernels' LAUNCHES counters this run reports, by wrapper name
KERNEL_COUNTERS = {
    "pdq_filter": pdq_filter.LAUNCHES,
    "similarity_segments": seg.LAUNCHES,
    "exists_mask_sweep": seg.LAUNCHES,
}


def launches() -> dict:
    return {name: counter[name] for name, counter in KERNEL_COUNTERS.items()}


def make_frames(device: torch.device, batch: int, seed: int) -> torch.Tensor:
    """[batch, 3, 512, 512] uint8 planar frames, uniform bytes from a
    torch.Generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(
        0, 256, (batch, 3, pdq_filter.N, pdq_filter.N), dtype=torch.uint8, device=device,
        generator=gen,
    )


def measure_pdq(frames: torch.Tensor) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The fused hash of ``frames`` ([B, 3, 512, 512] uint8 planar), held
    against the plain hash on every frame, then timed, and the filter
    kernel alone timed. Returns ({"hash": ..., "filter": ...}, the first
    call's words [B, 16] int32, its quality [B] int32)."""
    words, quality = pdq_filter.pdq_hash_batch_fused(frames)
    want_words, want_quality = mpdq.pdq_hash_batch(frames.permute(0, 2, 3, 1))
    if not (torch.equal(words, want_words) and torch.equal(quality, want_quality)):
        bad = int((words != want_words).any(1).sum() + (quality != want_quality).sum())
        raise AssertionError(f"pdq_hash_batch_fused differs from the plain hash ({bad} differences)")
    dev, batch = frames.device, frames.shape[0]
    buf64 = pdq_filter.pdq_filter_batch(frames)
    hash_times = bs.timed(dev, lambda: pdq_filter.pdq_hash_batch_fused(frames), iters=10)
    filter_times = bs.timed(dev, lambda: pdq_filter.pdq_filter_batch(frames), iters=50)
    result = {}
    for name, times, outputs, checksum in (
        ("hash", hash_times, (words, quality),
         words.sum(dtype=torch.int64) + quality.sum(dtype=torch.int64)),
        ("filter", filter_times, (buf64,), buf64.view(torch.int32).sum(dtype=torch.int64)),
    ):
        result[name] = {
            **times, "frames": batch, "frames_per_s": bs.per_s(batch, times),
            "bytes": bs.tensor_bytes(frames, *outputs), "checksum": int(checksum),
        }
        bs.log(f"pdq {name}, B={batch}: {bs.describe(result[name], 'frames_per_s')}")
    return result, words, quality


def card(dev: torch.device) -> dict:
    """The device the line's numbers were taken on."""
    if dev.type != "cuda":
        return {"platform": "cpu", "name": None, "power_limit": None, "count": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]
    return {
        "platform": "gpu", "name": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
        "power_limit": smi.rsplit(",", 1)[-1].strip(), "count": torch.cuda.device_count(),
    }


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="the frames' generator seed")
    parser.add_argument("--device", default=None,
                        help="cpu: the plain versions at small sizes (default: the card)")
    args = parser.parse_args(argv)
    dev = bs.device_or_exit(args.device, "bench_torch")
    on_cpu = dev.type == "cpu"
    device = card(dev)
    bs.log(f"device: {device}")
    before = launches()

    frames = make_frames(dev, CPU_BATCH if on_cpu else BATCH, args.seed)
    pdq, _, _ = measure_pdq(frames)
    del frames
    search = bs.measure(dev, **(bs.CPU_TILE if on_cpu else {}))
    mean71 = bs.measure_mean71(dev, **(bs.CPU_SWEEP if on_cpu else {}))
    after = launches()

    value = pdq["hash"]["frames_per_s"]
    result = {
        "metric": "pdq_hash_frames_per_sec_per_chip",
        "value": value,
        "unit": "frames/s",
        "vs_baseline": None if value is None else value / BASELINE_FRAMES_PER_S,
        "search_projected_1m_videos_sec": search["projected_1m_sec"],
        "search_vs_60s_target": search["vs_60s_target"],
        "search_projected_1m_mean71_sec": mean71["projected_1m_sec"],
        "search_mean71_vs_60s_target": mean71["vs_60s_target"],
        "measurements": {
            "pdq_hash_fused": pdq["hash"],
            "pdq_filter_kernel": pdq["filter"],
            "search_tile": search["tile"],
            "search_row_tile": search["row_tile"],
            "mean71_sweep": mean71["sweep"],
        },
        "device": device,
        "launches": {name: after[name] - before[name] for name in after},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
