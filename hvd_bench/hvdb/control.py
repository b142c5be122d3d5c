"""The control of the check: the reference put in the program's place with
one guarantee broken, which the check has to find not correct.

The configurations state an exact search: every pair at or above the
minimum similarity is reported. The control breaks it the way an indexed
search would tempt a later change to: it compares only the pairs of videos
whose first frames share their first KEY_BYTES bytes (a keyframe bucket),
and reports those of them that reach the minimum similarity, each with its
reference similarity. A planted re-encode keeps its keyframe's bucket only
when none of its flipped bits falls in those bytes.

    python3 hvd_bench/control.py --workload <name> --seeds <n> [<n> ...]

builds each seed's library as a run does (without the program), answers
one step as the control, and prints the check's numbers for each seed.
"""

from __future__ import annotations

import numpy as np

from . import cells, reference

KEY_BYTES = 4


def bucket_pairs(blobs, scope: int = 0) -> list[tuple[int, int]]:
    """(a, b), a < b, b >= scope: the pairs of non-empty videos whose first
    frames share their first KEY_BYTES bytes."""
    idx = np.asarray([i for i, b in enumerate(blobs) if b], dtype=np.int64)
    keys = np.asarray([int.from_bytes(blobs[i][:KEY_BYTES], "little") for i in idx], dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    idx, keys = idx[order], keys[order]
    bounds = np.flatnonzero(np.diff(keys)) + 1
    pairs = []
    for group in np.split(idx, bounds):
        group = np.sort(group)
        for k, a in enumerate(group.tolist()):
            pairs += [(a, b) for b in group[k + 1 :].tolist() if b >= scope]
    return pairs


def answer(cell) -> None:
    """One step's output, as the control gives it, appended to
    ``cell.outputs`` in the program's form."""
    blobs, _, scope = cell.library()
    found = {}
    for a, b in bucket_pairs(blobs, scope):
        s = reference.similarity(blobs[a], blobs[b])
        if s >= cell.min_sim:
            found[(a, b)] = s
    if isinstance(cell, cells.SweepCell):
        own = [(i, i, 100) for i, b in enumerate(blobs) if b]
        hits = own + [(b, a, s) for (a, b), s in found.items()]
        cell.outputs.append(np.asarray(hits, dtype=np.int64).reshape(-1, 3))
        return
    pairs = set(found)
    old_new = sum(1 for a, b in pairs if a < scope)
    count = (old_new + 2 * (len(pairs) - old_new)) // 2 if cell.kind == "delta" else len(pairs)
    cell.outputs.append((pairs, sorted(pairs), count, 0))


def numbers(bench: dict, workload: str, seed: int, device: str, log, config=None) -> dict:
    """The check's numbers for the control's answer on ``seed``'s library."""
    from . import runner

    _, cfg, traffic = runner.cell_spec(bench, workload)
    cell = cells.make(config or cfg, traffic, seed, device, log)
    cell.build()
    answer(cell)
    verdict = cell.verdict(cell.truth(device))
    return {"correct": verdict.correct, **verdict.numbers}


def main(argv: list[str]) -> int:
    import argparse
    import json

    import torch

    from . import runner

    p = argparse.ArgumentParser(description="The check's control on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        runner.log("the control runs on a CUDA device: none found")
        return 3
    bench = runner.load_bench()
    for seed in args.seeds:
        out = numbers(bench, args.workload, seed, "cuda:0", runner.log)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0
