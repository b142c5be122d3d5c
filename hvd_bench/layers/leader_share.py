"""leader_share.<cell>: the scene leaders' share of the column frames they
stand for, in percent (parallel/engine.py find_pairs_pruned, where a sweep
clusters its columns): 100 x the program's count ``prune.col_leaders`` over
its count ``prune.col_frames``. Stage A's device work grows with its
square. A program without these counts gives nothing to read."""

from hvdb import program_spans


def read(rec):
    leaders = program_spans.count_per_step(rec, "prune.col_leaders")
    frames = program_spans.count_per_step(rec, "prune.col_frames")
    if leaders is None or not frames:
        return None
    return 100.0 * leaders / frames
