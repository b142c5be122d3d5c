"""col_reps_s.<cell>: host clustering of the column side (parallel/engine.py
find_pairs_pruned: ops/reps.py extract_reps over every eligible column
video, in slabs, once a sweep), seconds a step: the program's spans
``prune.col_reps``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "prune.col_reps")
