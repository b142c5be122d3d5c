"""candidates.<cell>: stage A's candidate pairs (parallel/engine.py
find_pairs_pruned: the video pairs with a leader pair within the inflated
tolerance, each video's self-pair among them), a step: the program's count
``prune.candidates``."""

from hvdb import program_spans


def read(rec):
    return program_spans.count_per_step(rec, "prune.candidates")
