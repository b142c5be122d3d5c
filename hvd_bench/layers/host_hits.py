"""host_hits.<cell>: the hits whose similarity the host scores one
matchHashBytes at a time (parallel/engine.py _with_similarities), a step:
the program's count ``seg.host_hits``."""

from hvdb import program_spans


def read(rec):
    return program_spans.count_per_step(rec, "seg.host_hits")
