"""row_pack_s.<cell>: the segment route's row pack (parallel/engine.py
_segment_route: seg.pack_blocks once, then each tile's stack_blocks),
seconds a step: the program's spans ``seg.row_pack``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "seg.row_pack")
