"""drain_decode_s.<cell>: the segment route's drain decode on the host
(parallel/engine.py _drain: decode_mask_hits, the slot maps, the hit
pairs), seconds a step: the program's spans ``seg.drain.decode``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "seg.drain.decode")
