"""drain_wait_s.<cell>: the segment route's drain fetch (parallel/engine.py
_drain: torch.nonzero over a tile's masks and the copies to the host, the
host waiting on the device), seconds a step: the program's spans
``seg.drain.fetch``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "seg.drain.fetch")
