"""stage2_s.<cell>: stage 2 of the new rows (dedup.py
process_phashed_file_queue), seconds a step."""

from hvdb.layerspans import STAGE2

SPANS = (STAGE2,)


def read(rec):
    return rec.per_step(STAGE2[0])
