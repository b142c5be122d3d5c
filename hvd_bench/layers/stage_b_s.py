"""stage_b_s.<cell>: stage B of the pruned search (ops/pair_verify.py
verify_pairs: identical blobs settled on the host, the other candidates
bucketed, packed, verified exactly on the device and drained), seconds a
step: the program's spans ``verify``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "verify")
