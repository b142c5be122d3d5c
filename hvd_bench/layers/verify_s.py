"""verify_s.<cell>: stage B (ops/pair_verify.py verify_pairs), seconds a step,
synchronised with the device at its edges."""

from hvdb.layerspans import VERIFY

SPANS = (VERIFY,)


def read(rec):
    return rec.per_step(VERIFY[0])
