"""similarities_s.<cell>: the hits' similarities on the host
(parallel/engine.py _with_similarities), seconds a step."""

from hvdb.layerspans import SIMILARITIES

SPANS = (SIMILARITIES,)


def read(rec):
    return rec.per_step(SIMILARITIES[0])
