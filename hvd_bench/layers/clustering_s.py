"""clustering_s.<cell>: host clustering (ops/reps.py extract_reps), seconds a
step, summed over its calls."""

from hvdb.layerspans import CLUSTERING

SPANS = (CLUSTERING,)


def read(rec):
    return rec.per_step(CLUSTERING[0])
