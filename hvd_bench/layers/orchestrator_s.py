"""orchestrator_s.<cell>: the orchestrator's self time, seconds a step: the
step's wall time less the spans of its children (stage 2, clustering, the
routes, stage B, the similarities, the database and the Hydrus client;
layerspans.CHILDREN)."""

from hvdb.layerspans import CHILDREN

SPANS = CHILDREN


def read(rec):
    return rec.self_seconds({label for label, _, _ in CHILDREN})
