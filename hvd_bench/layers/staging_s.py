"""staging_s.<cell>: column staging (parallel/engine.py _stage_columns),
seconds a step, synchronised with the device at its edges."""

from hvdb.layerspans import STAGING

SPANS = (STAGING,)


def read(rec):
    return rec.per_step(STAGING[0])
