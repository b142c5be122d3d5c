"""route_s.<cell>: the segment route (parallel/engine.py _segment_route with
its drain), seconds a step, synchronised with the device at its edges."""

from hvdb.layerspans import ROUTE

SPANS = (ROUTE,)


def read(rec):
    return rec.per_step(ROUTE[0])
