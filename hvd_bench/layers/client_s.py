"""client_s.<cell>: the requests to the Hydrus client API
(client/hydrus_api.py Client._request: the relationship POSTs and the
count calls), the in-process fake server's handling included, seconds a
step."""

from hvdb.layerspans import CLIENT

SPANS = (CLIENT,)


def read(rec):
    return rec.per_step(CLIENT[0])
