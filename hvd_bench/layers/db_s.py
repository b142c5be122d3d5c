"""db_s.<cell>: the program's SQLite database (db/DedupeDB.py, db/blobs.py):
its statements, commits, file-hash lookups and blob reads on the step's
thread, seconds a step. Stage 2's own calls count here too; the row
prefetch's reads on its helper thread do not."""

from hvdb.layerspans import DATABASE

SPANS = DATABASE


def read(rec):
    return rec.per_step(DATABASE[0][0])
