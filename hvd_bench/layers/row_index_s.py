"""row_index_s.<cell>: the search's row index (parallel/engine.py find_pairs:
CorpusIndex of the row chunk and its segment rows), seconds a step: the
program's span ``find_pairs.row_index``."""

from hvdb import program_spans


def read(rec):
    return program_spans.per_step(rec, "find_pairs.row_index")
