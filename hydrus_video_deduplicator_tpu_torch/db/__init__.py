"""SQLite persistence, schema-compatible with the reference tool.

- :mod:`.DedupeDB` — connection, schema, migrations, id lookups
  (reference: src/hydrusvideodeduplicator/db/DedupeDB.py)
- :mod:`.vptree`   — SQLite-persisted vantage-point tree
  (reference: src/hydrusvideodeduplicator/db/vptree.py)

The primary TPU search path (parallel/engine.py) reads/writes the same
tables, so databases are interchangeable between the tree search and the
brute-force engine, and with the reference tool itself.
"""

from . import DedupeDB, vptree  # noqa: F401
