# SPDX-License-Identifier: MIT
__version__ = "0.1.0"

# Version of the reference tool whose capabilities + DB schema this framework
# reproduces (hydrusvideodeduplicator v0.11.2). Database files written by this
# framework declare a compatible schema version so the reference's DBs can be
# opened/migrated and vice versa (see db/DedupeDB.py).
__compat_reference_version__ = "0.11.2"
