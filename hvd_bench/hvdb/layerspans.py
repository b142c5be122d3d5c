"""The program's layers as the readers name them: (label, target, sync)
of each host span, and (name, target, work) of each kernel wrapper.

Targets are looked up where the program looks them up at call time (see
``spans.resolve``). Spans around calls that enqueue device work wait for
the device at both edges, in the traced run only.
"""

from __future__ import annotations

from . import roofline

PORT = "hydrus_video_deduplicator_tpu_torch"

STAGE2 = ("stage 2", f"{PORT}.dedup:HydrusVideoDeduplicator.process_phashed_file_queue", False)
CLUSTERING = ("host clustering", f"{PORT}.ops.reps:extract_reps", False)
STAGING = ("column staging", f"{PORT}.parallel.engine:GpuSearchEngine._stage_columns", True)
ROUTE = ("segment route", f"{PORT}.parallel.engine:GpuSearchEngine._segment_route", True)
VERIFY = ("stage B verify", f"{PORT}.ops.pair_verify:verify_pairs", True)
SIMILARITIES = ("host similarities", f"{PORT}.parallel.engine:_with_similarities", False)
BUCKETED = ("bucketed route", f"{PORT}.parallel.engine:GpuSearchEngine._bucket_pair", True)
LONG_HOST = ("long videos on the host", f"{PORT}.parallel.engine:GpuSearchEngine._long_video_pairs", False)
#: the program's SQLite database (db/): its statements, commits, file-hash
#: lookups and blob reads, on the step's thread
DATABASE = tuple(
    ("database", target, False)
    for target in (
        f"{PORT}.db.DedupeDB:DedupeDb.execute",
        f"{PORT}.db.DedupeDB:DedupeDb.executemany",
        f"{PORT}.db.DedupeDB:DedupeDb.commit",
        f"{PORT}.db.DedupeDB:DedupeDb.get_file_hash",
        f"{PORT}.db.blobs:fetch_blobs",
    )
)
#: every request to the Hydrus client API (client/), the in-process fake
#: server's handling of it included
CLIENT = ("Hydrus client", f"{PORT}.client.hydrus_api:Client._request", False)

#: the orchestrator's children: a step's time outside all of them is the
#: orchestrator's own (dedup.py: the chunk loop, the marking, numpy)
CHILDREN = (STAGE2, CLUSTERING, STAGING, ROUTE, VERIFY, SIMILARITIES, BUCKETED, LONG_HOST,
            *DATABASE, CLIENT)

K1 = ("exists_mask_sweep", f"{PORT}.ops.similarity_segments:exists_mask_sweep", roofline.sweep_work)
K3 = ("similarity_segments", f"{PORT}.ops.similarity_segments:similarity_segments", roofline.segments_work)
