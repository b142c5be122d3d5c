"""The JAX package's recorded Hydrus session through the port.

The counterpart of ``tests/acceptance_tests/test_main_recorded.py``: the
committed cassette (``tests/fixtures/cassette_main.json.zip``, recorded
from the JAX package's ``main()``) replays through the port's
``entrypoint.main(..., device="cpu")`` with no live server. Every request
the port's client emits must match the recorded one exactly (method, path,
query, JSON body, in order), and every recorded request must be made.

The session's four files are below the orchestrator's GPU_ENGINE_MIN_BATCH,
so ``--search-backend auto`` takes the VP-tree, as in the recording, and
the search prefilter must change no request; the hash backend decides how
stage 1 hashes (``gpu`` runs the GPU hasher's plain PyTorch version here).
"""

from __future__ import annotations

import uuid

import pytest
import requests

from hydrus_video_deduplicator_tpu_torch.entrypoint import main

from . import cassette
from .fake_hydrus import DEFAULT_ACCESS_KEY


@pytest.mark.parametrize("search_prefilter", ["auto", "none", "reps"])
@pytest.mark.parametrize("hash_backend", ["auto", "native", "gpu"])
def test_port_replays_the_recorded_session(tmp_path, monkeypatch, hash_backend, search_prefilter):
    data = cassette.load_cassette(cassette.CASSETTE_PATH)
    replayer = cassette.Replayer(data["interactions"])
    monkeypatch.setattr(
        requests.Session,
        "request",
        lambda self, method, url, **kw: replayer(self, method, url, **kw),
    )
    pairs = main(
        api_key=DEFAULT_ACCESS_KEY,
        api_url="http://localhost:45869",  # never contacted: replay only
        dedup_database_dir=tmp_path / uuid.uuid4().hex,
        hash_backend=hash_backend,
        search_prefilter=search_prefilter,
        device="cpu",
    )
    assert pairs == data["pairs"]
    replayer.assert_exhausted()
