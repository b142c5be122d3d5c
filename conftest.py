"""Test settings of the PyTorch port (``hydrus_video_deduplicator_tpu_torch``).

Under pytest-xdist each worker gets its share of the cores: PyTorch's CPU
kernels otherwise start one OpenMP thread per core in every worker, and
with several workers on one machine the threads contend, so work that
takes seconds alone takes minutes. The cap is also set in
``OMP_NUM_THREADS`` for the subprocesses a test starts. Outside xdist
nothing is changed.

``tests/conftest.py`` is the JAX package's test configuration.
"""

from __future__ import annotations

import os


def pytest_configure(config):
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    import torch

    n = max(1, (os.cpu_count() or 1) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch.set_num_threads(n)
