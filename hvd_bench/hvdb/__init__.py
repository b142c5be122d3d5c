"""The benchmark harness of hvd_bench (see hvd_bench/README.md)."""
