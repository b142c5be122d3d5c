"""Shared utilities: profiling/tracing helpers and timing tools."""

from .profiling import device_timer, trace_to  # noqa: F401
