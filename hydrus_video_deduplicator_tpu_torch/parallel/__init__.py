"""The port's search engine (counterpart of the JAX package's ``parallel``)."""

from .engine import CorpusIndex, GpuSearchEngine  # noqa: F401
