"""The port's search engine, its device meshes and the multi-device dry
run (counterpart of the JAX package's ``parallel``)."""

from .engine import CorpusIndex, GpuSearchEngine  # noqa: F401
