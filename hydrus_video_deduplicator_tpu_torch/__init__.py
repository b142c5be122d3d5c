"""hydrus_video_deduplicator_tpu_torch — the PyTorch + CUDA port.

The JAX package ``hydrus_video_deduplicator_tpu`` is the reference. This
package keeps its module layout so each counterpart is easy to find, and
runs stage 1, perceptual hashing, and stage 4, the exact pruned all-pairs
search, on an NVIDIA GPU:

- ``models.pdq``              — the plain PyTorch PDQ pipeline, bit-exact to
                                the numpy oracle.
- ``ops.pdq_filter``          — the wrapper of the hand-written CUDA PDQ
                                filter kernel (``csrc/``) and the fused hash.
- ``models.vpdq``             — ``GpuVideoHasher``, the device-batched
                                video hasher of stage 1.
- ``ops.similarity``          — bit-packed hash primitives (numpy + torch).
- ``ops.similarity_segments`` — the segment packers, the plain PyTorch
                                existence mask sweep and the wrapper of its
                                hand-written CUDA kernel.
- ``ops.pair_verify``         — exact similarity of candidate pairs.
- ``parallel.engine``         — ``GpuSearchEngine``, the pruned search.
- ``dedup`` / ``entrypoint``  — the orchestrator and the CLI.

Host-only modules (``client``, ``db``, ``decode``, ``native``, ``vpdq``,
``ops.reps``, ``config``, the orchestrator base class) are imported from
the JAX package; none of them imports ``jax``, and neither does this
package.
"""

from hydrus_video_deduplicator_tpu.__about__ import __version__  # noqa: F401
