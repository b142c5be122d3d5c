"""hydrus_video_deduplicator_tpu_torch — the PyTorch + CUDA port.

The JAX package ``hydrus_video_deduplicator_tpu`` is the reference. This
package keeps its module layout so each counterpart is easy to find, and
runs stage 1, perceptual hashing, stage 4, the exact all-pairs search, and
the embedding rerank on an NVIDIA GPU, or sharded over several:

- ``models.pdq``              — the plain PyTorch PDQ pipeline, bit-exact to
                                the numpy oracle.
- ``ops.pdq_filter``          — the wrapper of the hand-written CUDA PDQ
                                filter kernel (``csrc/``) and the fused hash.
- ``models.vpdq``             — ``GpuVideoHasher``, the device-batched
                                video hasher of stage 1.
- ``ops.similarity``          — bit-packed hash primitives (numpy + torch).
- ``ops.similarity_segments`` — the segment packers, the plain PyTorch
                                existence mask sweep and segment similarity,
                                and the wrappers of their CUDA kernels.
- ``ops.similarity_block``    — the bucketed video-pair similarity block
                                and the wrapper of its CUDA kernel.
- ``ops.pair_verify``         — exact similarity of candidate pairs.
- ``parallel.engine``         — ``GpuSearchEngine``, the pruned and the
                                unpruned search.
- ``parallel.mesh``           — device meshes: the hasher and the engine
                                shard their rows over the members;
                                ``parallel.dryrun`` checks every stage on
                                a mesh against one device.
- ``models.embed``            — the vision tower of the embedding rerank
                                (a ViT in float32 torch ops), with
                                ``models.convert_clip`` (CLIP checkpoints)
                                and ``rerank`` (the pair gate).
- ``utils``                   — ``trace_to``, ``device_timer`` and the
                                device busy share of a trace.
- ``dedup`` / ``entrypoint``  — the orchestrator and the CLI; ``gui`` the
                                optional PySide6 GUI.

The host layer is the package's own copy of the JAX package's host modules,
under the same names: ``client``, ``config``, ``db``, ``decode``,
``dedup_util``, ``hashing``, ``native`` (the C++ hasher, ``matchHashBytes``
and rep clustering, built by ``make`` into ``native/build/`` at first use,
or prebuilt there by the wheel),
``ops.reps``, ``page_logger`` and ``vpdq``. The package imports neither
``jax`` nor anything of the JAX package.
"""

from .__about__ import __version__  # noqa: F401
