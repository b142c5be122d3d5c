"""Learned-embedding rerank of candidate duplicate pairs (counterpart of
the JAX package's ``rerank.py``).

After the pHash prefilter proposes pairs, a vision tower (models/embed.py;
e.g. a converted CLIP ViT checkpoint) embeds each candidate video and the
pair is kept only when the cosine similarity of the two embeddings clears
``--rerank-threshold``. This catches perceptual-hash false positives; it
never *adds* pairs (the pHash stage remains the recall gate).

Only candidate files are embedded: their bytes are re-fetched from Hydrus
and decoded at 1 fps (capped), so no database schema changes and no cost
for non-candidates. Embeddings are cached per file for the run.
"""

from __future__ import annotations

import logging
from collections.abc import Callable

import numpy as np

log = logging.getLogger("rerank")

#: frames per video fed to the tower (1 fps sampled; long videos capped)
MAX_EMBED_FRAMES = 32


class ClipReranker:
    """Pairwise gate: cosine(embed(a), embed(b)) >= threshold.

    device: the torch device of the tower; None is the CUDA device (and
    raises without one), "cpu" runs it on the CPU.
    """

    def __init__(
        self,
        weights_path: str,
        threshold: float = 0.85,
        sampling: str = "uniform",
        device=None,
    ):
        from .models.embed import VisionEmbedder

        self.embedder = VisionEmbedder(weights_path, device)
        self.threshold = float(threshold)
        self.sampling = sampling
        self._cache: dict[str, np.ndarray | None] = {}
        self.pairs_checked = 0
        self.pairs_rejected = 0

    def _embed(self, file_hash: str, fetch: "Callable[[str], bytes]"):
        if file_hash in self._cache:
            return self._cache[file_hash]
        emb = None
        try:
            from .decode import extract_frames

            frames = []
            for f in extract_frames(fetch(file_hash), sampling=self.sampling):
                frames.append(f)
                if len(frames) >= MAX_EMBED_FRAMES:
                    break
            if frames:
                emb = self.embedder.embed_video(np.stack(frames))
        except Exception as exc:  # fetch/decode failure: don't gate the pair
            log.warning("rerank embed failed for %s: %s", file_hash, exc)
        self._cache[file_hash] = emb
        return emb

    def pair_passes(
        self, hash_a: str, hash_b: str, fetch: "Callable[[str], bytes]"
    ) -> bool:
        """True when the pair survives the embedding gate. Pairs whose
        embeddings cannot be computed pass (fail-open: the pHash stage
        already deemed them candidates)."""
        self.pairs_checked += 1
        ea = self._embed(hash_a, fetch)
        eb = self._embed(hash_b, fetch)
        if ea is None or eb is None:
            return True
        if float(np.dot(ea, eb)) >= self.threshold:
            return True
        self.pairs_rejected += 1
        return False
