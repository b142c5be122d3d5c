"""Step kind ``pruned_sweep``: one exact all-pairs sweep of a scene library
held in memory, through ``GpuSearchEngine.find_pairs_pruned`` a row chunk,
as stage 4's checkpoint loop calls it (``dedup._find_potential_duplicates_gpu``:
``rows_at`` the chunk's first row, ``col_limit`` its end in a triangle).

Each step makes a new engine and a new ``col_state``, so the columns are
clustered into scene leaders (``ops/reps.py``) and staged on the device
inside the step, as on a user's run. The library is the frozen scene model
that ``SceneCell`` draws; what a step leaves and how it is checked are the
sweep's (``hvdb.cells.SweepCell``, ``check.sweep_step``).
"""

from hvdb import library
from hvdb.cells import SweepCell


class Cell(SweepCell):
    def build(self) -> None:
        cfg = self.config
        self.blobs, _, _, self.planted = library.build_corpus(
            cfg["n_videos"], seed=self.seed, clip=cfg["clip_frames"],
            long_plants=tuple(cfg["long_plants"]), median=cfg["median_frames"],
        )
        self.n = len(self.blobs)
        self.log(f"library: {self.n} videos, {sum(map(len, self.blobs)) // 32} frames")

    def step(self) -> None:
        from hydrus_video_deduplicator_tpu_torch.parallel.engine import GpuSearchEngine

        chunk = self.traffic["chunk_rows"]
        triangle = self.traffic["mode"] == "triangle"
        engine = GpuSearchEngine(device=self.device)
        col_state: dict = {}
        self.hits = [
            (i0, engine.find_pairs_pruned(
                self.blobs[i0 : i0 + chunk], self.blobs, self.min_sim, col_state=col_state,
                col_limit=min(i0 + chunk, self.n) if triangle else None, rows_at=i0,
            ))
            for i0 in range(0, self.n, chunk)
        ]


__all__ = ["Cell"]
