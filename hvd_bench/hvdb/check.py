"""The comparison that decides ``correct``: each step's answers against the
plain reference (``reference.py``), every number with its limit.

What the reference knows of a library (``Truth``):

- every planted pair and its reference similarity;
- every match of a sample of rows drawn from the seed (with the longest
  videos and some empty ones in it) against the whole library;
- the reference similarity of any pair a step reports, worked out when it
  is first seen.

A step is held to three things: no pair the reference finds at or above
the minimum similarity among the planted pairs and the sampled rows is
missing (``missing``); no pair it reports lies below that similarity in
the reference (``extra``); and the cell's own guarantees, below. Every
limit is 0: the search is exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import reference

LIMIT = 0


@dataclass
class Truth:
    blobs: list
    min_sim: int
    want: set  # (a, b), a < b: every pair the reference finds at or above min_sim
    scope: int = 0  # pairs with both videos below this index are out of scope
    sims: dict = field(default_factory=dict)  # (a, b) -> the reference similarity

    def sim(self, a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in self.sims:
            n = len(self.blobs)
            ok = 0 <= key[0] < n and 0 <= key[1] < n and key[0] != key[1]
            self.sims[key] = reference.similarity(self.blobs[key[0]], self.blobs[key[1]]) if ok else -1
        return self.sims[key]


def sample_rows(rng: np.random.Generator, lens: np.ndarray, candidates: np.ndarray, traffic: dict):
    """``sample_rows`` random rows of ``candidates``, with the
    ``sample_longest`` longest and ``sample_empty`` empty ones among them."""
    c_lens = lens[candidates]
    picked = set(rng.choice(candidates, size=min(traffic["sample_rows"], len(candidates)), replace=False).tolist())
    longest = candidates[np.argsort(-c_lens, kind="stable")[: traffic.get("sample_longest", 0)]]
    empty = candidates[c_lens == 0][: traffic.get("sample_empty", 0)]
    picked.update(longest.tolist())
    picked.update(empty.tolist())
    return np.asarray(sorted(picked), dtype=np.int64)


def build_truth(blobs, planted, min_sim, sample, device, scope: int = 0) -> Truth:
    """The reference's pairs: the planted ones and every match of the
    sampled rows (against the whole library), those at or above min_sim,
    each with its similarity, keeping only pairs with a video at or past
    ``scope``."""
    truth = Truth(blobs, min_sim, set(), scope)
    for a, b in planted:
        if max(a, b) >= scope and truth.sim(a, b) >= min_sim:
            truth.want.add((min(a, b), max(a, b)))
    for r, matches in reference.row_matches(blobs, sample, min_sim, device).items():
        for j, s in matches.items():
            if j != r:
                key = (min(r, j), max(r, j))
                truth.sims[key] = s
                if key[1] >= scope:
                    truth.want.add(key)
    return truth


@dataclass
class Verdict:
    numbers: dict = field(default_factory=dict)  # name -> value, each held to LIMIT
    attempted: int = 0
    failed: int = 0

    def add(self, step_numbers: dict) -> None:
        self.attempted += 1
        self.failed += any(v > LIMIT for v in step_numbers.values())
        for k, v in step_numbers.items():
            self.numbers[k] = self.numbers.get(k, 0) + v

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and self.failed == 0

    def as_json(self) -> dict:
        return {k: {"value": v, "limit": LIMIT} for k, v in self.numbers.items()}


def marked_step(truth: Truth, pairs: set, posts: list, count: int, unsearched: int,
                delta: bool) -> dict:
    """One scene step's numbers: ``pairs`` the unordered index pairs the
    fake server holds after it, ``posts`` every pair POSTed, ``count`` what
    deduplicate() returned, ``unsearched`` the files its search cache left
    unmarked. A fresh search returns the number of pairs it marked; a
    delta follows the reference's rule (a pair with a searched video one
    event, a pair of two new videos two, halved) and POSTs no pair of two
    searched videos."""
    extra = sum(1 for a, b in pairs if truth.sim(a, b) < truth.min_sim)
    numbers = {
        "missing": len(truth.want - pairs),
        "extra": extra,
        "unsearched": unsearched,
        "dup_posts": len(posts) - len(set(posts)),
    }
    if delta:
        old = sum(1 for a, b in pairs if max(a, b) < truth.scope)
        new_new = sum(1 for a, b in pairs if min(a, b) >= truth.scope)
        numbers["old_pairs"] = old
        numbers["count_wrong"] = int(count != (len(pairs) - old - new_new + 2 * new_new) // 2)
    else:
        numbers["count_wrong"] = int(count != len(pairs))
    return numbers


def sweep_step(truth: Truth, hits: np.ndarray, lens: np.ndarray) -> dict:
    """One sweep step's numbers from its (row, col, similarity) triples:
    every non-empty video matches itself at 100 once (``self_wrong``), and
    every other reported similarity equals the reference's
    (``sim_wrong``)."""
    i, j, s = hits[:, 0], hits[:, 1], hits[:, 2]
    own = i == j
    self_ids, self_n = np.unique(i[own], return_counts=True)
    nonempty = int((lens > 0).sum())
    self_wrong = (
        int((s[own] != 100).sum()) + int((self_n > 1).sum())
        + abs(nonempty - len(self_ids)) + int((lens[self_ids] == 0).sum())
    )
    keys = set()
    sim_wrong = 0
    for a, b, sab in zip(i[~own].tolist(), j[~own].tolist(), s[~own].tolist()):
        keys.add((min(a, b), max(a, b)))
        sim_wrong += int(truth.sim(a, b) != sab)
    return {
        "missing": len(truth.want - keys),
        "extra": sum(1 for a, b in keys if truth.sim(a, b) < truth.min_sim),
        "sim_wrong": sim_wrong,
        "self_wrong": self_wrong,
    }
