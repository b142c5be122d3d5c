"""SQLite-persisted vantage-point tree over VPDQ perceptual hashes.

Re-implementation of the reference's Hydrus-derived VP-tree
(upstream src/hydrusvideodeduplicator/db/vptree.py) with identical
observable semantics:

- distance = (100 - int(similarity)) + 1 in [1, 101] (vptree.py:22-31)
- add_leaf: root-to-leaf descent updating populations; marks the ELDEST
  unbalanced ancestor for regeneration when population > 16 and
  smaller:larger < 0.5 (vptree.py:155-283); ghost-inserts under a broken
  branch rather than failing (vptree.py:178-201)
- generate_branch: BFS median-radius splitting, radius to the emptier side
  (vptree.py:315-420)
- pop_best_root_node: scores <=256 sampled viewpoints against <=64 sampled
  distances by balance ratio then stddev (vptree.py:422-495)
- maintain_tree / _regenerate_branch: rebuild flagged branches biggest
  first; recursive CTE to collect a branch; orphan phash pruning
  (vptree.py:520-662)
- search: per-query BFS with triangle-inequality sphere pruning and an
  in-memory node cache capped at 1M entries (vptree.py:664-863)

Design difference (documented, not behavioral): the reference stages id
sets in ATTACHed in-memory temp tables; we use chunked ``IN (...)`` queries
— same results, no connection-global singleton state.

At corpus scale the TPU brute-force engine (parallel/engine.py) supersedes
this tree for searching; the tree remains fully maintained for
compatibility and for incremental CPU-only operation.
"""

from __future__ import annotations

import logging
import random
from collections import deque
from typing import TYPE_CHECKING

from ..vpdq import matchHashBytes

if TYPE_CHECKING:
    from collections.abc import Collection, Iterable

    from .DedupeDB import DedupeDb

log = logging.getLogger("vptree")

#: add_leaf flags an ancestor for regen past this population...
UNBALANCED_POPULATION = 16
#: ...when smaller:larger falls below this ratio.
UNBALANCED_RATIO = 0.5
#: pop_best_root_node sampling bounds.
MAX_VIEWPOINTS = 256
MAX_SAMPLE = 64
#: maintenance_due threshold: this many unsearched files.
MAINTENANCE_DUE_COUNT = 100
#: node cache entry cap.
NODE_CACHE_MAX = 1_000_000

_IN_CHUNK = 500  # SQLite default variable limit is 999


def fix_vpdq_similarity(similarity: float) -> int:
    """Map similarity [100.0, 0.0] to tree distance [1, 101]."""
    return (100 - int(similarity)) + 1


def calculate_distance(phash_a: bytes, phash_b: bytes) -> int:
    """Distance in [1, 101] between two packed perceptual hashes (1 = most
    similar). Dispatches to the native/numpy similarity backend."""
    return fix_vpdq_similarity(matchHashBytes(phash_a, phash_b, 31))


def _dedupe_keep_order(xs: Iterable) -> list:
    seen = set()
    out = []
    for x in xs:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


class VpTreeManager:
    def __init__(self, db: "DedupeDb"):
        self.db = db
        self._node_cache: dict[int, tuple] = {}
        self._not_in_tree: set[int] = set()
        self._root_id: int | None = None
        self._reported_broken_branch = False

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _rows_for_ids(self, query_fmt: str, ids: Collection[int]) -> list:
        """Run ``query_fmt`` (containing one {}) over ids in chunks."""
        ids = list(ids)
        rows = []
        for i in range(0, len(ids), _IN_CHUNK):
            chunk = ids[i : i + _IN_CHUNK]
            placeholders = ",".join("?" * len(chunk))
            rows.extend(self.db.execute(query_fmt.format(placeholders), chunk).fetchall())
        return rows

    def _invalidate_cache(self, phash_ids: Collection[int]) -> None:
        for pid in phash_ids:
            self._node_cache.pop(pid, None)
            self._not_in_tree.discard(pid)
            if self._root_id == pid:
                self._root_id = None

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------

    def add_leaf(self, phash_id: int, phash: bytes) -> None:
        """Insert a perceptual hash as a new leaf (no-op placement if the
        tree is empty: the first insert becomes the root).

        Guard (deliberate divergence from the reference): if this phash_id is
        already a tree member — files can share identical perceptual hashes —
        the insert is a no-op. The reference re-inserts unconditionally
        (DedupeDB.py:287-324 -> vptree.py:155), which REPLACEs the existing
        node row, self-parents it, and orphans its subtree — the likely
        source of its "broken branch detected" failure mode (vptree.py:178-201).
        """
        if self.db.execute(
            "SELECT 1 FROM shape_vptree WHERE phash_id = ?", (phash_id,)
        ).fetchone():
            return
        root = self.db.execute(
            "SELECT phash_id FROM shape_vptree WHERE parent_id IS NULL"
        ).fetchone()

        parent_id = None
        inside: list[int] = []
        outside: list[int] = []

        if root is not None:
            ancestor_id = root[0]
            flagged_unbalanced = False
            while ancestor_id is not None:
                row = self.db.execute(
                    "SELECT phash, radius, inner_id, inner_population, outer_id,"
                    " outer_population FROM shape_perceptual_hashes NATURAL JOIN"
                    " shape_vptree WHERE phash_id = ?",
                    (ancestor_id,),
                ).fetchone()
                if row is None:
                    # Hole in the tree (crash desync). Ghost-insert here; the
                    # next regen pass repairs the branch.
                    if not self._reported_broken_branch:
                        msg = (
                            "Broken branch detected in the similar-files search tree."
                            " Restart, or rebuild with '--clear-search-tree'."
                        )
                        print(msg)
                        log.error("%s (phash_id=%s ancestor=%s)", msg, phash_id, ancestor_id)
                        self._reported_broken_branch = True
                    parent_id = ancestor_id
                    break

                (a_phash, a_radius, a_inner, a_inner_pop, a_outer, a_outer_pop) = row
                distance = calculate_distance(phash, a_phash)

                if a_radius is None or distance <= a_radius:
                    inside.append(ancestor_id)
                    a_inner_pop += 1
                    next_id = a_inner
                    if a_inner is None:
                        self.db.execute(
                            "UPDATE shape_vptree SET inner_id = ?, radius = ? WHERE phash_id = ?",
                            (phash_id, distance, ancestor_id),
                        )
                        self._invalidate_cache((ancestor_id,))
                        parent_id = ancestor_id
                else:
                    outside.append(ancestor_id)
                    a_outer_pop += 1
                    next_id = a_outer
                    if a_outer is None:
                        self.db.execute(
                            "UPDATE shape_vptree SET outer_id = ? WHERE phash_id = ?",
                            (phash_id, ancestor_id),
                        )
                        self._invalidate_cache((ancestor_id,))
                        parent_id = ancestor_id

                if (
                    not flagged_unbalanced
                    and a_inner_pop + a_outer_pop > UNBALANCED_POPULATION
                ):
                    smaller, larger = sorted((a_inner_pop, a_outer_pop))
                    if smaller / larger < UNBALANCED_RATIO:
                        # only the eldest unbalanced ancestor: its rebuild
                        # re-balances all descendants anyway
                        self.db.execute(
                            "INSERT OR IGNORE INTO shape_maintenance_branch_regen"
                            " ( phash_id ) VALUES ( ? )",
                            (ancestor_id,),
                        )
                        flagged_unbalanced = True

                ancestor_id = next_id

            for pid in inside:
                self.db.execute(
                    "UPDATE shape_vptree SET inner_population = inner_population + 1"
                    " WHERE phash_id = ?",
                    (pid,),
                )
            for pid in outside:
                self.db.execute(
                    "UPDATE shape_vptree SET outer_population = outer_population + 1"
                    " WHERE phash_id = ?",
                    (pid,),
                )
            self._invalidate_cache(inside)
            self._invalidate_cache(outside)

        self.db.execute(
            "INSERT OR REPLACE INTO shape_vptree ( phash_id, parent_id, radius,"
            " inner_id, inner_population, outer_id, outer_population )"
            " VALUES ( ?, ?, NULL, NULL, 0, NULL, 0 )",
            (phash_id, parent_id),
        )
        self._invalidate_cache((phash_id,))

    # ------------------------------------------------------------------
    # (re)generation
    # ------------------------------------------------------------------

    def pop_best_root_node(self, node_rows: list) -> tuple:
        """Pick (and remove) the best vantage point from (id, phash) rows.

        Scores up to MAX_VIEWPOINTS candidates against up to MAX_SAMPLE
        sampled rows: prefer a balanced median split (ratio score), break
        ties by larger distance stddev (less sphere overlap when searching).
        """
        if len(node_rows) == 1:
            return node_rows.pop()

        viewpoints = (
            random.sample(node_rows, MAX_VIEWPOINTS)
            if len(node_rows) > MAX_VIEWPOINTS
            else node_rows
        )
        sample = (
            random.sample(node_rows, MAX_SAMPLE) if len(node_rows) > MAX_SAMPLE else node_rows
        )

        scores = []
        for v_id, v_phash in viewpoints:
            views = sorted(
                calculate_distance(v_phash, s_phash)
                for s_id, s_phash in sample
                if s_id != v_id
            )
            radius = views[len(views) // 2]
            num_left = sum(1 for d in views if d < radius)
            num_radius = sum(1 for d in views if d == radius)
            num_right = sum(1 for d in views if d > radius)
            if num_left <= num_right:
                num_left += num_radius
            else:
                num_right += num_radius
            smaller, larger = sorted((num_left, num_right))
            ratio_score = int(smaller / larger * MAX_SAMPLE / 2)
            mean = sum(views) / len(views)
            sd = (sum((d - mean) ** 2 for d in views) / len(views)) ** 0.5
            scores.append((ratio_score, sd, v_id))

        scores.sort()
        best_id = scores[-1][2]
        for i, (v_id, _) in enumerate(node_rows):
            if v_id == best_id:
                return node_rows.pop(i)
        raise AssertionError("best root not found in rows")

    def generate_branch(self, parent_id, phash_id, phash, children: list) -> None:
        """Build a balanced branch below parent_id via BFS median splitting."""
        queue = deque([(parent_id, phash_id, phash, children)])
        insert_rows = []
        touched = set()

        while queue:
            parent_id, node_id, node_phash, node_children = queue.popleft()

            if not node_children:
                radius = inner_id = outer_id = None
                inner_pop = outer_pop = 0
            else:
                with_distance = sorted(
                    (calculate_distance(node_phash, c_phash), c_id, c_phash)
                    for c_id, c_phash in node_children
                )
                median_radius = with_distance[len(with_distance) // 2][0]
                inner = [(cid, cph) for d, cid, cph in with_distance if d < median_radius]
                at_radius = [(cid, cph) for d, cid, cph in with_distance if d == median_radius]
                outer = [(cid, cph) for d, cid, cph in with_distance if d > median_radius]
                if len(inner) <= len(outer):
                    radius = median_radius
                    inner.extend(at_radius)
                else:
                    radius = median_radius - 1
                    outer.extend(at_radius)
                inner_pop, outer_pop = len(inner), len(outer)
                inner_id, inner_phash = self.pop_best_root_node(inner)
                if outer:
                    outer_id, outer_phash = self.pop_best_root_node(outer)
                else:
                    outer_id = None

            insert_rows.append(
                (node_id, parent_id, radius, inner_id, inner_pop, outer_id, outer_pop)
            )
            touched.add(node_id)
            if inner_id is not None:
                queue.append((node_id, inner_id, inner_phash, inner))
            if outer_id is not None:
                queue.append((node_id, outer_id, outer_phash, outer))

        self.db.executemany(
            "INSERT OR REPLACE INTO shape_vptree ( phash_id, parent_id, radius,"
            " inner_id, inner_population, outer_id, outer_population )"
            " VALUES ( ?, ?, ?, ?, ?, ?, ? )",
            insert_rows,
        )
        self._invalidate_cache(touched)

    def regenerate_tree(self) -> None:
        """Full rebuild from all stored perceptual hashes."""
        log.info("regenerating similar-files search tree")
        self.db.execute(
            "DELETE FROM shape_perceptual_hash_map WHERE hash_id NOT IN"
            " ( SELECT hash_id FROM files )"
        )
        self.db.execute("DELETE FROM shape_vptree")
        self._node_cache.clear()
        self._not_in_tree.clear()
        self._root_id = None

        all_nodes = self.db.execute(
            "SELECT phash_id, phash FROM shape_perceptual_hashes"
        ).fetchall()
        if not all_nodes:
            self.db.execute("DELETE FROM shape_maintenance_branch_regen")
            return
        root_id, root_phash = self.pop_best_root_node(all_nodes)
        self.generate_branch(None, root_id, root_phash, all_nodes)
        self.db.execute("DELETE FROM shape_maintenance_branch_regen")

    def _regenerate_branch(self, phash_id: int) -> None:
        row = self.db.execute(
            "SELECT parent_id FROM shape_vptree WHERE phash_id = ?", (phash_id,)
        ).fetchone()
        if row is None:
            self.db.execute(
                "DELETE FROM shape_maintenance_branch_regen WHERE phash_id = ?", (phash_id,)
            )
            return
        (parent_id,) = row
        if parent_id is None:
            # can't rebalance the root against a parent; clear the flag
            self.db.execute(
                "DELETE FROM shape_maintenance_branch_regen WHERE phash_id = ?", (phash_id,)
            )
            return

        # collect the whole branch (UNION, not UNION ALL: robust to cycles in
        # a damaged graph)
        branch = self.db.execute(
            "WITH RECURSIVE branch ( branch_phash_id ) AS ("
            " SELECT ? UNION SELECT phash_id FROM shape_vptree, branch"
            " ON parent_id = branch_phash_id )"
            " SELECT branch_phash_id, phash FROM branch, shape_perceptual_hashes"
            " ON phash_id = branch_phash_id",
            (phash_id,),
        ).fetchall()

        branch_ids = {pid for pid, _ in branch}
        log.info("regenerating branch of %d nodes at %s", len(branch_ids), phash_id)
        self._rows_for_ids("DELETE FROM shape_vptree WHERE phash_id IN ({})", branch_ids)
        self._invalidate_cache(branch_ids)
        self._rows_for_ids(
            "DELETE FROM shape_maintenance_branch_regen WHERE phash_id IN ({})", branch_ids
        )

        useful_ids = {
            pid
            for (pid,) in self._rows_for_ids(
                "SELECT DISTINCT phash_id FROM shape_perceptual_hash_map"
                " WHERE phash_id IN ({})",
                branch_ids,
            )
        }
        orphans = branch_ids - useful_ids
        self._rows_for_ids(
            "DELETE FROM shape_perceptual_hashes WHERE phash_id IN ({})", orphans
        )

        useful_nodes = [row for row in branch if row[0] in useful_ids]
        useful_population = len(useful_nodes)  # before popping the new root
        if useful_nodes:
            new_root_id, new_root_phash = self.pop_best_root_node(useful_nodes)
        else:
            new_root_id = new_root_phash = None

        parent = self.db.execute(
            "SELECT inner_id FROM shape_vptree WHERE phash_id = ?", (parent_id,)
        ).fetchone()
        if parent is None:
            self.db.execute("DELETE FROM shape_maintenance_branch_regen")
            msg = (
                "The similar-files search tree looks damaged."
                " Please rebuild it with '--clear-search-tree'."
            )
            log.error(msg)
            print(msg)
            return
        (parent_inner_id,) = parent
        side = "inner" if parent_inner_id == phash_id else "outer"
        self.db.execute(
            f"UPDATE shape_vptree SET {side}_id = ?, {side}_population = ?"
            " WHERE phash_id = ?",
            (new_root_id, useful_population, parent_id),
        )
        self._invalidate_cache((parent_id,))
        if useful_nodes:
            self.generate_branch(parent_id, new_root_id, new_root_phash, useful_nodes)

    def maintain_tree(self) -> None:
        """Rebuild all flagged branches, biggest population first."""
        while True:
            flagged = [
                pid
                for (pid,) in self.db.execute(
                    "SELECT phash_id FROM shape_maintenance_branch_regen"
                ).fetchall()
            ]
            if not flagged:
                return
            rows = self._rows_for_ids(
                "SELECT phash_id, inner_population + outer_population FROM shape_vptree"
                " WHERE phash_id IN ({})",
                flagged,
            )
            if not rows:
                self.db.execute("DELETE FROM shape_maintenance_branch_regen")
                return
            biggest = max(rows, key=lambda r: r[1])[0]
            self._regenerate_branch(biggest)

    def maintenance_due(self, search_distance: int) -> bool:
        (count,) = self.db.execute(
            "SELECT COUNT(*) FROM ( SELECT 1 FROM shape_search_cache WHERE"
            " searched_distance IS NULL OR searched_distance < ? LIMIT ? )",
            (search_distance, MAINTENANCE_DUE_COUNT),
        ).fetchone()
        return count >= MAINTENANCE_DUE_COUNT

    def reset_search(self, hash_ids: list[int]) -> None:
        self._rows_for_ids(
            "UPDATE shape_search_cache SET searched_distance = NULL WHERE hash_id IN ({})",
            hash_ids,
        )

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _populate_node_cache(self, phash_ids: Collection[int]) -> None:
        if len(self._node_cache) > NODE_CACHE_MAX:
            keep = set(phash_ids)
            self._node_cache = {
                pid: node for pid, node in self._node_cache.items() if pid in keep
            }
        missing = {
            pid
            for pid in phash_ids
            if pid not in self._node_cache and pid not in self._not_in_tree
        }
        if not missing:
            return
        rows = self._rows_for_ids(
            "SELECT phash_id, phash, radius, inner_id, outer_id FROM"
            " shape_perceptual_hashes CROSS JOIN shape_vptree USING ( phash_id )"
            " WHERE phash_id IN ({})",
            missing,
        )
        found = {pid: (phash, radius, inner, outer) for pid, phash, radius, inner, outer in rows}
        self._not_in_tree.update(missing - set(found))
        self._node_cache.update(found)

    def search_perceptual_hashes(
        self, search_phashes: Collection[bytes], max_hamming_distance: int
    ) -> list[tuple[int, int]]:
        """BFS tree search: (hash_id, distance) for all files within
        max_hamming_distance of any of the given perceptual hashes."""
        results: list[tuple[int, int]] = []
        if not search_phashes:
            return results

        if max_hamming_distance == 0:
            phash_ids = {
                pid
                for pid in (self.db.get_phash_id(p) for p in search_phashes)
                if pid is not None
            }
            rows = self._rows_for_ids(
                "SELECT hash_id FROM shape_perceptual_hash_map WHERE phash_id IN ({})",
                phash_ids,
            )
            results.extend((hash_id, 0) for (hash_id,) in rows)
            return _dedupe_keep_order(results)

        if self._root_id is None:
            root = self.db.execute(
                "SELECT phash_id FROM shape_vptree WHERE parent_id IS NULL"
            ).fetchone()
            if root is None:
                return results
            self._root_id = root[0]

        similar_pid_to_distance: dict[int, int] = {}
        total_nodes = cycles = 0
        for search_phash in search_phashes:
            frontier = [self._root_id]
            while frontier:
                cycles += 1
                total_nodes += len(frontier)
                self._populate_node_cache(frontier)
                next_frontier = []
                for pid in frontier:
                    node = self._node_cache.get(pid)
                    if node is None:
                        continue  # broken branch; skip
                    node_phash, radius, inner_id, outer_id = node
                    distance = calculate_distance(search_phash, node_phash)
                    if distance <= max_hamming_distance:
                        prev = similar_pid_to_distance.get(pid)
                        if prev is None or distance < prev:
                            similar_pid_to_distance[pid] = distance
                    if radius is not None:
                        # sphere intersection pruning: recurse inside unless
                        # disjoint; recurse outside unless the search sphere
                        # is fully inside the node sphere
                        if inner_id is not None and distance <= radius + max_hamming_distance:
                            next_frontier.append(inner_id)
                        if outer_id is not None and distance + max_hamming_distance > radius:
                            next_frontier.append(outer_id)
                frontier = next_frontier
        log.debug("search touched %d nodes over %d cycles", total_nodes, cycles)

        # map phash matches to files; a file keeps its smallest distance
        rows = self._rows_for_ids(
            "SELECT phash_id, hash_id FROM shape_perceptual_hash_map WHERE phash_id IN ({})",
            list(similar_pid_to_distance),
        )
        hash_id_to_distance: dict[int, int] = {}
        for pid, hash_id in rows:
            d = similar_pid_to_distance[pid]
            if hash_id not in hash_id_to_distance or d < hash_id_to_distance[hash_id]:
                hash_id_to_distance[hash_id] = d
        results.extend(hash_id_to_distance.items())
        return _dedupe_keep_order(results)

    def search_file(self, hash_id: int, max_hamming_distance: int) -> list[tuple[int, int]]:
        """Search for files similar to an already-stored file (includes the
        file itself at distance 0, like the reference)."""
        results = [(hash_id, 0)]
        if max_hamming_distance == 0:
            rows = self.db.execute(
                "SELECT hash_id FROM shape_perceptual_hash_map WHERE phash_id IN"
                " ( SELECT phash_id FROM shape_perceptual_hash_map WHERE hash_id = ? )",
                (hash_id,),
            ).fetchall()
            results.extend((h, 0) for (h,) in rows)
        else:
            phash_id = self.db.get_phash_id_from_hash_id(hash_id)
            assert phash_id is not None
            phash = self.db.get_phash(phash_id)
            assert phash is not None
            results.extend(self.search_perceptual_hashes([phash], max_hamming_distance))
        return _dedupe_keep_order(results)
