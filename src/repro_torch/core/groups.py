"""Label-group lattice: group-by label set and closure sizes.

Terminology (paper §2-§4):
  * group      — all entries whose label set is *exactly* L (inverted list).
  * closure    — ``S(L) = {i : L ⊆ L_i}``: entries whose label set *contains*
                 L; the data a candidate index for query label set L holds.
  * candidate  — one potential index per query label set L, with
                 ``I_L = S(L)`` and cost ``|S(L)|`` (paper Def 3.3: graph
                 degree is bounded by a constant M, so cost ∝ #vectors).

The closure sizes for the full query workload (all label combinations that
appear as subsets of base label sets — the paper's default, §3.2) are
computed by subset expansion over the distinct groups: for each group G we
add |G| to every subset key of G.  Cost O(Σ_G 2^|G|), exactly the paper's
§4.2 bound O(Σ 2^|L_i|) — but over *distinct* groups, which under Zipf is
orders of magnitude smaller than over entries.

Ported from the JAX package without the baselines'
``minimal_superset_dag`` (their slice ports it).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .labels import (NUM_WORDS, encode_label_set, key_contains, key_subsets,
                     mask_key)

EMPTY_KEY: tuple[int, ...] = tuple(0 for _ in range(NUM_WORDS))


@dataclasses.dataclass
class GroupTable:
    """Grouping of a labelled dataset plus closure statistics."""

    n: int                                        # dataset cardinality N
    groups: dict[tuple[int, ...], np.ndarray]     # exact-label-set inverted lists
    closure_sizes: dict[tuple[int, ...], int]     # |S(L)| for every candidate L

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(label_sets: Sequence[tuple[int, ...]],
              query_keys: Sequence[tuple[int, ...]] | None = None) -> "GroupTable":
        """Group entries and compute closure sizes.

        ``query_keys``: restrict the candidate set to these query label sets
        (plus the empty/top key).  Default: all subsets of observed base
        label sets (the paper's "all possible label-containing queries").
        """
        garr = _group_rows(label_sets)

        closure: dict[tuple[int, ...], int] = {}
        if query_keys is None:
            # full subset closure of every distinct group key
            for gkey, rows in garr.items():
                gsize = len(rows)
                for sub in key_subsets(gkey):
                    closure[sub] = closure.get(sub, 0) + gsize
        else:
            wanted = set(query_keys)
            wanted.add(EMPTY_KEY)
            closure = {k: 0 for k in wanted}
            for gkey, rows in garr.items():
                gsize = len(rows)
                for sub in key_subsets(gkey):
                    if sub in wanted:
                        closure[sub] += gsize
            # also count groups that a wanted key covers but whose subsets
            # were not enumerated above (group smaller than key): not
            # possible — sub ⊆ gkey enumeration covers exactly gkey ⊇ sub.
        closure.setdefault(EMPTY_KEY, sum(len(v) for v in garr.values()))
        return GroupTable(n=len(label_sets), groups=garr, closure_sizes=closure)

    @staticmethod
    def build_groups_only(label_sets: Sequence[tuple[int, ...]]) -> "GroupTable":
        """Grouping without the (exponential) closure-size expansion.

        Used by the sampled estimator at large scale: membership is one pass
        over the data; sizes come from the sample.
        """
        return GroupTable(n=len(label_sets), groups=_group_rows(label_sets),
                          closure_sizes={})

    def compacted(self, alive: np.ndarray,
                  appended_label_sets: Sequence[tuple[int, ...]],
                  add_new_candidates: bool = True) -> "GroupTable":
        """Incremental table for a streaming compaction (DESIGN.md §3.6).

        The new table's rows are the surviving old rows (``alive`` bool
        mask; relative order preserved, renumbered 0..n_alive-1) followed
        by ``appended_label_sets`` (the live delta rows).  Group membership
        is remapped with one numpy pass and closure sizes are adjusted
        arithmetically: −dead per subset of each group that lost rows,
        +appended per subset of each appended key.  Only *brand-new*
        candidate keys (subsets first introduced by an appended label set)
        pay a closure scan over the groups.

        ``add_new_candidates=False`` keeps the candidate set fixed — the
        setting for tables built over an explicit (restricted) query
        workload, where appended subsets must not widen the candidate set.
        """
        alive = np.asarray(alive, dtype=bool)
        if alive.shape[0] != self.n:
            raise ValueError(f"alive mask has {alive.shape[0]} rows, "
                             f"table has {self.n}")
        n_alive = int(alive.sum())
        remap = np.full(self.n, -1, dtype=np.int64)
        remap[alive] = np.arange(n_alive)

        closure = dict(self.closure_sizes)
        groups2: dict[tuple[int, ...], np.ndarray] = {}
        for gkey, rows in self.groups.items():
            kept = remap[rows]
            kept = kept[kept >= 0]          # ascending order is preserved
            dead = rows.size - kept.size
            if dead:
                for sub in key_subsets(gkey):
                    if sub in closure:
                        closure[sub] -= dead
            if kept.size:
                groups2[gkey] = kept

        app: dict[tuple[int, ...], list[int]] = {}
        keys: dict[tuple[int, ...], tuple[int, ...]] = {}
        for j, ls in enumerate(appended_label_sets):
            raw = tuple(ls)
            key = keys.get(raw)
            if key is None:     # each distinct set is encoded once
                key = keys[raw] = mask_key(encode_label_set(raw))
            app.setdefault(key, []).append(n_alive + j)
        fresh: list[tuple[int, ...]] = []
        for gkey, ids in app.items():
            arr = np.asarray(ids, dtype=np.int64)
            groups2[gkey] = (np.concatenate([groups2[gkey], arr])
                             if gkey in groups2 else arr)
            for sub in key_subsets(gkey):
                if sub in closure:
                    closure[sub] += len(ids)
                elif add_new_candidates:
                    fresh.append(sub)
        # brand-new candidates: exact closure over the final groups
        for sub in fresh:
            if sub in closure:
                continue
            closure[sub] = sum(int(g.size) for gk, g in groups2.items()
                               if key_contains(gk, sub))

        n_new = n_alive + len(appended_label_sets)
        # as build(): keys no group contains any more stop being
        # candidates; the top key always stays and is exact by arithmetic
        closure = {k: v for k, v in closure.items()
                   if v > 0 or k == EMPTY_KEY}
        closure[EMPTY_KEY] = n_new
        return GroupTable(n=n_new, groups=groups2, closure_sizes=closure)

    # -- queries ------------------------------------------------------------
    def closure_members(self, key: tuple[int, ...]) -> np.ndarray:
        """Row ids of S(L) — entries whose label set contains ``key``.

        One vectorized superset test over the group-key matrix (the
        engine calls this once per selected key over tens of thousands of
        groups at paper scale); the result is the sorted union of the
        containing groups' rows."""
        gkeys, gm = self._group_key_matrix()
        if not gkeys:
            return np.empty(0, dtype=np.int64)
        km = np.array(key, dtype=np.uint64)[None, :]
        hit = np.all((gm & km) == km, axis=1)
        parts = [self.groups[gkeys[g]] for g in np.flatnonzero(hit)]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(parts))

    def _group_key_matrix(self) -> tuple[list, np.ndarray]:
        """The group keys and their [G, W] uint64 matrix, built once per
        ``groups`` dict (a table's groups are never mutated in place)."""
        cached = getattr(self, "_gkey_cache", None)
        if cached is None or cached[0] is not self.groups:
            gkeys = list(self.groups)
            gm = np.array(gkeys, dtype=np.uint64).reshape(len(gkeys), -1)
            cached = self._gkey_cache = (self.groups, gkeys, gm)
        return cached[1], cached[2]


def _group_rows(label_sets: Sequence[tuple[int, ...]]
                ) -> dict[tuple[int, ...], np.ndarray]:
    """Exact-label-set inverted lists, keyed by bitmask key in order of
    first appearance.  Each distinct set is encoded once."""
    keys: dict[tuple[int, ...], tuple[int, ...]] = {}
    groups: dict[tuple[int, ...], list[int]] = {}
    for i, ls in enumerate(label_sets):
        raw = tuple(ls)
        key = keys.get(raw)
        if key is None:
            key = keys[raw] = mask_key(encode_label_set(raw))
        groups.setdefault(key, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in groups.items()}


def observed_query_keys(query_label_sets: Sequence[tuple[int, ...]]) -> list[tuple[int, ...]]:
    """Distinct query keys from an explicit workload."""
    seen = {mask_key(encode_label_set(q)) for q in query_label_sets}
    return sorted(seen)


def coverage_pairs(closure_sizes: Mapping[tuple[int, ...], int], c: float
                   ) -> dict[tuple[int, ...], list[tuple[int, ...]]]:
    """For every candidate j: the list of candidates i that j covers.

    Index built on S(L_j) can answer query L_i iff L_j ⊆ L_i (so that
    S(L_i) ⊆ S(L_j)) and the elastic factor |S(L_i)|/|S(L_j)| ≥ c.
    Enumeration walks subsets of each L_i (the paper's 2^|L| neighborhood)
    rather than all pairs.

    Note: the paper's Def 4.1 writes a strict ``>``, but its own running
    example (Fig 9c: "I_2 can answer {ABC} since its overlap ratio 3/10 is
    equal to 0.3") uses ≥; we follow the example (≥) so that c=1.0 recovers
    the optimal per-query indexing.
    """
    cover: dict[tuple[int, ...], list[tuple[int, ...]]] = {k: [] for k in closure_sizes}
    for ikey, isize in closure_sizes.items():
        for jkey in key_subsets(ikey):
            if jkey not in closure_sizes:
                continue
            jsize = closure_sizes[jkey]
            if jsize <= 0:
                continue
            if isize / jsize >= c:
                cover[jkey].append(ikey)
    return cover
