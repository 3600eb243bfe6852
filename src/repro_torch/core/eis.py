"""EIS — fixed-efficiency index selection (paper §4, Algorithm 1).

Greedy selection with a lazy max-heap: each round picks the candidate index
with the largest per-unit benefit

    B(I', 𝕀') = Σ_{I_i newly covered by I'} |I_i|  /  |I'|      (Def 4.1)

until every candidate query label set is covered at elastic factor ≥ c.
The top (empty label set) index is always selected first and its cost is
excluded (paper §3.2 sets |I_top| = 0 in the cost model).

Lazy heap: popping a stale entry (benefit computed against an older covered
set) triggers recomputation + re-push; a pop whose recomputed benefit equals
its key is final.  Selecting an index invalidates only the candidates in its
cover list, i.e. at most 2^|L_max| heap entries (paper §4.2), giving
O(N' · 2^|L_max| · log N').
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Mapping, Sequence

from .groups import EMPTY_KEY, coverage_pairs


@dataclasses.dataclass
class EISResult:
    selected: dict[tuple[int, ...], int]      # key -> |S(key)| (top included, size real)
    cost: int                                 # Σ sizes, top excluded (paper cost model)
    rounds: list[tuple[tuple[int, ...], float]]  # (key, benefit) per greedy round
    c: float
    assignment: dict[tuple[int, ...], tuple[int, ...]]  # query key -> serving index key

    @property
    def total_entries(self) -> int:
        """Σ sizes including the top index (actual storage)."""
        return sum(self.selected.values())


def greedy_eis(
    closure_sizes: Mapping[tuple[int, ...], int],
    c: float,
    query_keys: Sequence[tuple[int, ...]] | None = None,
) -> EISResult:
    """Run Algorithm 1.

    ``closure_sizes``: candidate key → |S(key)| (must include EMPTY_KEY).
    ``query_keys``: the query label sets that must be covered; defaults to
    every candidate key (the paper's full-workload setting).
    """
    if EMPTY_KEY not in closure_sizes:
        raise ValueError("closure_sizes must contain the top (empty) key")
    sizes = {k: int(v) for k, v in closure_sizes.items() if v > 0 or k == EMPTY_KEY}
    must_cover = set(query_keys) if query_keys is not None else set(sizes)
    must_cover = {k for k in must_cover if sizes.get(k, 0) > 0}

    cover = coverage_pairs(sizes, c)          # index key -> covered query keys
    # restrict cover lists to keys we actually have to cover
    cover = {j: [i for i in lst if i in must_cover] for j, lst in cover.items()}

    covered: set[tuple[int, ...]] = set()
    selected: dict[tuple[int, ...], int] = {}
    rounds: list[tuple[tuple[int, ...], float]] = []

    def benefit(jkey: tuple[int, ...]) -> float:
        js = sizes[jkey]
        if js <= 0:
            return 0.0
        gain = sum(sizes[i] for i in cover.get(jkey, ()) if i not in covered)
        return gain / js

    def select(jkey: tuple[int, ...], b: float) -> None:
        selected[jkey] = sizes[jkey]
        covered.update(i for i in cover.get(jkey, ()) if i in must_cover)
        rounds.append((jkey, b))

    # Round 1: the top index, unconditionally (paper Alg 1 line 1).
    select(EMPTY_KEY, benefit(EMPTY_KEY))

    # Lazy max-heap over the remaining candidates.
    heap: list[tuple[float, tuple[int, ...]]] = []
    for jkey in sizes:
        if jkey == EMPTY_KEY:
            continue
        b = benefit(jkey)
        if b > 0:
            heapq.heappush(heap, (-b, jkey))

    while not must_cover <= covered:
        if not heap:
            # Remaining queries can only be covered by themselves (ratio 1 ≥ c)
            # — push them directly.  Happens when cover lists were pruned.
            remaining = must_cover - covered
            for qk in sorted(remaining):
                select(qk, 1.0)
            break
        negb, jkey = heapq.heappop(heap)
        if jkey in selected:
            continue
        fresh = benefit(jkey)
        if fresh <= 0:
            continue
        if fresh < -negb - 1e-12:          # stale entry: re-push with fresh key
            heapq.heappush(heap, (-fresh, jkey))
            continue
        select(jkey, fresh)

    cost = sum(v for k, v in selected.items() if k != EMPTY_KEY)
    assignment = assign_queries(must_cover, sizes, selected)
    return EISResult(selected=selected, cost=cost, rounds=rounds, c=c,
                     assignment=assignment)


def assign_queries(
    query_keys: Sequence[tuple[int, ...]] | set,
    closure_sizes: Mapping[tuple[int, ...], int],
    selected: Mapping[tuple[int, ...], int],
) -> dict[tuple[int, ...], tuple[int, ...]]:
    """Map each query key to its best (max elastic factor) selected index."""
    from .elastic import elastic_factor

    out: dict[tuple[int, ...], tuple[int, ...]] = {}
    for qk in query_keys:
        qs = closure_sizes.get(qk, 0)
        f, best = elastic_factor(qk, qs, selected)
        out[qk] = best if best is not None else EMPTY_KEY
    return out
