"""Elastic factor (paper Def 3.1) and its cost model (Lemma 3.2).

``elastic_factor(S(L_q), 𝕀) = max_{S(L_q) ⊆ I_i} |S(L_q)| / |I_i|``

The elastic factor is both a *guarantee* (expected k+1 PostFiltering search
steps bounded by k/c — Lemma 3.2) and, on the flat scan backends, a *FLOP bound*:
a flat scan of the routed sub-index costs at most 1/c × the optimal
(selectivity-exact) scan.  See DESIGN.md §3.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from .groups import EMPTY_KEY
from .labels import key_contains


def elastic_factor(
    query_key: tuple[int, ...],
    query_closure_size: int,
    selected: Mapping[tuple[int, ...], int],
) -> tuple[float, tuple[int, ...] | None]:
    """Best elastic factor of ``query_key`` over the selected index set.

    ``selected`` maps selected index label-set keys → their sizes |I_j|.
    Returns (factor, best_index_key).  An index with key L_j can serve the
    query iff L_j ⊆ L_q (its data S(L_j) ⊇ S(L_q)).  factor = 0.0 with key
    None if nothing qualifies (cannot happen when the top index is present).
    """
    best = 0.0
    best_key: tuple[int, ...] | None = None
    for jkey, jsize in selected.items():
        if jsize <= 0:
            continue
        if key_contains(query_key, jkey):
            f = query_closure_size / jsize
            if f > best:
                best, best_key = f, jkey
    return best, best_key


def min_elastic_factor(
    query_keys: Sequence[tuple[int, ...]],
    closure_sizes: Mapping[tuple[int, ...], int],
    selected: Mapping[tuple[int, ...], int],
) -> float:
    """The bound c actually achieved by a selection over a workload."""
    worst = 1.0
    for qk in query_keys:
        qs = closure_sizes.get(qk)
        if qs is None or qs == 0:
            continue  # empty result set: any index answers trivially
        f, _ = elastic_factor(qk, qs, selected)
        worst = min(worst, f)
    return worst


def expected_scan_steps(k: int, c: float) -> float:
    """Lemma 3.2 cost-model term: expected extra k+1 search steps, k/c."""
    if c <= 0:
        return float("inf")
    return k / c


def verify_selection(
    query_keys: Sequence[tuple[int, ...]],
    closure_sizes: Mapping[tuple[int, ...], int],
    selected: Mapping[tuple[int, ...], int],
    c: float,
) -> list[tuple[int, ...]]:
    """Return the query keys whose elastic factor falls below c (violations).

    An EIS solution is feasible iff this list is empty.  The top (empty-key)
    index guarantees completeness for every query but not the factor.
    """
    if EMPTY_KEY not in selected:
        raise ValueError("selection must always contain the top index")
    bad = []
    for qk in query_keys:
        qs = closure_sizes.get(qk, 0)
        if qs == 0:
            continue
        f, _ = elastic_factor(qk, qs, selected)
        if f < c - 1e-12:
            bad.append(qk)
    return bad
