"""SIS — fixed-space index selection (paper §5).

Maximize the elastic-factor bound c subject to total selected cost ≤ τ.
The bound is monotone: a selection feasible at c is feasible at any c' < c,
and the greedy cost is (empirically, and for the exact optimum provably)
non-increasing as c decreases.  We therefore binary-search c over the finite
set of *achievable* coverage ratios {|S(L_i)|/|S(L_j)| : L_j ⊆ L_i} — the
elastic factor can only take these values, so searching the sorted unique
ratio list is exact, needs O(log #ratios) greedy calls (paper: "O(log) calls
to the greedy algorithm"), and sidesteps float-tolerance issues of a
continuous bisection.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .eis import EISResult, greedy_eis
from .labels import key_subsets


@dataclasses.dataclass
class SISResult:
    c: float                  # best achieved elastic-factor bound
    eis: EISResult            # the selection achieving it
    probes: list[tuple[float, int, bool]]  # (c, cost, feasible) binary-search log


def achievable_ratios(closure_sizes: Mapping[tuple[int, ...], int]) -> list[float]:
    """All distinct coverage ratios |S(L_i)|/|S(L_j)| for L_j ⊆ L_i."""
    ratios: set[float] = {1.0}
    for ikey, isize in closure_sizes.items():
        if isize <= 0:
            continue
        for jkey in key_subsets(ikey):
            jsize = closure_sizes.get(jkey, 0)
            if jsize > 0:
                ratios.add(isize / jsize)
    return sorted(ratios)


def sis(
    closure_sizes: Mapping[tuple[int, ...], int],
    space_budget: int,
    query_keys: Sequence[tuple[int, ...]] | None = None,
) -> SISResult:
    """Best elastic factor under ``space_budget`` (top-index cost excluded,

    matching the paper's cost model; pass the budget accordingly — e.g.
    'ELI-2.0' = at most 1x extra data beyond the mandatory top index, i.e.
    budget = N).
    """
    ratios = achievable_ratios(closure_sizes)
    probes: list[tuple[float, int, bool]] = []

    # Feasibility is monotone over the sorted ratio list: find the largest
    # ratio whose greedy cost fits the budget.
    lo, hi = 0, len(ratios) - 1
    best: EISResult | None = None
    best_c = 0.0
    while lo <= hi:
        mid = (lo + hi) // 2
        c = ratios[mid]
        res = greedy_eis(closure_sizes, c, query_keys)
        ok = res.cost <= space_budget
        probes.append((c, res.cost, ok))
        if ok:
            best, best_c = res, c
            lo = mid + 1
        else:
            hi = mid - 1

    if best is None:
        # Even the smallest positive ratio is infeasible — fall back to the
        # top index alone (c = min selectivity ratio over queries).
        best = greedy_eis(closure_sizes, 0.0, query_keys)
        best_c = 0.0
        probes.append((0.0, best.cost, True))
    return SISResult(c=best_c, eis=best, probes=probes)
