"""Workload-adaptive index selection (port of ``repro/core/adaptive.py``)
— the paper's §7 future work ("index selection under changes in query
workload"), built on the same machinery as EIS/SIS.  Host code only.

Two pieces:

1. **Weighted cost-greedy selection** (`weighted_select`).  The paper's
   EIS minimizes *space* subject to a uniform elastic-factor bound; under
   a skewed workload the right objective is expected scan cost

       minimize  Σ_q  w_q · |I_serve(q)|     s.t.  Σ |I_j| ≤ τ

   (PostFiltering scan cost is ∝ the serving index size — Lemma 3.2 /
   Fig 6).  Greedy: repeatedly add the candidate with the largest
   cost-reduction per unit space,

       B_w(I') = Σ_q w_q · (cost_q − |I'|)⁺ / |I'| ,

   the weighted analogue of Def 4.1 — and exactly the greedy of
   Harinarayan et al.'s view-selection [21], which the paper cites as its
   lineage.  With uniform weights and τ→∞ it recovers a superset of the
   EIS solution (every query ends at elastic factor 1).

2. **Drift-triggered reselection** (`WorkloadMonitor`, `AdaptiveEngine`).
   An EWMA over observed query keys; when total-variation distance from
   the distribution used at selection time exceeds ``drift_threshold``,
   re-run weighted_select and *diff*: only newly selected keys build
   physical indexes, evicted keys are dropped.  Routing stays correct at
   every instant (the top index always exists), so reselection is an
   online, non-blocking background operation in a serving deployment.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Mapping, Sequence

from .eis import EISResult, assign_queries
from .groups import EMPTY_KEY, coverage_pairs
from .labels import encode_label_set, mask_key


@dataclasses.dataclass
class WeightedSelection:
    selected: dict[tuple[int, ...], int]
    expected_cost: float                  # Σ w_q · |I_serve(q)| (normalized)
    space: int                            # Σ |I_j| excluding top
    assignment: dict[tuple[int, ...], tuple[int, ...]]
    rounds: list[tuple[tuple[int, ...], float]]


def weighted_select(
    closure_sizes: Mapping[tuple[int, ...], int],
    weights: Mapping[tuple[int, ...], float],
    space_budget: int,
) -> WeightedSelection:
    """Greedy expected-cost minimization under a space budget."""
    if EMPTY_KEY not in closure_sizes:
        raise ValueError("closure_sizes must contain the top key")
    sizes = {k: int(v) for k, v in closure_sizes.items()
             if v > 0 or k == EMPTY_KEY}
    w = {k: float(weights.get(k, 0.0)) for k in sizes}
    total_w = sum(w.values()) or 1.0
    w = {k: v / total_w for k, v in w.items()}

    # cover[j] = query keys that index j can serve (any elastic factor —
    # cost-based selection subsumes the bound; containment still required)
    cover = coverage_pairs(sizes, c=0.0)

    top_size = sizes[EMPTY_KEY]
    cost = {q: float(top_size) for q in sizes}     # served by top initially
    selected = {EMPTY_KEY: top_size}
    space = 0
    rounds: list[tuple[tuple[int, ...], float]] = []

    def benefit(j):
        js = sizes[j]
        if js <= 0 or j in selected:
            return 0.0
        return sum(w[q] * max(cost[q] - js, 0.0)
                   for q in cover.get(j, ()) if q in cost) / js

    while True:
        best, best_b = None, 0.0
        for j in sizes:
            if j in selected or space + sizes[j] > space_budget:
                continue
            b = benefit(j)
            if b > best_b:
                best, best_b = j, b
        if best is None:
            break
        selected[best] = sizes[best]
        space += sizes[best]
        for q in cover.get(best, ()):
            if q in cost:
                cost[q] = min(cost[q], float(sizes[best]))
        rounds.append((best, best_b))

    expected = sum(w[q] * cost[q] for q in sizes)
    assignment = assign_queries(set(sizes), sizes, selected)
    return WeightedSelection(selected=selected, expected_cost=expected,
                             space=space, assignment=assignment,
                             rounds=rounds)


def selection_from_weighted(sel: WeightedSelection) -> EISResult:
    """EISResult view of a WeightedSelection — the currency
    ``LabelHybridEngine.apply_selection`` / ``rebase`` speak.  Shared by
    :meth:`AdaptiveEngine.reselect` and the streaming engine's
    compaction-piggybacked reselect (``core.stream``, DESIGN.md §3.6)."""
    return EISResult(selected=dict(sel.selected), cost=sel.space,
                     rounds=list(sel.rounds), c=0.0,
                     assignment=dict(sel.assignment))


@dataclasses.dataclass
class WorkloadMonitor:
    """EWMA query-key frequency tracker with total-variation drift."""
    halflife: int = 1000                  # queries
    counts: Counter = dataclasses.field(default_factory=Counter)
    reference: dict = dataclasses.field(default_factory=dict)
    n_seen: int = 0

    def observe(self, query_label_sets: Sequence[tuple[int, ...]]) -> None:
        decay = 0.5 ** (len(query_label_sets) / max(self.halflife, 1))
        for k in list(self.counts):
            self.counts[k] *= decay
        for ls in query_label_sets:
            self.counts[mask_key(encode_label_set(tuple(ls)))] += 1.0
        self.n_seen += len(query_label_sets)

    def distribution(self) -> dict[tuple[int, ...], float]:
        total = sum(self.counts.values()) or 1.0
        return {k: v / total for k, v in self.counts.items()}

    def snapshot(self) -> None:
        self.reference = self.distribution()

    def drift(self) -> float:
        """Total-variation distance current vs reference distribution."""
        cur = self.distribution()
        keys = set(cur) | set(self.reference)
        return 0.5 * sum(abs(cur.get(k, 0.0) - self.reference.get(k, 0.0))
                         for k in keys)


class AdaptiveEngine:
    """LabelHybridEngine wrapper: observe → drift → incremental reselect."""

    def __init__(self, engine, space_budget: int,
                 drift_threshold: float = 0.25, min_queries: int = 200):
        self.engine = engine
        self.space_budget = space_budget
        self.drift_threshold = drift_threshold
        self.min_queries = min_queries
        self.monitor = WorkloadMonitor()
        self.monitor.snapshot()
        self.reselect_log: list[dict] = []

    def search(self, queries, query_label_sets, k, **kw):
        self.monitor.observe(query_label_sets)
        out = self.engine.search(queries, query_label_sets, k, **kw)
        if (self.monitor.n_seen >= self.min_queries
                and self.monitor.drift() > self.drift_threshold):
            self.reselect()
        return out

    def reselect(self) -> dict:
        t0 = time.perf_counter()
        eng = self.engine
        weights = self.monitor.distribution()
        sel = weighted_select(eng.table.closure_sizes, weights,
                              self.space_budget)
        old = set(eng.selection.selected)
        new = set(sel.selected)
        added, dropped = new - old, old - new
        # incremental swap through the engine's single rebuild path
        # (apply_selection): retained private-storage indexes are reused,
        # added keys build, dropped keys vanish with the old tables; the
        # segment table and the vectorized routing tables are refreshed
        # together
        eng.apply_selection(selection_from_weighted(sel))
        self.monitor.snapshot()
        rec = {"added": len(added), "dropped": len(dropped),
               "space": sel.space, "expected_cost": sel.expected_cost,
               "seconds": time.perf_counter() - t0}
        self.reselect_log.append(rec)
        return rec
