"""Sampled closure-size estimation for large-scale selection (paper §4.2).

Exact closure sizes cost O(Σ_G 2^|G|) subset expansions.  At the 100M-entry
scale (paper Exp-4, DEEP100M) the paper suggests sampling / cardinality
estimation [21, 22].  We implement the simple uniform-sample estimator:

    |S(L)|  ≈  N/m · #{sampled entries whose label set ⊇ L}

with a Horvitz-Thompson-style floor so no candidate that appears in the
sample is estimated at zero.  Estimates feed the same GroupTable/greedy
machinery; the physical index build later touches true members only.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .groups import GroupTable
from .labels import encode_label_set, mask_key


def sampled_group_table(
    label_sets: Sequence[tuple[int, ...]],
    sample_size: int,
    seed: int = 0,
) -> GroupTable:
    """GroupTable whose closure sizes are scaled sample estimates.

    ``groups`` still indexes the *full* dataset (group membership is cheap —
    one pass); only the closure-size subset expansion runs on the sample.
    """
    n = len(label_sets)
    if sample_size >= n:
        return GroupTable.build(label_sets)

    rng = np.random.default_rng(seed)
    sample = rng.choice(n, size=sample_size, replace=False)
    scale = n / sample_size

    est = GroupTable.build([label_sets[i] for i in sample])
    full = GroupTable.build_groups_only(label_sets)

    closure = {k: max(int(round(v * scale)), 1) for k, v in est.closure_sizes.items()}
    # Candidates observed in the full grouping but missed by the sample get a
    # floor of their own exact group size (cheap: already computed).
    for gkey, rows in full.groups.items():
        closure.setdefault(gkey, max(len(rows), 1))
    return GroupTable(n=n, groups=full.groups, closure_sizes=closure)


def estimate_closure_size(
    label_sets: Sequence[tuple[int, ...]],
    query_label_set: tuple[int, ...],
    sample_size: int,
    seed: int = 0,
) -> int:
    """One-off estimate of |S(L_q)| (used by the runtime router for query
    label sets outside the selection workload)."""
    n = len(label_sets)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(sample_size, n), replace=False)
    qmask = encode_label_set(query_label_set)
    qkey = mask_key(qmask)
    hits = 0
    for i in idx:
        key = mask_key(encode_label_set(label_sets[i]))
        if all((k & q) == q for k, q in zip(key, qkey)):
            hits += 1
    return int(round(hits * n / len(idx)))
