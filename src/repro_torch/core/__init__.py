"""Core ELI library — the paper's contribution, on torch.

  * labels   — bitmask codec + workload generators
  * groups   — GroupTable (grouping, closure sizes, superset DAG)
  * elastic  — elastic factor + Lemma 3.2 cost model
  * eis      — greedy fixed-efficiency index selection (Algorithm 1)
  * sis      — fixed-space selection via ratio binary search (§5)
  * estimator— sampled closure sizes for large scale (§4.2)
  * engine   — LabelHybridEngine: build/search over the device arena
  * adaptive — weighted selection, workload drift, AdaptiveEngine
  * stream   — StreamingEngine: insert/delete/flush mutations over a
               LabelHybridEngine (delta arena + tombstones, DESIGN.md §3.6)
  * faults   — deterministic named-fault-point injection (the port's own
               registry)
"""
from .labels import (  # noqa: F401
    LABEL_WORDS,
    MAX_LABELS,
    NUM_WORDS,
    LabelWorkloadConfig,
    contains,
    decode_label_set,
    encode_label_set,
    encode_many,
    generate_label_sets,
    generate_query_label_sets,
    key_contains,
    key_popcount,
    key_subsets,
    key_to_mask,
    mask_key,
    masks_to_int32_words,
)
from .groups import EMPTY_KEY, GroupTable, coverage_pairs, observed_query_keys  # noqa: F401
from .elastic import (  # noqa: F401
    elastic_factor,
    expected_scan_steps,
    min_elastic_factor,
    verify_selection,
)
from .eis import EISResult, assign_queries, greedy_eis  # noqa: F401
from .sis import SISResult, achievable_ratios, sis  # noqa: F401
from .estimator import estimate_closure_size, sampled_group_table  # noqa: F401
from .engine import (  # noqa: F401
    EngineStats,
    LabelHybridEngine,
    brute_force_filtered,
    recall_at_k,
)
from .adaptive import (AdaptiveEngine, WorkloadMonitor,  # noqa: F401
                       selection_from_weighted, weighted_select)
from .stream import StreamingEngine  # noqa: F401
from .faults import (FAULT_POINTS, FaultPlan, FaultRule,  # noqa: F401
                     InjectedFault, faultpoint, inject, register_fault_point)
