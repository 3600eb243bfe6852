"""LabelHybridEngine — the end-to-end ELI runtime (port of
``repro/core/engine.py``).

Pipeline (paper §3-§5):
  1. group the labelled dataset (GroupTable; exact or sampled closure sizes),
  2. run selection — EIS (fixed elastic-factor bound c) or SIS (fixed space
     budget τ, binary search for the best c),
  3. materialize one index per selected label-set key over its closure
     S(L): on the arena-native ``flat`` backend a zero-copy view of the
     shared device :class:`Arena` through an int32 CSR segment table
     (``rows_concat`` + per-key offsets); on a private-storage backend
     (``ivf``, ``graph``) an index over its own copy of the rows,
  4. route each query to its assigned index (max elastic factor) and run a
     filtered top-k inside it; ids come back global.

The ``distributed`` backend is not ported yet (ROADMAP queue A10) and
raises ``NotImplementedError``.  Every device tensor lives
on the engine's ``device`` (``"cuda"`` by default; without a card that
raises unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from ..index import flat as _flat  # noqa: F401  (registers "flat")
from ..index import graph as _graph  # noqa: F401  (registers "graph")
from ..index import ivf as _ivf  # noqa: F401  (registers "ivf")
from ..index.base import (Arena, as_row_ids, check_global_id_contract,
                          dispatch_padded, get_index_builder, parse_storage,
                          pow2_bucket, resolve_device, serving_buckets,
                          tombstone_bytes)
from ..kernels import ops as _kernel_ops
from ..kernels import ref as _ref
from ..kernels.fused_scan import resolve_fused
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .eis import EISResult, greedy_eis
from .elastic import min_elastic_factor
from .estimator import sampled_group_table
from .groups import EMPTY_KEY, GroupTable, observed_query_keys
from .labels import (encode_label_set, encode_many, key_contains,
                     key_to_mask, mask_key, masks_to_int32_words)
from .sis import SISResult, sis

UNPORTED_BACKENDS = ("distributed",)

# Search-path telemetry (DESIGN.md §6.3): host-side bookkeeping gated on
# the obs enabled flags; search bits are untouched either way.
_M_QUERIES = _metrics.counter(
    "eli_search_queries_total", "queries served by the batched executor",
    ("backend",),
)
_M_BATCHES = _metrics.counter(
    "eli_search_batches_total", "search_batched calls", ("backend",),
)
_M_LAT = _metrics.histogram(
    "eli_search_latency_seconds",
    "end-to-end search_batched wall time by launch signature",
    ("backend", "bucket", "dtype"),
)
_M_STAGE = _metrics.histogram(
    "eli_search_stage_seconds",
    "search_batched phase split: route vs dispatch+collect",
    ("stage",),
)
_M_EF = _metrics.histogram(
    "eli_elastic_factor_realized",
    "per-query realized elastic factor |S(L_q)|/|I_i| at the routed index",
    ("backend",),
    buckets=(0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
)
_M_EF_BOUND = _metrics.gauge(
    "eli_elastic_factor_bound",
    "configured elastic-factor bound c of the live selection",
)
_M_EF_VIOL = _metrics.counter(
    "eli_elastic_bound_violations_total",
    "queries whose realized elastic factor fell below the configured bound",
)
_M_UNSEEN = _metrics.counter(
    "eli_route_unseen_keys_total",
    "queries routed through the fallback path (key outside the workload)",
)
_M_ENGINE_GAUGE = _metrics.gauge(
    "eli_engine_rows", "engine row accounting", ("state",),
)
_M_ENGINE_BYTES = _metrics.gauge(
    "eli_engine_nbytes", "engine device-memory split", ("component",),
)
_M_SELECTED = _metrics.gauge(
    "eli_selected_indexes", "physical indexes in the live selection",
)
_M_ENTRIES = _metrics.gauge(
    "eli_selection_entries_total", "Σ|I| rows stored across the selection",
)
_M_ACHIEVED = _metrics.gauge(
    "eli_elastic_factor_achieved",
    "min realized elastic factor over the selection workload (stats())",
)


def record_search_telemetry(engine, routed, qmasks, k, n_queries, *,
                            t_start, t_route, tier_bucket=None,
                            min_bucket=1, tomb_density=None):
    """Per-batch query-path accounting: metrics and query cards.  Called
    only when telemetry is enabled; pure host work.  The port has no
    program cache yet, so every card reports ``recompiled=False``.
    ``tomb_density`` (a streaming batch) is the stream's deleted share."""
    t_end = time.perf_counter()
    backend = engine.backend
    arena = engine.arena
    dtype = arena.dtype if arena is not None else "f32"
    bound = engine.selection.c

    if _metrics.enabled():
        _M_QUERIES.labels(backend).inc(n_queries)
        _M_BATCHES.labels(backend).inc()
        _M_LAT.labels(backend, pow2_bucket(n_queries, min_bucket),
                      dtype).observe(t_end - t_start)
        _M_STAGE.labels("route").observe(t_route - t_start)
        _M_STAGE.labels("dispatch").observe(t_end - t_route)
        _M_EF_BOUND.set(bound)

    tracing = _trace.enabled()
    # one observe/card per (query key, routed key) group
    groups: dict[tuple[tuple[int, ...], tuple[int, ...]], int] = {}
    for qm, skey in zip(qmasks, routed):
        gk = (mask_key(qm), skey)
        groups[gk] = groups.get(gk, 0) + 1
    for (qkey, skey), count in groups.items():
        qsize = engine.table.closure_sizes.get(qkey)
        ssize = engine.selection.selected.get(skey)
        factor = None
        if qsize and ssize:
            factor = qsize / ssize
        if _metrics.enabled():
            if factor is not None:
                _M_EF.labels(backend).observe(factor, n=count)
                if factor < bound - 1e-12:
                    _M_EF_VIOL.inc(count)
            else:
                _M_UNSEEN.inc(count)
        if tracing:
            span_tier = q_bucket = shortlist = None
            if arena is not None:
                span_tier = pow2_bucket(engine.segments[skey][1])
                q_bucket = tier_bucket[span_tier]
                if arena.rerank is not None:
                    shortlist = max(k, min(4 * k, span_tier))
            else:
                q_bucket = pow2_bucket(count, min_bucket)
            _trace.get_tracer().add_card(_trace.QueryCard(
                query_key=qkey, selected_key=skey, n_queries=count,
                elastic_factor=factor, bound=bound, span_tier=span_tier,
                q_bucket=q_bucket, dtype=dtype, shortlist=shortlist,
                tombstone_density=tomb_density, recompiled=False,
                backend=backend))
    if tracing:
        tr = _trace.get_tracer()
        tr.complete("search.route", t_start, t_route, Q=n_queries,
                    backend=backend)
        tr.complete("search.dispatch", t_route, t_end, k=k, backend=backend,
                    groups=len(groups))


def publish_engine_gauges(st) -> None:
    """Mirror an ``EngineStats`` into registry gauges."""
    if not _metrics.enabled():
        return
    _M_ENGINE_GAUGE.labels("live").set(st.live_rows)
    _M_ENGINE_GAUGE.labels("tombstoned").set(st.tombstoned_rows)
    _M_ENGINE_GAUGE.labels("delta").set(st.delta_rows)
    _M_ENGINE_BYTES.labels("total").set(st.nbytes)
    _M_ENGINE_BYTES.labels("arena").set(st.arena_nbytes)
    _M_ENGINE_BYTES.labels("segment").set(st.segment_nbytes)
    _M_ENGINE_BYTES.labels("delta").set(st.delta_nbytes)
    _M_ENGINE_BYTES.labels("codes").set(st.codes_nbytes)
    _M_ENGINE_BYTES.labels("rerank").set(st.rerank_nbytes)
    _M_ENGINE_BYTES.labels("tombstone").set(st.tombstone_nbytes)
    _M_SELECTED.set(st.n_selected)
    _M_ENTRIES.set(st.total_entries)
    _M_ACHIEVED.set(st.achieved_c)


@dataclasses.dataclass
class EngineStats:
    n: int                       # dataset cardinality
    n_candidates: int            # candidate indices considered
    n_selected: int              # physical indexes built (incl. top)
    selection_cost: int          # Σ|I| excluding top (paper cost model)
    total_entries: int           # Σ|I| including top (actual rows stored)
    achieved_c: float            # min elastic factor over the workload
    select_seconds: float
    build_seconds: float
    nbytes: int                  # arena + segment table + private storage
    arena_nbytes: int = 0        # shared-arena share of nbytes (0 = none)
    segment_nbytes: int = 0      # CSR row-id table share of nbytes
    live_rows: int = 0           # rows a search can return
    tombstoned_rows: int = 0     # deleted-but-not-yet-compacted rows
    delta_rows: int = 0          # rows resident in a delta arena
    arena_version: int = 0       # mutation counter of the arena
    delta_nbytes: int = 0        # delta-arena share of nbytes
    storage: str = "f32"         # arena storage spec ("int8+rerank", …)
    codes_nbytes: int = 0        # scan-tier rows (f32 / f16 / u8 codes)
    scales_nbytes: int = 0       # int8 per-row scale + zero-point columns
    rerank_nbytes: int = 0       # exact f32 rerank tier (0 = no rerank)
    tombstone_nbytes: int = 0    # packed delete bitmap(s)


class LabelHybridEngine:
    """Build-once, search-many ELI engine over a pluggable index backend."""

    # bound on memoized fallback routes for query keys outside the
    # selection workload
    _ROUTE_CACHE_MAX = 65536

    def __init__(self, vectors: np.ndarray, label_sets: Sequence[tuple[int, ...]],
                 table: GroupTable, selection: EISResult,
                 sis_result: SISResult | None, backend: str, metric: str,
                 backend_params: dict, select_seconds: float,
                 storage: str = "f32", device="cuda",
                 indexes: Mapping[tuple[int, ...], object] | None = None):
        if backend in UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet; the port runs the "
                f"flat, ivf and graph backends (ROADMAP queue A10: "
                f"distributed, single-GPU first)")
        self.device = resolve_device(device)
        self.sis_result = sis_result
        self.backend = backend
        self.metric = metric
        builder = get_index_builder(backend)
        self._arena_native = hasattr(builder, "build_view")
        self.backend_params = dict(backend_params)
        self.backend_params.setdefault(
            "kernel_backend", _kernel_ops.default_backend(self.device))
        self._seg_backend = self.backend_params["kernel_backend"]
        # fused scan stage (DESIGN.md §3.9): resolved once so views,
        # executor and warmup agree
        self._seg_fused = resolve_fused(
            self.backend_params.get("fused", False),
            backend=self._seg_backend)
        parse_storage(storage)   # validate the spec before any device work
        if storage != "f32" and not self._arena_native:
            raise ValueError(
                f"storage={storage!r} needs an arena-native backend (the "
                f"compressed tiers live in the shared arena); backend "
                f"{backend!r} keeps private f32 copies")
        self.storage = storage

        self.indexes: dict[tuple[int, ...], object] = {}
        self.rows: dict[tuple[int, ...], np.ndarray] = {}
        self.segments: dict[tuple[int, ...], tuple[int, int]] = {}
        t0 = time.perf_counter()
        self.rebase(vectors, label_sets, table, selection, indexes=indexes)
        self._build_seconds = time.perf_counter() - t0
        self._select_seconds = select_seconds

    def rebase(self, vectors: np.ndarray,
               label_sets: Sequence[tuple[int, ...]], table: GroupTable,
               selection: EISResult, *, arena: Arena | None = None,
               label_words: np.ndarray | None = None,
               rows_hint: Mapping[tuple[int, ...], np.ndarray] | None = None,
               indexes: Mapping[tuple[int, ...], object] | None = None
               ) -> None:
        """Swap the dataset under the engine and rematerialize — the single
        home of dataset installation (``__init__`` is a rebase from
        nothing; a streaming compaction folds tombstones and delta rows
        into a fresh arena and rebases through here, DESIGN.md §3.6): one
        upload into a fresh device :class:`Arena` (arena-native backends;
        private-storage backends copy their rows at build instead), then
        :meth:`apply_selection`.

        Every retained index and row table is dropped: they belong to the
        old rows.  ``arena`` installs an already-built arena of this
        engine's storage (no re-upload); ``label_words`` skips the host
        re-encode; ``rows_hint`` seeds per-key member lists already in the
        NEW row numbering (the caller vouches they equal what the new
        table's ``closure_members`` would give); ``indexes`` seeds private
        indexes already built over THIS dataset's selected keys
        (:meth:`from_reference_state`).  ``apply_selection`` reuses the
        last two."""
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.label_sets = list(label_sets)
        self.table = table
        if label_words is None:
            label_words = masks_to_int32_words(encode_many(self.label_sets))
        self.label_words = np.ascontiguousarray(label_words, dtype=np.int32)
        check_global_id_contract(len(self.label_sets))
        self.indexes = dict(indexes) if indexes is not None else {}
        self.segments = {}
        self.rows = dict(rows_hint) if rows_hint is not None else {}
        if not self._arena_native:
            self.arena = None
        else:
            self.arena = (arena if arena is not None else Arena.from_host(
                self.vectors, self.label_words, storage=self.storage,
                device=self.device))
            if self.arena.storage != self.storage:
                raise ValueError(
                    f"installed arena holds {self.arena.storage!r} tiers "
                    f"but the engine is configured for {self.storage!r}")
        self.apply_selection(selection)

    def apply_selection(self, selection: EISResult) -> None:
        """(Re)materialize the engine for ``selection``: the CSR segment
        table (every selected index is an int32 row-id segment of ONE
        concatenated ``rows_concat``), then one zero-copy view per key
        over the arena (arena-native backends, with the table uploaded
        once) or one private index per key over ``vectors[rows]``
        (retained instances are reused; the table stays on the host),
        and the vectorized routing tables."""
        n = check_global_id_contract(len(self.label_sets))
        builder = get_index_builder(self.backend)
        old_rows, old_indexes = self.rows, self.indexes
        self.selection = selection
        self.indexes, self.rows, self.segments = {}, {}, {}
        parts, off = [], 0
        for key in selection.selected:
            rows = old_rows.get(key)
            if rows is None:
                rows = _key_rows(self.table, key, n)
            self.rows[key] = rows
            self.segments[key] = (off, rows.size)
            parts.append(rows)
            off += rows.size
        self.rows_concat = (np.concatenate(parts) if parts
                            else np.zeros(0, np.int32))
        if self._arena_native:
            self._rows_concat_dev = torch.from_numpy(self.rows_concat).to(
                self.device)
            for key, (start, length) in self.segments.items():
                self.indexes[key] = builder.build_view(
                    self.arena, self._rows_concat_dev, start, length,
                    metric=self.metric, **self.backend_params)
        else:
            self._rows_concat_dev = None
            for key, rows in self.rows.items():
                index = old_indexes.get(key)
                if index is None:
                    index = builder.build(
                        self.vectors[rows], self.label_words[rows],
                        metric=self.metric, device=self.device,
                        **self.backend_params)
                self.indexes[key] = index

        # routing table for the batched executor: the selected keys (in
        # dict order — route()'s tie-break order) as a dense uint64 mask
        # matrix; _route_cache memoizes fallback routing of unseen keys
        self._skeys = list(selection.selected)   # always holds EMPTY_KEY
        self._skey_masks = np.stack([key_to_mask(k) for k in self._skeys])
        self._skey_sizes = np.array(
            [selection.selected[k] for k in self._skeys], dtype=np.int64)
        self._route_cache: dict[tuple[int, ...], tuple[int, ...]] = {}
        if _metrics.enabled():
            _M_SELECTED.set(len(self._skeys))
            _M_ENTRIES.set(selection.total_entries)
            _M_EF_BOUND.set(selection.c)

    # -- construction --------------------------------------------------------
    @staticmethod
    def build(vectors: np.ndarray, label_sets: Sequence[tuple[int, ...]], *,
              mode: str = "eis", c: float = 0.2, space_budget: int | None = None,
              query_label_sets: Sequence[tuple[int, ...]] | None = None,
              backend: str = "flat", metric: str = "l2",
              sample_size: int | None = None, storage: str = "f32",
              device="cuda", **backend_params) -> "LabelHybridEngine":
        """Select indices (EIS at bound ``c`` or SIS under ``space_budget``)
        and materialize them on ``device``.

        ``query_label_sets``: explicit workload; default derives candidates
        from all subsets of observed base label sets (paper default).
        ``sample_size``: use the §4.2 sampled closure-size estimator.
        ``storage``: arena tier spec (``"f32"``, ``"fp16"``, ``"int8"``,
        ``"fp16+rerank"``, ``"int8+rerank"``).  ``kernel_backend``
        (a backend param) defaults to ``"cuda"`` on a CUDA device and
        ``"ref"`` elsewhere; ``fused`` is False, True or ``"auto"``.
        """
        t0 = time.perf_counter()
        qkeys = (observed_query_keys(query_label_sets)
                 if query_label_sets is not None else None)
        if sample_size is not None:
            table = sampled_group_table(label_sets, sample_size)
        else:
            table = GroupTable.build(label_sets, qkeys)

        sis_result: SISResult | None = None
        if mode == "eis":
            selection = greedy_eis(table.closure_sizes, c, qkeys)
        elif mode == "sis":
            if space_budget is None:
                raise ValueError("mode='sis' requires space_budget")
            sis_result = sis(table.closure_sizes, space_budget, qkeys)
            selection = sis_result.eis
        else:
            raise ValueError(f"unknown mode {mode!r}")
        select_seconds = time.perf_counter() - t0

        return LabelHybridEngine(vectors, label_sets, table, selection,
                                 sis_result, backend, metric, backend_params,
                                 select_seconds, storage=storage,
                                 device=device)

    @classmethod
    def from_reference_state(cls, state: Mapping, *,
                             device="cuda") -> "LabelHybridEngine":
        """Build the port engine on a selection made elsewhere — the JAX
        engine's state as plain numpy arrays, dicts and lists:

        ``vectors``, ``label_sets``, ``closure_sizes`` (the table's),
        ``selected`` (key -> size, in selection order), ``assignment``,
        ``cost``, ``rounds``, ``c``, ``storage``, ``backend_params`` and
        ``metric`` (``backend`` optional, default flat).  The JAX
        ``"pallas"`` kernel backend maps to ``"cuda"``.  With
        ``backend="ivf"``, ``ivf_states`` maps every selected key to its
        JAX index's clusters (``IVFIndex.from_reference_state``), which
        the engine installs instead of running k-means; with
        ``backend="graph"``, ``graph_states`` maps every selected key to its
        JAX index's ``adjacency`` and ``medoid`` (``M``, ``ef_search`` and
        ``strategy`` optional), installed over the key's rows instead of a
        Vamana build."""
        label_sets = list(state["label_sets"])
        table = GroupTable.build_groups_only(label_sets)
        table.closure_sizes = dict(state["closure_sizes"])
        selection = EISResult(
            selected=dict(state["selected"]), cost=int(state["cost"]),
            rounds=list(state["rounds"]), c=float(state["c"]),
            assignment=dict(state["assignment"]))
        params = dict(state.get("backend_params", {}))
        if params.get("kernel_backend") == "pallas":
            params["kernel_backend"] = "cuda"
        backend = state.get("backend", "flat")
        metric = state.get("metric", "l2")
        indexes = None
        dev = resolve_device(device)
        kb = params.get("kernel_backend")
        if backend == "ivf":
            indexes = {key: _ivf.IVFIndex.from_reference_state(
                st, metric=metric, kernel_backend=kb, device=dev)
                for key, st in state["ivf_states"].items()}
        elif backend == "graph":
            vectors = np.ascontiguousarray(state["vectors"], np.float32)
            words = masks_to_int32_words(encode_many(label_sets))
            n = len(label_sets)
            indexes = {}
            for key, st in state["graph_states"].items():
                rows = _key_rows(table, key, n)
                indexes[key] = _graph.GraphIndex.from_reference_state(
                    vectors[rows], words[rows], st, metric=metric,
                    kernel_backend=kb, device=dev)
        return cls(state["vectors"], label_sets, table, selection, None,
                   backend, metric, params, 0.0,
                   storage=state.get("storage", "f32"), device=device,
                   indexes=indexes)

    @property
    def sentinel(self) -> int:
        """The empty-slot id: real ids live in [0, sentinel).  For a static
        engine this is the dataset cardinality; a streaming engine's grows
        with inserts (``core.stream.StreamingEngine.sentinel``)."""
        return len(self.label_sets)

    # -- routing --------------------------------------------------------------
    def route(self, query_label_set: tuple[int, ...]) -> tuple[int, ...]:
        """Selected index key serving this query (max elastic factor)."""
        qkey = mask_key(encode_label_set(query_label_set))
        hit = self.selection.assignment.get(qkey)
        if hit is not None:
            return hit
        # unseen query key: among selected keys ⊆ qkey pick the smallest
        # index (max elastic factor for the fixed |S(L_q)|)
        best, best_size = EMPTY_KEY, self.rows[EMPTY_KEY].size
        for skey, size in self.selection.selected.items():
            if key_contains(qkey, skey) and size < best_size:
                best, best_size = skey, size
        return best

    def route_many(self, query_label_sets: Sequence[tuple[int, ...]],
                   qmasks: np.ndarray | None = None) -> list[tuple[int, ...]]:
        """Vectorized :meth:`route` for a query batch: assignment hits
        resolve through the selection table; the unseen remainder is
        deduplicated and routed in ONE superset-matching pass, picking the
        smallest containing index (argmin's first minimum matches route()'s
        dict-order strict-< scan).  Results are memoized per key."""
        if qmasks is None:
            qmasks = encode_many(query_label_sets)
        qkeys = [mask_key(m) for m in qmasks]
        routed: list[tuple[int, ...] | None] = [None] * len(qkeys)
        unseen: dict[tuple[int, ...], list[int]] = {}
        for qi, qkey in enumerate(qkeys):
            hit = self.selection.assignment.get(qkey)
            if hit is None:
                hit = self._route_cache.get(qkey)
            if hit is not None:
                routed[qi] = hit
            else:
                unseen.setdefault(qkey, []).append(qi)
        if unseen:
            um = np.stack([key_to_mask(kk) for kk in unseen])     # [U, W]
            sm = self._skey_masks[None, :, :]                     # [1, M, W]
            cand = np.all((um[:, None, :] & sm) == sm, axis=2)    # [U, M]
            sizes = np.where(cand, self._skey_sizes[None, :],
                             np.iinfo(np.int64).max)
            best = np.argmin(sizes, axis=1)
            best_size = sizes[np.arange(len(unseen)), best]
            top_size = self.rows[EMPTY_KEY].size
            for u, (qkey, qids) in enumerate(unseen.items()):
                chosen = (self._skeys[int(best[u])]
                          if best_size[u] < top_size else EMPTY_KEY)
                if len(self._route_cache) < self._ROUTE_CACHE_MAX:
                    self._route_cache[qkey] = chosen
                for qi in qids:
                    routed[qi] = chosen
        return routed

    # -- search ----------------------------------------------------------------
    def search(self, queries: np.ndarray,
               query_label_sets: Sequence[tuple[int, ...]], k: int,
               **search_params) -> tuple[np.ndarray, np.ndarray]:
        """Filtered top-k for a query batch.  Returns (dists, GLOBAL ids);
        id == N ⇒ empty slot.  Delegates to :meth:`search_batched`."""
        return self.search_batched(queries, query_label_sets, k,
                                   **search_params)

    @property
    def supports_lazy_deletes(self) -> bool:
        """True ⇔ every selected index can serve a pending-delete bitmap:
        arena-native engines by construction, private-storage engines when
        every index declares ``supports_tombstones``."""
        if self._arena_native:
            return True
        return all(getattr(type(ix), "supports_tombstones", False)
                   for ix in self.indexes.values())

    def search_batched(self, queries: np.ndarray,
                       query_label_sets: Sequence[tuple[int, ...]], k: int,
                       *, min_bucket: int = 1, tomb_by_key=None,
                       **search_params) -> tuple[np.ndarray, np.ndarray]:
        """Batched multi-index executor.  Routes the batch in one
        vectorized pass, then:

          * arena-native backends (flat): partition the batch by the
            power-of-two candidate span of each query's segment and run ONE
            ``ops.segmented_topk`` per span tier — O(#tiers) launches per
            batch, not one per routed index;
          * private-storage backends (ivf, graph): one ``search_padded`` per
            routed index on the group's power-of-two bucket, with the
            local → global id map applied on the host.

        Every launch is queued before the first copy back to the host.
        Bit-identical to :meth:`search_looped`: each query's top-k does not
        depend on its batch neighbors.

        ``tomb_by_key`` (private-storage backends only): per-selected-key
        packed tombstone bitmaps over each index's LOCAL rows; keys absent
        from it search tombstone-free.  Arena-native engines take deletes
        through the arena's bitmap and reject it.

        ``search_params`` (private-storage backends only) go to every
        index's ``search_padded``, for example the graph's ``ef`` and
        ``strategy``; arena-native engines take none and raise."""
        telem = _metrics.enabled() or _trace.enabled()
        t_start = time.perf_counter() if telem else 0.0
        queries = np.asarray(queries, dtype=np.float32)
        Q = queries.shape[0]
        n = check_global_id_contract(len(self.label_sets))
        out_d = np.full((Q, k), np.inf, dtype=np.float32)
        out_i = np.full((Q, k), n, dtype=np.int32)
        if Q == 0:
            return out_d, out_i

        qmasks = encode_many(query_label_sets)
        qwords = masks_to_int32_words(qmasks)
        routed = self.route_many(query_label_sets, qmasks)
        t_route = time.perf_counter() if telem else 0.0
        if not self._arena_native:
            self._search_private(queries, qwords, routed, k, n, out_d, out_i,
                                 min_bucket=min_bucket,
                                 tomb_by_key=tomb_by_key, **search_params)
            if telem:
                record_search_telemetry(
                    self, routed, qmasks, k, Q, t_start=t_start,
                    t_route=t_route, min_bucket=min_bucket)
            return out_d, out_i
        if tomb_by_key is not None:
            raise TypeError(
                "tomb_by_key is the private-storage lazy-delete path; "
                "arena-native engines take deletes through the arena's "
                "tombstone bitmap")
        self._no_search_params(search_params)
        pend = []
        tier_bucket: dict[int, int] = {}
        for qids, qp, lp, starts, lens, lmax, g in \
                self.arena_tier_batches(queries, qwords, routed, min_bucket):
            tier_bucket[lmax] = qp.shape[0]
            vals, _, gi = _kernel_ops.segmented_topk(
                qp, lp, self.arena.vectors, self.arena.label_words,
                self.arena.norms, self._rows_concat_dev, starts, lens,
                k=k, lmax=lmax, metric=self.metric,
                backend=self._seg_backend, fused=self._seg_fused,
                device=self.device, **self.arena.tier_kwargs())
            pend.append((qids, vals, gi, g))
        # single synchronization point: every tier is already queued
        for qids, d, gi, g in pend:
            out_d[qids] = d[:g].cpu().numpy()
            out_i[qids] = gi[:g].cpu().numpy()
        if telem:
            record_search_telemetry(
                self, routed, qmasks, k, Q, t_start=t_start,
                t_route=t_route, tier_bucket=tier_bucket,
                min_bucket=min_bucket)
        return out_d, out_i

    def _search_private(self, queries, qwords, routed, k, n, out_d, out_i,
                        *, min_bucket, tomb_by_key, **search_params):
        """The private-storage half of :meth:`search_batched`: one padded
        dispatch per routed index, every group queued before the first
        copy back, then the local → global id map (local id ==
        ``rows.size`` ⇒ empty slot ⇒ ``n``)."""
        by_key: dict[tuple[int, ...], list[int]] = {}
        for qi, key in enumerate(routed):
            by_key.setdefault(key, []).append(qi)
        pend = []
        for key, qids in by_key.items():
            tomb = tomb_by_key.get(key) if tomb_by_key else None
            extra = search_params if tomb is None else dict(search_params,
                                                            tomb=tomb)
            d, li = dispatch_padded(self.indexes[key].search_padded,
                                    queries[qids], qwords[qids], k,
                                    min_bucket=min_bucket, **extra)
            pend.append((key, qids, d, li))
        # single synchronization point: every group is already queued
        for key, qids, d, li in pend:
            g = len(qids)
            out_d[qids] = d[:g].cpu().numpy()
            out_i[qids] = _local_to_global(li[:g].cpu().numpy(),
                                           self.rows[key], n)

    def arena_tier_batches(self, queries: np.ndarray, qwords: np.ndarray,
                           routed: Sequence[tuple[int, ...]],
                           min_bucket: int = 1):
        """Partition a routed batch by candidate-span tier and yield the
        padded segmented-program operands per tier:

            (qids, qp, lp, starts, lens, lmax, g)

        — queries sorted by segment start within a tier (gather locality),
        zero-padded to the power-of-two Q-bucket, with each query's
        ``(start, len)`` CSR segment."""
        tiers: dict[int, list[int]] = {}
        for qi, key in enumerate(routed):
            tiers.setdefault(pow2_bucket(self.segments[key][1]),
                             []).append(qi)
        for lmax in sorted(tiers):
            qids = sorted(tiers[lmax],
                          key=lambda qi: self.segments[routed[qi]][0])
            g = len(qids)
            bucket = pow2_bucket(g, min_bucket)
            qp = np.zeros((bucket, queries.shape[1]), np.float32)
            qp[:g] = queries[qids]
            lp = np.zeros((bucket, qwords.shape[1]), np.int32)
            lp[:g] = qwords[qids]
            seg = np.zeros((2, bucket), np.int32)   # starts / lens
            seg[:, :g] = np.array(
                [self.segments[routed[qi]] for qi in qids], np.int32).T
            yield qids, qp, lp, seg[0], seg[1], lmax, g

    def search_looped(self, queries: np.ndarray,
                      query_label_sets: Sequence[tuple[int, ...]], k: int,
                      tomb_by_key=None,
                      **search_params) -> tuple[np.ndarray, np.ndarray]:
        """Reference executor: per-key Python loop, one un-bucketed
        ``search`` per selected index — the parity oracle for
        :meth:`search_batched`, ``tomb_by_key`` and ``search_params``
        included."""
        if self._arena_native:
            self._no_search_params(search_params)
        queries = np.asarray(queries, dtype=np.float32)
        Q = queries.shape[0]
        n = len(self.label_sets)
        out_d = np.full((Q, k), np.inf, dtype=np.float32)
        out_i = np.full((Q, k), n, dtype=np.int32)

        qwords = masks_to_int32_words(encode_many(query_label_sets))
        by_key: dict[tuple[int, ...], list[int]] = {}
        for qi, qls in enumerate(query_label_sets):
            by_key.setdefault(self.route(tuple(qls)), []).append(qi)

        for key, qids in by_key.items():
            tomb = tomb_by_key.get(key) if tomb_by_key else None
            extra = search_params if tomb is None else dict(search_params,
                                                            tomb=tomb)
            d, li = self.indexes[key].search(queries[qids], qwords[qids], k,
                                             **extra)
            out_d[qids] = d
            out_i[qids] = _local_to_global(li, self.rows[key], n)
        return out_d, out_i

    # -- warmup ----------------------------------------------------------------
    def _no_search_params(self, search_params) -> None:
        if search_params:
            raise TypeError(f"arena-native backend {self.backend!r} "
                            f"takes no search params; got "
                            f"{sorted(search_params)}")

    def warmup(self, ks: Sequence[int], buckets: Sequence[int],
               tomb_variants: bool = False, **search_params) -> dict:
        """Run every launch the first real batches need once on zero
        queries, so they find the kernels built and loaded: on arena-native
        backends every (k ∈ ks, Q-bucket ∈ buckets, candidate-span tier)
        segmented search, on private-storage backends every selected
        index's ``search_padded`` per (k, Q-bucket), with
        ``search_params``.  ``tomb_variants=True`` (streaming,
        private-storage backends) also runs each index that takes
        tombstones once on an all-zero bitmap (the arena's counterpart is
        ``StreamingEngine.warmup``).  Returns ``{"seconds", "programs"}``."""
        if self._arena_native:
            self._no_search_params(search_params)
        t0 = time.perf_counter()
        D = self.vectors.shape[1]
        W = self.label_words.shape[1]
        programs = 0
        span_tiers = sorted({pow2_bucket(length)
                             for _, length in self.segments.values()})
        for k in ks:
            for b in buckets:
                bucket = pow2_bucket(b)
                qz = np.zeros((bucket, D), np.float32)
                lz = np.zeros((bucket, W), np.int32)
                zero = np.zeros(bucket, np.int32)
                if not self._arena_native:
                    for index in self.indexes.values():
                        index.search_padded(qz, lz, k, **search_params)
                        programs += 1
                        if tomb_variants and getattr(
                                type(index), "supports_tombstones", False):
                            zt = np.zeros(tombstone_bytes(index.num_vectors),
                                          np.uint8)
                            index.search_padded(qz, lz, k, tomb=zt,
                                                **search_params)
                            programs += 1
                    continue
                for lmax in span_tiers:
                    _kernel_ops.segmented_topk(
                        qz, lz, self.arena.vectors, self.arena.label_words,
                        self.arena.norms, self._rows_concat_dev, zero, zero,
                        k=k, lmax=lmax, metric=self.metric,
                        backend=self._seg_backend, fused=self._seg_fused,
                        device=self.device, **self.arena.tier_kwargs())
                    programs += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"seconds": time.perf_counter() - t0, "programs": programs}

    def warmup_serving(self, ks: Sequence[int], min_bucket: int,
                       max_batch: int, **search_params) -> dict:
        """Serving-shaped :meth:`warmup` over the full power-of-two bucket
        ladder from ``min_bucket`` to ``max_batch``."""
        return self.warmup(ks, serving_buckets(min_bucket, max_batch),
                           **search_params)

    # -- reporting --------------------------------------------------------------
    def stats(self) -> EngineStats:
        qkeys = [k for k in self.table.closure_sizes if k != EMPTY_KEY]
        achieved = min_elastic_factor(qkeys, self.table.closure_sizes,
                                      self.selection.selected)
        arena = self.arena
        tiers = (arena.tier_nbytes if arena is not None else
                 {"codes": 0, "scales": 0, "rerank": 0, "tombstone": 0})
        arena_nbytes = arena.nbytes if arena is not None else 0
        # the CSR table is on the device only for arena-native backends;
        # views report nbytes = 0, private indexes their own copies
        segment_nbytes = (int(self._rows_concat_dev.numel()
                              * self._rows_concat_dev.element_size())
                          if self._rows_concat_dev is not None else 0)
        st = EngineStats(
            n=len(self.label_sets),
            n_candidates=len(self.table.closure_sizes),
            n_selected=len(self.indexes),
            selection_cost=self.selection.cost,
            total_entries=self.selection.total_entries,
            achieved_c=achieved,
            select_seconds=self._select_seconds,
            build_seconds=self._build_seconds,
            nbytes=(arena_nbytes + segment_nbytes
                    + sum(ix.nbytes for ix in self.indexes.values())),
            arena_nbytes=arena_nbytes,
            segment_nbytes=segment_nbytes,
            live_rows=len(self.label_sets),
            arena_version=arena.version if arena is not None else 0,
            storage=self.storage,
            codes_nbytes=tiers["codes"],
            scales_nbytes=tiers["scales"],
            rerank_nbytes=tiers["rerank"],
            tombstone_nbytes=tiers["tombstone"],
        )
        publish_engine_gauges(st)
        return st


def _key_rows(table: GroupTable, key: tuple[int, ...], n: int) -> np.ndarray:
    """The rows a selected key's index holds, S(key), as int32 row ids
    (the sentinel contract); the empty key holds every row."""
    rows = (np.arange(n, dtype=np.int64) if key == EMPTY_KEY
            else table.closure_members(key))
    return as_row_ids(rows, n)


def _local_to_global(li: np.ndarray, rows: np.ndarray, n: int) -> np.ndarray:
    """Local ids of one index -> global ids (local id >= ``rows.size`` ⇒
    empty slot ⇒ ``n``)."""
    if rows.size == 0:
        return np.full(li.shape, n, np.int32)
    gi = np.where(li >= rows.size, n, rows[np.clip(li, 0, rows.size - 1)])
    return gi.astype(np.int32)


def brute_force_filtered(vectors: np.ndarray,
                         label_sets: Sequence[tuple[int, ...]],
                         queries: np.ndarray,
                         query_label_sets: Sequence[tuple[int, ...]],
                         k: int, metric: str = "l2", *, device="cuda"
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Exact filtered ground truth (benchmark reference)."""
    dev = resolve_device(device)
    lx = masks_to_int32_words(encode_many(label_sets))
    lq = masks_to_int32_words(encode_many(query_label_sets))
    d, i = _ref.filtered_topk(
        torch.as_tensor(np.asarray(queries, np.float32), device=dev),
        torch.as_tensor(np.asarray(vectors, np.float32), device=dev),
        torch.as_tensor(lq, device=dev), torch.as_tensor(lx, device=dev),
        k, metric)
    return d.cpu().numpy(), i.cpu().numpy()


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray, n: int) -> float:
    """Paper §2.1 recall: |result ∩ truth| / |truth| (averaged over queries;
    id == n means an empty slot and is ignored)."""
    total, hit = 0, 0
    for r, t in zip(result_ids, truth_ids):
        tt = set(int(v) for v in t if v < n)
        if not tt:
            continue
        rr = set(int(v) for v in r if v < n)
        hit += len(rr & tt)
        total += len(tt)
    return hit / total if total else 1.0
