"""StreamingEngine — the streaming mutation subsystem (port of
``repro/core/stream.py``; DESIGN.md §3.6).

It wraps :class:`~repro_torch.core.engine.LabelHybridEngine` with
``insert`` / ``delete`` / ``flush`` while keeping search results
**bit-identical to an engine rebuilt from scratch on the surviving rows**,
the subsystem's correctness oracle.

Id space: base rows keep their ids ``[0, N)``; inserted rows are assigned
``N, N+1, …`` in arrival order; the empty-slot sentinel is
:attr:`sentinel` (= ``N + #inserted``, the stream cardinality).  A
compaction renumbers survivors compactly (stream order preserved) and
reports the old→new ``id_map``.

Two capability tiers, as in the JAX package:

  * **arena-native backends** (flat) absorb mutations lazily: deletes set
    bits in the base arena's packed tombstone bitmap, which the segmented
    search fuses into its label filter; inserts append into a
    fixed-capacity :class:`~repro_torch.index.base.DeltaArena`
    (power-of-two capacity tiers) without touching the CSR segment table.
    A batch runs one tombstone-fused ``segmented_topk`` per span tier,
    scattered on the device into one query-aligned buffer, then ONE delta
    scan (the same segmented search over an identity row table) and ONE
    merge (``kernels.ops.merge_topk``, the (distance, global-id) order),
    and copies to the host once.  On the ``"cuda"`` backend that is the
    ``fused_scan`` kernel (or ``segmented_gather_distance`` unfused) over
    base and delta, and ``segmented_gather_distance`` for a rerank tier.
  * **private-storage backends** (ivf / graph): deletes are lazy here too
    — one packed bitmap per selected index, derived from the global dead
    mask, passed down ``search_padded(tomb=…)``.  Only inserts (which
    these structures cannot absorb in place) and the compaction triggers
    force the fold: a from-scratch build with the original arguments,
    ``device`` included, whose seeded determinism gives rebuilt parity.
    With deletes pending the invariant is the fixed-structure one: results
    equal the same engine with the dead rows failing the filter.

Compaction (``flush`` or the automatic thresholds) folds live delta rows
and drops tombstoned rows into a fresh base arena, updates the GroupTable
incrementally (``GroupTable.compacted``), remaps the old segments instead
of recomputing per-key closures (``rebase(rows_hint=…)``), and rebases the
engine through its single dataset-installation path.  When a
:class:`WorkloadMonitor` is attached and its drift exceeds the threshold,
the compaction piggybacks a weighted reselect (``core.adaptive``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..index.base import (Arena, CapacityError, DeltaArena,
                          MIN_DELTA_CAPACITY, as_row_ids,
                          check_global_id_contract, pack_tombstones,
                          pow2_bucket, serving_buckets)
from ..kernels import ops as _kernel_ops
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .adaptive import WorkloadMonitor, selection_from_weighted, weighted_select
from .eis import EISResult
from .engine import (LabelHybridEngine, publish_engine_gauges,
                     record_search_telemetry)
from .faults import faultpoint, register_fault_point
from .groups import EMPTY_KEY, GroupTable
from .labels import encode_many, key_to_mask, masks_to_int32_words

# crash site inside the compaction: survivors computed, nothing rebased
# yet — the in-memory engine must be left as it was
register_fault_point("compact.mid_fold",
                     "flush(): after _survivors, before the fold")

# Streaming-mutation telemetry (DESIGN.md §6.3): host-side counters and
# gauges only — the mutation and search launches are untouched.
_M_MUT = _metrics.counter(
    "eli_stream_mutations_total", "streaming mutations by operation",
    ("op",),
)
_M_MUT_ROWS = _metrics.counter(
    "eli_stream_rows_total",
    "rows moved by streaming mutations (inserted/deleted/folded/dropped)",
    ("op",),
)
_M_MUT_S = _metrics.histogram(
    "eli_stream_mutation_seconds", "streaming mutation wall time", ("op",),
)
_M_RESELECTS = _metrics.counter(
    "eli_stream_reselects_total",
    "drift-triggered reselects piggybacked on a compaction",
)
_M_LIVE = _metrics.gauge(
    "eli_stream_live_rows", "rows a streaming search can return",
)
_M_TOMB = _metrics.gauge(
    "eli_stream_tombstoned_rows", "deleted-but-not-yet-compacted rows",
)
_M_DELTA = _metrics.gauge(
    "eli_stream_delta_rows", "rows resident in the delta arena / staging",
)


class StreamingEngine:
    """Mutable façade over a ``LabelHybridEngine`` (DESIGN.md §3.6)."""

    def __init__(self, engine: LabelHybridEngine, *,
                 max_delta_fraction: float | None = 0.25,
                 max_tombstone_fraction: float | None = 0.25,
                 min_delta_capacity: int = MIN_DELTA_CAPACITY,
                 max_delta_capacity: int | None = None,
                 monitor: WorkloadMonitor | None = None,
                 drift_threshold: float = 0.25,
                 min_queries: int = 200,
                 space_budget: int | None = None,
                 build_kwargs: dict | None = None,
                 lazy_deletes: bool = True):
        self.base = engine
        self.max_delta_fraction = max_delta_fraction
        self.max_tombstone_fraction = max_tombstone_fraction
        self.min_delta_capacity = min_delta_capacity
        self.max_delta_capacity = max_delta_capacity
        # False folds every private-storage delete before the next search
        self._lazy_deletes = lazy_deletes
        self.monitor = monitor
        self.drift_threshold = drift_threshold
        self.min_queries = min_queries
        self.space_budget = space_budget
        # fold replay arguments for the private-storage path: the fold IS a
        # from-scratch build on the survivors, so it must reuse the original
        # construction arguments verbatim (determinism ⇒ parity), on the
        # engine's device
        self._build_kwargs = dict(build_kwargs) if build_kwargs else dict(
            mode="eis", c=engine.selection.c, backend=engine.backend,
            metric=engine.metric, storage=engine.storage,
            **engine.backend_params)
        self._build_kwargs.setdefault("device", engine.device)
        self.compaction_log: list[dict] = []
        self._reset_staging()

    # -- construction ---------------------------------------------------------
    @staticmethod
    def build(vectors: np.ndarray, label_sets: Sequence[tuple[int, ...]], *,
              max_delta_fraction: float | None = 0.25,
              max_tombstone_fraction: float | None = 0.25,
              min_delta_capacity: int = MIN_DELTA_CAPACITY,
              max_delta_capacity: int | None = None,
              monitor: WorkloadMonitor | None = None,
              drift_threshold: float = 0.25,
              min_queries: int = 200,
              space_budget: int | None = None,
              lazy_deletes: bool = True,
              **build_kwargs) -> "StreamingEngine":
        """Build the base ``LabelHybridEngine`` (same kwargs as
        ``LabelHybridEngine.build``, ``device`` included) and wrap it."""
        engine = LabelHybridEngine.build(vectors, label_sets, **build_kwargs)
        return StreamingEngine(
            engine, max_delta_fraction=max_delta_fraction,
            max_tombstone_fraction=max_tombstone_fraction,
            min_delta_capacity=min_delta_capacity,
            max_delta_capacity=max_delta_capacity, monitor=monitor,
            drift_threshold=drift_threshold, min_queries=min_queries,
            space_budget=space_budget, build_kwargs=build_kwargs,
            lazy_deletes=lazy_deletes)

    def _reset_staging(self) -> None:
        eng = self.base
        self._base_dead = np.zeros(len(eng.label_sets), dtype=bool)
        self._delta_dead = np.zeros(0, dtype=bool)
        self._delta_vec_parts: list[np.ndarray] = []
        self._delta_lw_parts: list[np.ndarray] = []
        self._delta_ls: list[tuple[int, ...]] = []
        self._n_inserted = 0
        self._dirty = False          # private-storage fold pending (inserts)
        self._has_base_tombs = False  # any base delete since last compaction
        self._tomb_by_key = None     # per-selected-key bitmaps (private lazy)
        if self.lazy:
            # the delta holds the SAME tiers as the base arena (inserts
            # quantize at append), so compaction re-folds tier by tier
            self.delta = DeltaArena.empty(eng.vectors.shape[1],
                                          eng.label_words.shape[1],
                                          self.min_delta_capacity,
                                          storage=eng.storage,
                                          max_capacity=self.max_delta_capacity,
                                          device=eng.device)
        else:
            self.delta = None

    # -- properties -----------------------------------------------------------
    @property
    def lazy(self) -> bool:
        """True ⇔ the base backend is arena-native, i.e. mutations are
        absorbed lazily (tombstone mask + delta scan) instead of folded
        before the next search."""
        return self.base._arena_native and self.base.arena is not None

    @property
    def lazy_deletes_active(self) -> bool:
        """True ⇔ base deletes on a private-storage backend are served
        through per-index ``search_padded(tomb=…)`` bitmaps instead of a
        fold-before-search.  Arena-native backends have their own
        (always-on) lazy path and report False here."""
        return (not self.lazy and self._lazy_deletes
                and self.base.supports_lazy_deletes)

    @property
    def sentinel(self) -> int:
        """Empty-slot id == stream cardinality (base + all inserts since
        the last compaction, including tombstoned ones)."""
        return len(self.base.label_sets) + self._n_inserted

    @property
    def vectors(self) -> np.ndarray:
        return self.base.vectors

    @property
    def label_sets(self) -> list[tuple[int, ...]]:
        """Label set per live-or-dead stream id (base then delta) — the
        array a returned id indexes into."""
        return list(self.base.label_sets) + self._delta_ls

    def label_set(self, gid: int) -> tuple[int, ...]:
        n_base = len(self.base.label_sets)
        return (tuple(self.base.label_sets[gid]) if gid < n_base
                else tuple(self._delta_ls[gid - n_base]))

    # -- mutations ------------------------------------------------------------
    def insert(self, vectors: np.ndarray,
               label_sets: Sequence[tuple[int, ...]]) -> np.ndarray:
        """Insert rows; returns their assigned global stream ids.

        Arena-native: appends into the device delta arena (one slice copy
        a buffer).  Private-storage: stages on the host until the next
        fold.  If this batch would push the delta past
        ``max_delta_fraction``, the pending state is compacted FIRST (see
        ``compaction_log`` for the renumbering of earlier ids) and the
        batch lands in the fresh delta — the ids returned are therefore
        always valid at return.
        """
        _t0 = (time.perf_counter()
               if _metrics.enabled() or _trace.enabled() else 0.0)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.base.vectors.shape[1]:
            raise ValueError(f"expected [m, {self.base.vectors.shape[1]}] "
                             f"vectors, got {vectors.shape}")
        label_sets = [tuple(ls) for ls in label_sets]
        if len(label_sets) != vectors.shape[0]:
            raise ValueError("one label set per inserted vector required")
        m = vectors.shape[0]
        if m == 0:
            return np.zeros(0, dtype=np.int64)
        if (self.max_delta_fraction is not None
                and self._n_inserted + m > self.max_delta_fraction
                * max(1, len(self.base.label_sets))):
            self.flush()
        check_global_id_contract(self.sentinel + m)   # sentinel must fit
        lw = masks_to_int32_words(encode_many(label_sets))
        ids = np.arange(self.sentinel, self.sentinel + m, dtype=np.int64)

        # the append runs FIRST: it is the step that can raise (a typed
        # CapacityError at the max_delta_capacity ceiling, before any
        # buffer is written), and a failed insert must leave the engine as
        # it was — no half-staged host parts, no advanced cursor
        new_delta = self.delta.appended(vectors, lw) if self.lazy else None
        self._delta_vec_parts.append(vectors)
        self._delta_lw_parts.append(lw)
        self._delta_ls.extend(label_sets)
        self._delta_dead = np.concatenate(
            [self._delta_dead, np.zeros(m, dtype=bool)])
        self._n_inserted += m
        if self.lazy:
            self.delta = new_delta
        else:
            self._dirty = True
        self._record_mutation("insert", m, _t0)
        return ids

    def ensure_insert_capacity(self, m: int) -> None:
        """Raise :class:`CapacityError` iff ``insert`` of ``m`` rows would
        — after any delta-fill flush the insert itself would trigger —
        exceed ``max_delta_capacity``.  State is never touched."""
        if m == 0 or not self.lazy or self.max_delta_capacity is None:
            return
        will_flush = (self.max_delta_fraction is not None
                      and self._n_inserted + m > self.max_delta_fraction
                      * max(1, len(self.base.label_sets)))
        count = 0 if will_flush else self.delta.count
        need = count + pow2_bucket(m)
        if need > pow2_bucket(self.max_delta_capacity):
            raise CapacityError(
                f"inserting {m} rows needs delta capacity {need} "
                f"(max_delta_capacity {self.max_delta_capacity})")

    def delete(self, ids) -> int:
        """Tombstone rows by global stream id; returns how many were newly
        deleted (repeat deletes are idempotent no-ops).  Arena-native
        engines re-pack and upload the arena bitmap (⌈N/8⌉ bytes), fused
        into the next search's filter; private-storage engines invalidate
        their per-selected-key bitmaps, re-derived at the next search.
        Staged-delta deletes ride the fold their insert already forced.
        May trigger automatic compaction."""
        _t0 = (time.perf_counter()
               if _metrics.enabled() or _trace.enabled() else 0.0)
        ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        if ids.size == 0:
            return 0
        n_base = len(self.base.label_sets)
        if ids.min() < 0 or ids.max() >= self.sentinel:
            raise ValueError(f"ids outside [0, {self.sentinel})")
        base_ids = ids[ids < n_base]
        delta_slots = ids[ids >= n_base] - n_base
        newly = int((~self._base_dead[base_ids]).sum()
                    + (~self._delta_dead[delta_slots]).sum())
        if newly == 0:
            return 0
        self._base_dead[base_ids] = True
        self._delta_dead[delta_slots] = True
        if self.lazy:
            if base_ids.size:
                self.base.arena = self.base.arena.with_tombstones(
                    self._base_dead)
                self._has_base_tombs = True
            if delta_slots.size:
                self.delta = self.delta.with_tombstones(self._delta_dead)
        elif base_ids.size:
            if self.lazy_deletes_active:
                self._has_base_tombs = True
                self._tomb_by_key = None     # re-derive at next search
            else:
                self._dirty = True
        # non-lazy delta_slots: those rows are staged on the host and only
        # become searchable at the fold their insert made pending
        # (_dirty) — the fold reads _delta_dead, nothing else to do
        self._record_mutation("delete", newly, _t0)
        self._maybe_compact()
        return newly

    def _private_tombs(self) -> dict | None:
        """Per-selected-key packed bitmaps for the private-storage lazy
        path, derived from the global base dead mask through each key's
        member-row table (local row r of index I(key) is global row
        ``rows[key][r]``), on the engine's device: uploaded once a delete
        batch, not once a search.  Keys with no dead member stay absent so
        their groups search tombstone-free.  Cached until the next delete
        or compaction."""
        if not self._has_base_tombs:
            return None
        if self._tomb_by_key is None:
            tombs = {}
            for key, rows in self.base.rows.items():
                dead = self._base_dead[rows]
                if dead.any():
                    tombs[key] = torch.from_numpy(
                        pack_tombstones(dead)).to(self.base.device)
            self._tomb_by_key = tombs
        return self._tomb_by_key

    # -- compaction -----------------------------------------------------------
    def _maybe_compact(self) -> None:
        """Deleted-fraction trigger (the delta-fill trigger runs at the
        TOP of ``insert`` so freshly returned ids are never invalidated
        by the very call that produced them)."""
        dead = int(self._base_dead.sum() + self._delta_dead.sum())
        if (self.max_tombstone_fraction is not None
                and dead > self.max_tombstone_fraction
                * max(1, self.sentinel)):
            self.flush()

    def _survivors(self):
        """(alive_base, alive_delta, id_map, new_label_sets) for the
        current mutation state; survivors keep stream order, so the
        old→new renumbering is monotonic — the property the merged
        (distance, id) order's parity with a rebuild relies on."""
        eng = self.base
        n_base = len(eng.label_sets)
        alive_base = ~self._base_dead
        alive_delta = ~self._delta_dead
        nb, nd = int(alive_base.sum()), int(alive_delta.sum())
        id_map = np.full(n_base + self._n_inserted, -1, dtype=np.int64)
        id_map[:n_base][alive_base] = np.arange(nb)
        id_map[n_base:][alive_delta] = nb + np.arange(nd)
        new_ls = ([ls for ls, a in zip(eng.label_sets, alive_base) if a]
                  + [ls for ls, a in zip(self._delta_ls, alive_delta) if a])
        return alive_base, alive_delta, id_map, new_ls

    def flush(self) -> dict:
        """Compact now: fold live delta rows in, drop tombstoned rows,
        renumber survivors (the report carries the ``id_map``), optionally
        piggyback a drift-triggered reselect.  Returns the report (also
        appended to ``compaction_log``)."""
        t0 = time.perf_counter()
        alive_base, alive_delta, id_map, new_ls = self._survivors()
        faultpoint("compact.mid_fold")
        dropped = int((~alive_base).sum() + (~alive_delta).sum())
        folded = int(alive_delta.sum())
        reselected = False
        if self.lazy:
            if self._n_inserted or dropped:   # mutation-free flush: no-op
                reselected = self._compact_lazy(alive_base, alive_delta,
                                                new_ls, id_map)
        elif self._dirty or dropped or folded:
            reselected = self._compact_private(alive_base, alive_delta,
                                               new_ls)
        self._reset_staging()
        rec = {"seconds": time.perf_counter() - t0, "folded_rows": folded,
               "dropped_rows": dropped, "n": len(self.base.label_sets),
               "reselected": reselected, "id_map": id_map,
               "arena_version": (self.base.arena.version
                                 if self.base.arena is not None else 0)}
        self.compaction_log.append(rec)
        if _metrics.enabled():
            _M_MUT_ROWS.labels("folded").inc(folded)
            _M_MUT_ROWS.labels("dropped").inc(dropped)
            if reselected:
                _M_RESELECTS.inc()
        self._record_mutation("flush", folded, t0)
        return rec

    def _record_mutation(self, op: str, rows: int, t0: float) -> None:
        """Host-side mutation accounting — one boolean check when
        telemetry is off, plain-Python bookkeeping when on."""
        if _metrics.enabled():
            _M_MUT.labels(op).inc()
            _M_MUT_ROWS.labels(op).inc(rows)
            _M_MUT_S.labels(op).observe(time.perf_counter() - t0)
            dead = int(self._base_dead.sum() + self._delta_dead.sum())
            _M_LIVE.set(self.sentinel - dead)
            _M_TOMB.set(dead)
            _M_DELTA.set(self._n_inserted)
        if _trace.enabled():
            _trace.get_tracer().complete(
                "stream." + op, t0, time.perf_counter(), rows=rows)

    def _piggyback_selection(self, table: GroupTable) -> EISResult | None:
        """Drift-triggered weighted reselect, evaluated only when a
        compaction is already paying for a rebuild."""
        if (self.monitor is None or self.space_budget is None
                or self.monitor.n_seen < self.min_queries
                or self.monitor.drift() <= self.drift_threshold):
            return None
        sel = weighted_select(table.closure_sizes,
                              self.monitor.distribution(), self.space_budget)
        self.monitor.snapshot()
        return selection_from_weighted(sel)

    def _live_delta(self, alive_delta):
        """The live delta rows' host vectors and label words."""
        eng = self.base
        if not self._n_inserted:
            return (np.zeros((0, eng.vectors.shape[1]), np.float32),
                    np.zeros((0, eng.label_words.shape[1]), np.int32))
        return (np.concatenate(self._delta_vec_parts)[alive_delta],
                np.concatenate(self._delta_lw_parts)[alive_delta])

    def _compact_lazy(self, alive_base, alive_delta, new_ls,
                      id_map) -> bool:
        eng = self.base
        # incremental GroupTable: membership remap + closure arithmetic —
        # no re-grouping pass, no O(Σ 2^|G|) subset re-expansion
        delta_ls_alive = [ls for ls, a in zip(self._delta_ls, alive_delta)
                          if a]
        restricted = self._build_kwargs.get("query_label_sets") is not None
        table = eng.table.compacted(alive_base, delta_ls_alive,
                                    add_new_candidates=not restricted)
        selection = self._piggyback_selection(table)
        reselected = selection is not None
        if selection is None:
            # keep the selected keys, refresh their sizes from the updated
            # closures (empty closures keep their — now empty — segment:
            # PostFiltering is exact inside any superset-key index)
            selected = {key: (table.n if key == EMPTY_KEY
                              else int(table.closure_sizes.get(key, 0)))
                        for key in eng.selection.selected}
            selection = EISResult(
                selected=selected,
                cost=sum(v for kk, v in selected.items() if kk != EMPTY_KEY),
                rounds=list(eng.selection.rounds), c=eng.selection.c,
                assignment=dict(eng.selection.assignment))

        # remap the OLD segments into the new numbering instead of paying
        # closure_members() per selected key: survivors keep stream order,
        # so old member lists filter+shift monotonically, and appended
        # delta rows (ids ≥ #alive base) append in containment order —
        # what the new table's closure_members would return.  The
        # renumbering is _survivors()'s id_map, its one definition
        n_base = len(eng.label_sets)
        remap = id_map[:n_base]
        delta_new_ids = id_map[n_base:][alive_delta]
        delta_masks = encode_many(delta_ls_alive)
        rows_hint = {}
        for key in selection.selected:
            old = eng.rows.get(key)
            if old is None:
                continue                 # new key (reselect): table path
            r = remap[old]
            r = r[r >= 0]
            if len(delta_ls_alive):
                keym = key_to_mask(key)
                cont = np.all((delta_masks & keym[None, :]) == keym[None, :],
                              axis=1)
                r = np.concatenate([r, delta_new_ids[cont]])
            rows_hint[key] = as_row_ids(r, table.n)

        # fold the arena from the host mirrors (every row already lives
        # there) through Arena.from_host, the upload a rebuilt engine
        # makes, and carry the version forward
        dv, dlw = self._live_delta(alive_delta)
        new_vecs = np.concatenate([eng.vectors[alive_base], dv])
        new_lw = np.concatenate([eng.label_words[alive_base], dlw])
        arena = dataclasses.replace(
            Arena.from_host(new_vecs, new_lw, storage=eng.storage,
                            device=eng.device),
            version=eng.arena.version + 1)
        eng.rebase(new_vecs, new_ls, table, selection, arena=arena,
                   label_words=new_lw, rows_hint=rows_hint)
        return reselected

    def _compact_private(self, alive_base, alive_delta, new_ls) -> bool:
        eng = self.base
        dv, _ = self._live_delta(alive_delta)
        new_vecs = np.concatenate([eng.vectors[alive_base], dv])
        # the fold IS a from-scratch build with the original arguments —
        # the seeded builders make it bit-identical to a rebuilt engine
        self.base = LabelHybridEngine.build(new_vecs, new_ls,
                                            **self._build_kwargs)
        selection = self._piggyback_selection(self.base.table)
        if selection is not None:
            self.base.apply_selection(selection)
            return True
        return False

    def _fold_if_dirty(self) -> None:
        if not self.lazy and self._dirty:
            self.flush()

    # -- search ---------------------------------------------------------------
    def search(self, queries: np.ndarray,
               query_label_sets: Sequence[tuple[int, ...]], k: int,
               **search_params) -> tuple[np.ndarray, np.ndarray]:
        return self.search_batched(queries, query_label_sets, k,
                                   **search_params)

    def search_batched(self, queries: np.ndarray,
                       query_label_sets: Sequence[tuple[int, ...]], k: int,
                       *, min_bucket: int = 1,
                       **search_params) -> tuple[np.ndarray, np.ndarray]:
        """Filtered top-k over the mutated stream — bit-identical (modulo
        the monotonic survivor renumbering) to
        ``LabelHybridEngine.search_batched`` on an engine rebuilt from the
        surviving rows.

        Arena-native: per candidate-span tier (the base executor's
        partition, ``arena_tier_batches``) one tombstone-fused
        ``segmented_topk`` and one device scatter into a query-aligned
        [Q-bucket, k] buffer; then ONE delta scan for the whole batch and
        ONE merge on the device; one copy to the host at the end.
        Private-storage: pending INSERTS fold (the structures cannot
        absorb them in place); pending DELETES stay lazy — per-selected-key
        tombstone bitmaps down ``search_padded(tomb=…)``.
        """
        telem = _metrics.enabled() or _trace.enabled()
        t_start = time.perf_counter() if telem else 0.0
        if self.monitor is not None:
            self.monitor.observe([tuple(ls) for ls in query_label_sets])
        if not self.lazy:
            self._fold_if_dirty()
            return self.base.search_batched(queries, query_label_sets, k,
                                            min_bucket=min_bucket,
                                            tomb_by_key=self._private_tombs(),
                                            **search_params)
        eng = self.base
        eng._no_search_params(search_params)
        queries = np.asarray(queries, dtype=np.float32)
        Q = queries.shape[0]
        n_base = len(eng.label_sets)
        sentinel = check_global_id_contract(self.sentinel)
        if Q == 0:
            return (np.full((0, k), np.inf, dtype=np.float32),
                    np.full((0, k), sentinel, dtype=np.int32))

        qmasks = encode_many(query_label_sets)
        qwords = masks_to_int32_words(qmasks)
        routed = eng.route_many(query_label_sets, qmasks)
        t_route = time.perf_counter() if telem else 0.0
        dev = eng.device
        tier_bucket: dict[int, int] = {}
        delta = self.delta
        # the tombstone mask only while base deletes are pending: an
        # un-deleted stream runs the static search
        tomb = eng.arena.tombstones if self._has_base_tombs else None
        qb = pow2_bucket(Q, min_bucket)
        base_v = torch.full((qb, k), float("inf"), dtype=torch.float32,
                            device=dev)
        base_g = torch.full((qb, k), n_base, dtype=torch.int32, device=dev)
        for qids, qp, lp, starts, lens, lmax, g in \
                eng.arena_tier_batches(queries, qwords, routed, min_bucket):
            tier_bucket[lmax] = qp.shape[0]
            bvals, _, bgid = _kernel_ops.segmented_topk(
                qp, lp, eng.arena.vectors, eng.arena.label_words,
                eng.arena.norms, eng._rows_concat_dev, starts, lens,
                k=k, lmax=lmax, metric=eng.metric,
                backend=eng._seg_backend, tomb=tomb, fused=eng._seg_fused,
                device=dev, **eng.arena.tier_kwargs())
            idx = torch.from_numpy(np.asarray(qids, np.int64)).to(dev)
            _kernel_ops.scatter_topk_rows(base_v, base_g, idx, bvals, bgid)
        if delta.count:
            # the delta is scanned ONCE for the whole batch: a query's
            # top-k does not depend on its batch neighbours
            qp_all = np.zeros((qb, queries.shape[1]), np.float32)
            qp_all[:Q] = queries
            lp_all = np.zeros((qb, qwords.shape[1]), np.int32)
            lp_all[:Q] = qwords
            dvals, dslot = _kernel_ops.delta_topk(
                qp_all, lp_all, delta.vectors, delta.label_words,
                delta.norms, delta.tombstones, delta.count, k=k,
                metric=eng.metric, backend=eng._seg_backend,
                fused=eng._seg_fused, device=dev, **delta.tier_kwargs())
            base_v, base_g = _kernel_ops.merge_topk(
                base_v, base_g, dvals, dslot, n_base, sentinel, k=k)
        # empty delta: base_g's empty-slot id n_base IS the stream sentinel.
        # One copy to the host: values (as their bits) beside ids
        both = torch.cat([base_v[:Q].view(torch.int32), base_g[:Q]],
                         dim=1).cpu().numpy()
        out_d = np.ascontiguousarray(both[:, :k]).view(np.float32)
        out_i = np.ascontiguousarray(both[:, k:])
        if telem:
            dead = int(self._base_dead.sum() + self._delta_dead.sum())
            record_search_telemetry(
                eng, routed, qmasks, k, Q, t_start=t_start, t_route=t_route,
                tier_bucket=tier_bucket, min_bucket=min_bucket,
                tomb_density=dead / max(1, self.sentinel))
        return out_d, out_i

    # -- warmup ---------------------------------------------------------------
    def warmup(self, ks: Sequence[int], buckets: Sequence[int],
               **search_params) -> dict:
        """Run every launch the first streaming batches need once on zero
        queries: the base search per (k, Q-bucket, span tier) with and
        without the tombstone bitmap, the delta scan per (k, Q-bucket) at
        the current capacity tier, the merge and the scatter.
        Private-storage backends fold pending inserts and delegate to the
        base warmup, with each index's tombstone variant when lazy deletes
        are active.  Returns ``{"seconds", "programs"}``."""
        if not self.lazy:
            self._fold_if_dirty()
            return self.base.warmup(ks, buckets,
                                    tomb_variants=self.lazy_deletes_active,
                                    **search_params)
        t0 = time.perf_counter()
        eng, delta = self.base, self.delta
        eng._no_search_params(search_params)
        dev = eng.device
        D = eng.vectors.shape[1]
        W = eng.label_words.shape[1]
        span_tiers = sorted({pow2_bucket(length)
                             for _, length in eng.segments.values()})
        programs = 0
        for k in ks:
            for b in buckets:
                bucket = pow2_bucket(b)
                qz = np.zeros((bucket, D), np.float32)
                lz = np.zeros((bucket, W), np.int32)
                zero = np.zeros(bucket, np.int32)
                dvals, dslot = _kernel_ops.delta_topk(
                    qz, lz, delta.vectors, delta.label_words, delta.norms,
                    delta.tombstones, delta.count, k=k, metric=eng.metric,
                    backend=eng._seg_backend, fused=eng._seg_fused,
                    device=dev, **delta.tier_kwargs())
                programs += 1
                for lmax in span_tiers:
                    for tomb in (None, eng.arena.tombstones):
                        bvals, _, bgid = _kernel_ops.segmented_topk(
                            qz, lz, eng.arena.vectors,
                            eng.arena.label_words, eng.arena.norms,
                            eng._rows_concat_dev, zero, zero,
                            k=k, lmax=lmax, metric=eng.metric,
                            backend=eng._seg_backend, tomb=tomb,
                            fused=eng._seg_fused, device=dev,
                            **eng.arena.tier_kwargs())
                        programs += 1
                _kernel_ops.scatter_topk_rows(
                    torch.full_like(bvals, float("inf")),
                    torch.zeros_like(bgid),
                    torch.arange(bucket, device=dev), bvals, bgid)
                _kernel_ops.merge_topk(bvals, bgid, dvals, dslot,
                                       len(eng.label_sets), self.sentinel,
                                       k=k)
                programs += 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {"seconds": time.perf_counter() - t0, "programs": programs}

    def warmup_serving(self, ks: Sequence[int], min_bucket: int,
                       max_batch: int, *, delta_rows_hint: int | None = None,
                       **search_params) -> dict:
        """Serving-shaped warmup with mutations in flight: the full
        power-of-two Q-bucket ladder a micro-batcher can emit
        (``index.base.serving_buckets``), plus — on arena-native backends —
        the delta scan at every capacity tier the delta can grow through
        before the fill trigger compacts it, so a mid-serve insert that
        doubles the delta meets no first-launch cost.

        ``delta_rows_hint``: expected delta occupancy before the next
        flush; defaults to the ``max_delta_fraction`` trigger point (the
        most the delta can hold), or just the current tier when the
        trigger is disabled."""
        buckets = serving_buckets(min_bucket, max_batch)
        out = self.warmup(ks, buckets, **search_params)
        if not self.lazy:
            return out
        t0 = time.perf_counter()
        eng = self.base
        dev = eng.device
        if delta_rows_hint is None:
            delta_rows_hint = (
                int(self.max_delta_fraction * max(1, len(eng.label_sets)))
                if self.max_delta_fraction is not None else 0)
        D = eng.vectors.shape[1]
        W = eng.label_words.shape[1]
        cap = self.delta.capacity
        top = pow2_bucket(max(delta_rows_hint, cap))
        programs = 0
        c = cap * 2
        while c <= top:
            dummy = DeltaArena.empty(D, W, c, storage=eng.storage,
                                     device=dev)
            for k in ks:
                for b in buckets:
                    qz = np.zeros((b, D), np.float32)
                    lz = np.zeros((b, W), np.int32)
                    _kernel_ops.delta_topk(
                        qz, lz, dummy.vectors, dummy.label_words,
                        dummy.norms, dummy.tombstones, dummy.count, k=k,
                        metric=eng.metric, backend=eng._seg_backend,
                        fused=eng._seg_fused, device=dev,
                        **dummy.tier_kwargs())
                    programs += 1
            c *= 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"] += time.perf_counter() - t0
        out["programs"] += programs
        return out

    # -- durability hooks (DESIGN.md §5) ---------------------------------------
    def staged_state(self) -> dict:
        """The host-side mutation staging a snapshot must persist — every
        pending insert/delete since the last compaction, with the original
        append batching kept (``part_lens``) so a restore replays the
        delta's power-of-two growth and its buffers come out byte for byte
        the same.  Plain numpy arrays and lists: the JAX package's
        ``staged_state()`` has the same keys, and either restores into the
        other."""
        return {
            "base_dead": self._base_dead.copy(),
            "delta_dead": self._delta_dead.copy(),
            "delta_vectors": (np.concatenate(self._delta_vec_parts)
                              if self._delta_vec_parts else
                              np.zeros((0, self.base.vectors.shape[1]),
                                       np.float32)),
            "part_lens": np.asarray(
                [len(p) for p in self._delta_vec_parts], np.int64),
            "delta_ls": list(self._delta_ls),
            "n_inserted": self._n_inserted,
            "dirty": self._dirty,
            "has_base_tombs": self._has_base_tombs,
        }

    def restore_staged_state(self, state: dict) -> None:
        """Inverse of :meth:`staged_state` on a freshly built engine
        (``LabelHybridEngine.from_reference_state`` for a JAX stream's
        state): re-stage the pending mutations WITHOUT re-running the
        compaction triggers (the state was captured after them)."""
        self._reset_staging()
        ls = [tuple(s) for s in state["delta_ls"]]
        vecs = np.ascontiguousarray(state["delta_vectors"], np.float32)
        off = 0
        for n in np.asarray(state["part_lens"], np.int64):
            part = vecs[off:off + int(n)]
            lw = masks_to_int32_words(encode_many(ls[off:off + int(n)]))
            self._delta_vec_parts.append(part)
            self._delta_lw_parts.append(lw)
            if self.lazy:
                self.delta = self.delta.appended(part, lw)
            off += int(n)
        self._delta_ls = ls
        self._n_inserted = int(state["n_inserted"])
        self._base_dead = np.asarray(state["base_dead"], bool).copy()
        self._delta_dead = np.asarray(state["delta_dead"], bool).copy()
        self._dirty = bool(state["dirty"])
        self._has_base_tombs = bool(state["has_base_tombs"])
        if self.lazy:
            if self._has_base_tombs:
                self.base.arena = self.base.arena.with_tombstones(
                    self._base_dead)
            if self._delta_dead.any():
                self.delta = self.delta.with_tombstones(self._delta_dead)

    # -- reporting ------------------------------------------------------------
    def stats(self):
        """Base-engine stats with the streaming surface filled in:
        ``live_rows`` / ``tombstoned_rows`` / ``delta_rows`` /
        ``arena_version`` / ``delta_nbytes``; ``nbytes`` and the per-tier
        split also count the delta arena."""
        st = self.base.stats()
        dead = int(self._base_dead.sum() + self._delta_dead.sum())
        delta_nbytes = self.delta.nbytes if self.delta is not None else 0
        dt = (self.delta.tier_nbytes if self.delta is not None
              else {"codes": 0, "scales": 0, "rerank": 0, "tombstone": 0})
        st = dataclasses.replace(
            st,
            live_rows=self.sentinel - dead,
            tombstoned_rows=dead,
            delta_rows=self._n_inserted,
            arena_version=(self.base.arena.version
                           if self.base.arena is not None else 0),
            delta_nbytes=delta_nbytes,
            nbytes=st.nbytes + delta_nbytes,
            codes_nbytes=st.codes_nbytes + dt["codes"],
            scales_nbytes=st.scales_nbytes + dt["scales"],
            rerank_nbytes=st.rerank_nbytes + dt["rerank"],
            tombstone_nbytes=st.tombstone_nbytes + dt["tombstone"],
        )
        publish_engine_gauges(st)
        return st
