"""Port parity, the streaming slice: ``StreamingEngine`` (inserts into a
delta arena, tombstoned deletes, the base + delta merge, compaction),
``GroupTable.compacted``, ``core/adaptive.py`` and the port's own fault
registry, against the JAX package and numpy oracles, on the CPU.

Tiers:
  * cross-package, on integer data (``rint(randn·4)``, every f32 sum
    exact): one program of inserts that cross a capacity tier, base and
    delta deletes, searches and a flush gives the JAX stream's ids and
    values bitwise for f32 and fp16, its ids bitwise and its values
    allclose for int8+rerank; the JAX stream's ``staged_state()`` carried
    into the port's ``restore_staged_state()`` (on an engine built by
    ``from_reference_state``) searches the same; the delta arenas' buffers
    are byte for byte the reference's;
  * within the port, on random data: pending ≡ an engine rebuilt on the
    survivors ≡ after ``flush``, bitwise (ids through the survivor
    renumbering), for f32 / fp16 / int8+rerank, fused and unfused;
  * random interleavings against a float64 numpy oracle over the
    survivors (the reference's own interleaving test fails, ROADMAP C1);
  * private-storage backends (ivf, graph, the private ``FlatIndex``):
    lazy deletes bitwise the same structure whose dead rows fail the
    filter (the label trick of tests/test_tombstone_backends.py), and an
    insert's fold bitwise a rebuild with the same arguments.

Each test folds its cases into loops: the suite's collected count decides
how pytest-xdist splits the reference suite (ROADMAP C1)."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

from repro.core import GroupTable as JaxGroupTable
from repro.core import StreamingEngine as JaxStream
from repro.core import WorkloadMonitor as JaxMonitor
from repro.core import (LabelWorkloadConfig, encode_many, generate_label_sets,
                        generate_query_label_sets, masks_to_int32_words)
from repro.core import weighted_select as jax_weighted_select

# The port is imported by the ``_port`` fixture, not at collection (see
# test_torch_engine.py: loading torch slows the JAX tests of a worker).
torch = pcore = pbase = pflat = None

STORAGES = ("f32", "fp16", "int8+rerank")
RESERVED = 7          # the label-trick bit: all rows carry it, dead lose it


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, pcore, pbase, pflat
    import torch
    import repro_torch.core as pcore
    from repro_torch.index import base as pbase
    from repro_torch.index import flat as pflat
    # release the JAX programs compiled in this worker before this
    # module (and, at the end, by it): each holds memory maps, and
    # a worker that reaches vm.max_map_count segfaults in its next
    # XLA compile (ROADMAP C1)
    import jax
    jax.clear_caches()
    # one intra-op thread: the suite runs in several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def integer_rows(rng, n, d):
    return np.rint(rng.standard_normal((n, d)) * 4).astype(np.float32)


def reference_state(eng) -> dict:
    """The JAX engine's state as plain numpy arrays, dicts and lists."""
    sel = eng.selection
    return dict(vectors=np.asarray(eng.vectors), label_sets=eng.label_sets,
                closure_sizes=dict(eng.table.closure_sizes),
                selected=list(sel.selected.items()),
                assignment=dict(sel.assignment), cost=sel.cost,
                rounds=list(sel.rounds), c=sel.c, storage=eng.storage,
                backend_params=dict(eng.backend_params), metric=eng.metric)


def stream_ids(rng, se, n_base_dead, every):
    """Base ids to delete and the delta's every ``every``-th slot."""
    n_base = len(se.base.label_sets)
    delta = np.arange(n_base, se.sentinel)[::every]
    return np.concatenate([rng.choice(n_base, n_base_dead, replace=False),
                           delta])


def survivors(se):
    """(vectors, label sets, stream ids) of the surviving rows in stream
    order, from the stream's host staging."""
    alive_b, alive_d = ~se._base_dead, ~se._delta_dead
    parts = [se.base.vectors[alive_b]]
    if se._n_inserted:
        parts.append(np.concatenate(se._delta_vec_parts)[alive_d])
    ls = ([s for s, a in zip(se.base.label_sets, alive_b) if a]
          + [s for s, a in zip(se._delta_ls, alive_d) if a])
    ids = np.concatenate([np.flatnonzero(alive_b),
                          len(se.base.label_sets) + np.flatnonzero(alive_d)])
    return np.concatenate(parts), ls, ids


def to_stream(ids, surv_ids, sentinel):
    """A rebuilt engine's compact ids -> stream ids (empty -> sentinel)."""
    n = surv_ids.size
    return np.where(ids < n, surv_ids[np.clip(ids, 0, max(n - 1, 0))],
                    sentinel).astype(np.int32)


def assert_bitwise(got, want, tag):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{tag} ids")
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32),
                                  err_msg=f"{tag} values")


# ---------------------------------------------------------------------------
# (a) the JAX stream and the port's on one program
# ---------------------------------------------------------------------------

K, BUCKET = 5, 64     # one k and one Q-bucket: few JAX compiles


@pytest.fixture(scope="module")
def reference_runs():
    """One program (insert 40 rows; delete base and delta ids; search;
    insert 60 more, which grows the delta from 64 to 128 slots; delete;
    search; flush; search) through the JAX stream and the port's, per
    storage spec; the JAX stream's staged state before the flush; both
    deltas before the flush."""
    rng = np.random.default_rng(31)
    N, D, Q = 600, 16, 40
    x = integer_rows(rng, N, D)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=8, seed=5))
    qv = integer_rows(rng, Q, D)
    qls = generate_query_label_sets(ls, Q - 2, seed=6,
                                    from_base_fraction=0.75)
    qls += [(), (0, 1)]
    pool = integer_rows(rng, 100, D)
    pool_ls = generate_label_sets(100, LabelWorkloadConfig(num_labels=8,
                                                           seed=7))
    runs = {}
    for storage in STORAGES:
        kw = dict(mode="eis", c=0.2, backend="flat", storage=storage,
                  max_delta_fraction=None, max_tombstone_fraction=None,
                  min_delta_capacity=64)
        streams = {"jax": JaxStream.build(x, ls, **kw),
                   "port": pcore.StreamingEngine.build(x, ls, device="cpu",
                                                       **kw)}
        out = {name: [] for name in streams}
        for name, se in streams.items():
            prng = np.random.default_rng(33)
            se.insert(pool[:40], pool_ls[:40])
            se.delete(stream_ids(prng, se, 30, 5))
            out[name].append(se.search_batched(qv, qls, K,
                                               min_bucket=BUCKET))
            se.insert(pool[40:], pool_ls[40:])
            se.delete(stream_ids(prng, se, 10, 4))
            out[name].append(se.search_batched(qv, qls, K,
                                               min_bucket=BUCKET))
        js = streams["jax"]
        staged = js.staged_state()
        carried = pcore.StreamingEngine(
            pcore.LabelHybridEngine.from_reference_state(
                reference_state(js.base), device="cpu"),
            max_delta_fraction=None, max_tombstone_fraction=None,
            min_delta_capacity=64)
        carried.restore_staged_state(staged)
        deltas = {name: se.delta for name, se in streams.items()}
        deltas["carried"] = carried.delta
        out["carried"] = [carried.search_batched(qv, qls, K,
                                                 min_bucket=BUCKET)]
        reps = {name: se.flush() for name, se in streams.items()}
        for name, se in streams.items():
            out[name].append(se.search_batched(qv, qls, K,
                                               min_bucket=BUCKET))
        runs[storage] = dict(out=out, reps=reps, deltas=deltas, rows=pool,
                             words=masks_to_int32_words(
                                 encode_many(pool_ls)))
    return runs


def test_stream_matches_the_reference_stream(reference_runs):
    """Every search of the program, the port's stream and the stream
    carried over from the JAX stream's staged state, against the JAX
    stream: ids bitwise; values bitwise for f32 and fp16, allclose
    (rtol 1e-5) for int8+rerank (dequantized rows are not integers).
    The flushes renumber alike."""
    for storage, run in reference_runs.items():
        out = run["out"]
        pairs = [(out["port"][i], out["jax"][i], f"search {i}")
                 for i in range(3)]
        pairs.append((out["carried"][0], out["jax"][1], "carried"))
        for got, want, tag in pairs:
            want = tuple(np.asarray(a) for a in want)
            tag = f"{storage} {tag}"
            if storage == "int8+rerank":
                np.testing.assert_array_equal(got[1], want[1], err_msg=tag)
                np.testing.assert_array_equal(np.isinf(got[0]),
                                              np.isinf(want[0]))
                fin = np.isfinite(want[0])
                np.testing.assert_allclose(got[0][fin], want[0][fin],
                                           rtol=1e-5, atol=1e-4,
                                           err_msg=tag)
            else:
                assert_bitwise(got, want, tag)
        reps = run["reps"]
        np.testing.assert_array_equal(reps["port"]["id_map"],
                                      reps["jax"]["id_map"])
        assert (reps["port"]["folded_rows"], reps["port"]["dropped_rows"]) \
            == (reps["jax"]["folded_rows"], reps["jax"]["dropped_rows"])
        # the second insert grew the delta a tier (64 -> 128 slots)
        assert run["deltas"]["jax"].capacity == 128


# ---------------------------------------------------------------------------
# (b) pending ≡ rebuilt ≡ flushed, within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    N, D, Q = 1500, 24, 80
    x = rng.standard_normal((N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=10, seed=3))
    qv = rng.standard_normal((Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 3, seed=4,
                                    from_base_fraction=0.75)
    qls += [(0, 1, 2, 3, 4, 5), (11,), ()]
    pool_x = rng.standard_normal((400, D)).astype(np.float32)
    pool_ls = generate_label_sets(400, LabelWorkloadConfig(num_labels=10,
                                                           seed=21))
    # a label the base never uses: queries for it are served by the delta
    pool_ls = [tuple(sorted(set(s) | ({11} if i % 9 == 0 else set())))
               for i, s in enumerate(pool_ls)]
    return dict(x=x, ls=ls, qv=qv, qls=qls, N=N, pool_x=pool_x,
                pool_ls=pool_ls)


def test_pending_equals_rebuilt_equals_flushed(data):
    """For f32, fp16 and int8+rerank, fused and unfused, k ∈ {1, 4, 17}:
    the stream with inserts and deletes pending equals an engine rebuilt
    from scratch on the survivors, bitwise (ids through the survivor
    renumbering), and so does the stream after ``flush`` (ids through
    the report's ``id_map``).  Warmup and stats report the pending
    state."""
    rng = np.random.default_rng(7)
    qv, qls = data["qv"], data["qls"]
    for storage in STORAGES:
        for fused in (False, True):
            tag = f"{storage} fused={fused}"
            se = pcore.StreamingEngine.build(
                data["x"], data["ls"], mode="eis", c=0.2, storage=storage,
                fused=fused, device="cpu", max_delta_fraction=None,
                max_tombstone_fraction=None)
            ids = se.insert(data["pool_x"][:250], data["pool_ls"][:250])
            se.delete(rng.choice(data["N"], 120, replace=False))
            se.delete(ids[::6])
            se.insert(data["pool_x"][250:], data["pool_ls"][250:])
            assert se.warmup([4], [8])["programs"] > 0
            st = se.stats()
            assert st.delta_rows == 400 and st.tombstoned_rows == 120 + 42
            assert st.live_rows == data["N"] + 400 - 162
            assert st.delta_nbytes == se.delta.nbytes > 0
            surv_x, surv_ls, surv_ids = survivors(se)
            rebuilt = pcore.LabelHybridEngine.build(
                surv_x, surv_ls, mode="eis", c=0.2, storage=storage,
                fused=fused, device="cpu")
            pending = {}
            for k in (1, 4, 17):
                pending[k] = se.search_batched(qv, qls, k)
                d, i = rebuilt.search_batched(qv, qls, k)
                assert_bitwise(pending[k], (d, to_stream(i, surv_ids,
                                                         se.sentinel)),
                               f"{tag} k={k} rebuilt")
            rep = se.flush()
            assert se.base.arena.storage == storage
            id_map = np.append(rep["id_map"], len(surv_ids))
            for k, (d, i) in pending.items():
                got = se.search_batched(qv, qls, k)
                assert_bitwise(got, (d, id_map[i].astype(np.int32)),
                               f"{tag} k={k} flushed")


# ---------------------------------------------------------------------------
# (c) random interleavings against a float64 oracle
# ---------------------------------------------------------------------------

def _oracle(surv_x, surv_lw, surv_ids, qv, qw, k, sentinel):
    """Exact filtered top-k in float64 over the survivors, ties broken by
    stream id (the survivors are in stream order)."""
    Q = qv.shape[0]
    out_d = np.full((Q, k), np.inf)
    out_i = np.full((Q, k), sentinel, np.int64)
    if surv_ids.size:
        x, q = surv_x.astype(np.float64), qv.astype(np.float64)
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        keep = np.all((qw[:, None, :] & surv_lw[None]) == qw[:, None, :],
                      axis=-1)
        d = np.where(keep, d, np.inf)
        for r in range(Q):
            order = np.lexsort((surv_ids, d[r]))[:k]
            fin = np.isfinite(d[r][order])
            out_d[r, :len(order)] = d[r][order]
            out_i[r, :len(order)] = np.where(fin, surv_ids[order], sentinel)
    return out_d, out_i


def test_random_interleavings_match_the_surviving_rows_oracle():
    """Seeded programs of insert / delete / search / flush on integer
    rows (every f32 distance exact, so ties are exact ties, broken by
    stream id in both): every search's ids and values equal the float64
    oracle over the survivors; ids are never reused; a flush renumbers in
    stream order; stats count the survivors."""
    N, D, Q = 240, 8, 12
    rng = np.random.default_rng(23)
    x = integer_rows(rng, N, D)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=6, seed=13))
    for prog_seed in range(6):
        prng = np.random.default_rng(100 + prog_seed)
        fused = bool(prog_seed % 2)
        se = pcore.StreamingEngine.build(
            x, ls, mode="eis", c=0.25, fused=fused, device="cpu",
            max_delta_fraction=None, max_tombstone_fraction=None,
            min_delta_capacity=16)
        lw0 = masks_to_int32_words(encode_many(ls))
        shadow = {i: (x[i], lw0[i]) for i in range(N)}   # stream id -> row
        next_id = N
        for _ in range(10):
            kind = prng.choice(["insert", "delete", "search", "search",
                                "flush"])
            if kind == "insert":
                m = int(prng.integers(1, 40))
                xv = integer_rows(prng, m, D)
                xls = [tuple(sorted(prng.choice(8, prng.integers(0, 4),
                                                replace=False).tolist()))
                       for _ in range(m)]
                ids = se.insert(xv, xls)
                assert list(ids) == list(range(next_id, next_id + m))
                lw = masks_to_int32_words(encode_many(xls))
                shadow.update({int(g): (xv[j], lw[j])
                               for j, g in enumerate(ids)})
                next_id += m
            elif kind == "delete" and shadow:
                live = np.fromiter(shadow, np.int64)
                victims = np.unique(prng.choice(live, prng.integers(1, 30)))
                assert se.delete(victims) == victims.size
                for v in victims:
                    del shadow[int(v)]
            elif kind == "flush":
                id_map = se.flush()["id_map"]
                old = sorted(shadow)
                assert list(id_map[old]) == list(range(len(old)))
                assert (id_map >= 0).sum() == len(old)
                shadow = {j: shadow[o] for j, o in enumerate(old)}
                next_id = len(old)
            elif kind == "search":
                k = int(prng.choice([1, 3, 7]))
                qv = integer_rows(prng, Q, D)
                qls = [tuple(sorted(prng.choice(8, prng.integers(0, 3),
                                                replace=False).tolist()))
                       for _ in range(Q)]
                qw = masks_to_int32_words(encode_many(qls))
                d, i = se.search_batched(qv, qls, k)
                sid = np.array(sorted(shadow), np.int64)
                sx = (np.stack([shadow[s][0] for s in sid]) if sid.size
                      else np.zeros((0, D), np.float32))
                slw = (np.stack([shadow[s][1] for s in sid]) if sid.size
                       else np.zeros((0, lw0.shape[1]), np.int32))
                od, oi = _oracle(sx, slw, sid, qv, qw, k, se.sentinel)
                np.testing.assert_array_equal(i, oi, err_msg=f"{prog_seed}")
                np.testing.assert_array_equal(d, od.astype(np.float32))
        assert se.stats().live_rows == len(shadow)


# ---------------------------------------------------------------------------
# (d) private-storage backends: lazy deletes and the fold
# ---------------------------------------------------------------------------

PRIVATE = {"ivf": {"nprobe": 2},
           "graph": {"M": 8, "n_cand": 16, "ef_search": 24},
           "flat_private": {}}


def test_private_backends_lazy_deletes_and_fold():
    """ivf, graph and the private-copy ``FlatIndex`` as a selection
    backend: with deletes pending (no fold), the stream equals, bitwise,
    the engine with the same selection and structure whose dead rows lack
    a label every query asks for (the label trick), through the batched
    and the looped executor, and returns no dead id; the exhaustive
    ``FlatIndex`` also equals a rebuild on the survivors.  An insert then
    folds, and the fold equals a from-scratch build with the same
    arguments, bitwise."""
    rng = np.random.default_rng(5)
    N, D, Q = 400, 16, 40
    x = rng.standard_normal((N, D)).astype(np.float32)
    base_ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=6,
                                                         seed=2))
    ls_full = [tuple(sorted(set(s) | {RESERVED})) for s in base_ls]
    dead = np.sort(rng.choice(N, 60, replace=False))
    ls_stripped = [tuple(v for v in s if v != RESERVED) if i in set(dead)
                   else s for i, s in enumerate(ls_full)]
    qv = rng.standard_normal((Q, D)).astype(np.float32)
    qls = [tuple(sorted({RESERVED} | set(int(v) for v in rng.choice(
        6, rng.integers(0, 3), replace=False)))) for _ in range(Q)]
    pool = rng.standard_normal((30, D)).astype(np.float32)
    pool_ls = [tuple(sorted({RESERVED, i % 6})) for i in range(30)]
    pbase.INDEX_REGISTRY["flat_private"] = PrivateFlat
    try:
        for backend, params in PRIVATE.items():
            kw = dict(mode="eis", c=0.2, backend=backend, device="cpu",
                      **params)
            se = pcore.StreamingEngine.build(
                x, ls_full, max_delta_fraction=None,
                max_tombstone_fraction=None, **kw)
            eng0 = se.base
            assert not se.lazy
            se.delete(dead)
            assert se.lazy_deletes_active and not se._dirty
            assert se.warmup([4], [8])["programs"] == 2 * len(eng0.indexes)
            # the same selection over the same rows and vectors builds
            # the same clusters or graph; only the dead rows' words differ
            stripped = pcore.LabelHybridEngine(
                x, ls_stripped, eng0.table, eng0.selection, None, backend,
                "l2", dict(eng0.backend_params), 0.0, device="cpu")
            for k in (1, 4, 17):
                got = se.search_batched(qv, qls, k, min_bucket=8)
                assert_bitwise(got, stripped.search_batched(qv, qls, k),
                               f"{backend} k={k} label trick")
                assert not np.isin(got[1], dead).any()
                looped = eng0.search_looped(qv, qls, k,
                                            tomb_by_key=se._private_tombs())
                assert_bitwise(got, looped, f"{backend} k={k} looped")
                if backend == "flat_private":
                    surv_x, surv_ls, surv_ids = survivors(se)
                    d, i = pcore.LabelHybridEngine.build(
                        surv_x, surv_ls, **kw).search_batched(qv, qls, k)
                    assert_bitwise(got, (d, to_stream(i, surv_ids,
                                                      se.sentinel)),
                                   f"{backend} k={k} rebuilt")
            assert se.base is eng0 and not se.compaction_log
            se.insert(pool, pool_ls)
            surv_x, surv_ls, _ = survivors(se)
            got = se.search_batched(qv, qls, 4)          # folds first
            assert se.base is not eng0 and len(se.compaction_log) == 1
            reb = pcore.LabelHybridEngine.build(surv_x, surv_ls, **kw)
            assert_bitwise(got, reb.search_batched(qv, qls, 4),
                           f"{backend} fold")
    finally:
        del pbase.INDEX_REGISTRY["flat_private"]


class PrivateFlat:
    """The private-copy ``FlatIndex`` as a selection backend: without
    ``build_view`` the engine builds one private copy a selected key."""

    supports_tombstones = True

    @staticmethod
    def build(vectors, label_words, metric="l2", **params):
        return pflat.FlatIndex(vectors, label_words, metric, **params)


# ---------------------------------------------------------------------------
# (e) host pieces against the reference
# ---------------------------------------------------------------------------

def test_host_pieces_equal_the_reference(reference_runs, data):
    """``GroupTable.compacted`` (full and restricted candidate sets),
    ``weighted_select``, ``WorkloadMonitor.drift`` and the delta arenas
    of the cross-package program equal their JAX counterparts byte for
    byte, from the same numpy inputs."""
    rng = np.random.default_rng(3)
    ls, N = data["ls"], data["N"]
    alive = rng.random(N) > 0.2
    app = data["pool_ls"][:120] + [(9, 11, 12)]
    qkeys = pcore.observed_query_keys(data["qls"])
    for query_keys, add in ((None, True), (qkeys, False)):
        jt = JaxGroupTable.build(ls, query_keys).compacted(
            alive, app, add_new_candidates=add)
        pt = pcore.GroupTable.build(ls, query_keys).compacted(
            alive, app, add_new_candidates=add)
        assert pt.n == jt.n and pt.closure_sizes == jt.closure_sizes
        assert list(pt.groups) == list(jt.groups)
        for key in jt.groups:
            np.testing.assert_array_equal(pt.groups[key], jt.groups[key])
        full = pcore.GroupTable.build(
            [s for s, a in zip(ls, alive) if a] + app, query_keys)
        if query_keys is None:
            assert pt.closure_sizes == full.closure_sizes
    sizes = pcore.GroupTable.build(ls).closure_sizes
    weights = {key: float(w) for key, w in zip(
        sizes, rng.random(len(sizes)) ** 3)}
    for budget in (0, N // 2, 4 * N):
        js = jax_weighted_select(sizes, weights, budget)
        ps = pcore.weighted_select(sizes, weights, budget)
        assert list(ps.selected.items()) == list(js.selected.items())
        assert (ps.expected_cost, ps.space, ps.assignment, ps.rounds) == \
            (js.expected_cost, js.space, js.assignment, js.rounds)
    jm, pm = JaxMonitor(halflife=50), pcore.WorkloadMonitor(halflife=50)
    for mon in (jm, pm):
        mon.observe(data["qls"][:40])
        mon.snapshot()
        mon.observe([(0, 1)] * 30 + data["qls"][40:60])
    assert pm.drift() == jm.drift() > 0 and pm.counts == jm.counts
    for storage, run in reference_runs.items():
        jd = run["deltas"]["jax"]
        # the port's delta norms are the base arena's expression on the
        # same rows, byte for byte, whatever the number of rows
        arena = pbase.Arena.from_host(run["rows"], run["words"],
                                      storage=storage, device="cpu")
        for name in ("port", "carried"):
            pd = run["deltas"][name]
            assert (pd.count, pd.capacity, pd.storage) == \
                (jd.count, jd.capacity, jd.storage)
            assert torch.equal(pd.norms[:pd.count], arena.norms)
            for buf in ("vectors", "label_words", "norms", "tombstones",
                        "scales", "zeros", "rerank", "rerank_norms"):
                want = getattr(jd, buf)
                got = getattr(pd, buf)
                assert (got is None) == (want is None), (storage, buf)
                if want is None:
                    continue
                want = np.asarray(want)
                if buf == "norms" and storage.startswith("int8"):
                    # dequantized int8 rows are not integers: the two
                    # packages sum their squares in another order (C0)
                    np.testing.assert_allclose(got.numpy(), want,
                                               rtol=1e-6)
                else:
                    assert got.numpy().tobytes() == want.tobytes(), \
                        (storage, name, buf)
            assert pd.tier_nbytes == jd.tier_nbytes


# ---------------------------------------------------------------------------
# (f) edge cases
# ---------------------------------------------------------------------------

def test_stream_edge_cases(data):
    """The auto-compaction thresholds fire; an insert that compacts first
    returns ids valid at return; deleted ids are never reused; a
    ``CapacityError`` at ``max_delta_capacity`` leaves the stream as it
    was; an armed ``compact.mid_fold`` raises ``InjectedFault`` and the
    stream still searches as before (the registry is the port's own); a
    drift-triggered reselect piggybacks on a compaction;
    ``warmup_serving`` runs the delta's capacity tiers."""
    x, ls, px, pls = data["x"], data["ls"], data["pool_x"], data["pool_ls"]
    qv, qls = data["qv"][:16], data["qls"][:16]
    build = pcore.StreamingEngine.build

    # thresholds
    se = build(x[:1000], ls[:1000], device="cpu", max_delta_fraction=0.05,
               max_tombstone_fraction=0.05)
    se.insert(px[:40], pls[:40])                    # 4%: below
    assert not se.compaction_log
    ids = se.insert(px[40:60], pls[40:60])          # 60 > 5%: folds first
    assert len(se.compaction_log) == 1 and se.stats().delta_rows == 20
    assert len(se.base.label_sets) == 1040
    assert [se.label_set(int(g)) for g in ids] == [tuple(s)
                                                   for s in pls[40:60]]
    se.delete(np.arange(40))                        # 40 < 5% of 1060
    assert len(se.compaction_log) == 1
    se.delete(np.arange(40, 80))                    # 80 > 5%: fires
    assert len(se.compaction_log) == 2
    assert len(se.base.label_sets) == 1040 + 20 - 80

    # an auto-compacting insert's ids, and deletes of them
    se = build(x[:400], ls[:400], device="cpu", max_delta_fraction=0.25,
               max_tombstone_fraction=None)
    se.delete(np.arange(10))
    ids = se.insert(px[:150], pls[:150])
    assert [se.label_set(int(g)) for g in ids] == [tuple(s)
                                                   for s in pls[:150]]
    before = se.stats().live_rows
    assert se.delete(ids[:5]) == 5 and se.stats().live_rows == before - 5
    assert se.delete(ids[:5]) == 0                  # idempotent
    with pytest.raises(ValueError):
        se.delete([se.sentinel])

    # delete then reinsert the same rows: fresh ids, the old stay dead
    se = build(x[:300], ls[:300], device="cpu", max_delta_fraction=None,
               max_tombstone_fraction=None)
    se.delete([5, 6])
    again = se.insert(x[5:7], ls[5:7])
    assert list(again) == [300, 301]
    _, i = se.search_batched(x[5:7], [()] * 2, 1)
    assert list(i[:, 0]) == [300, 301]
    id_map = se.flush()["id_map"]
    assert id_map[5] == id_map[6] == -1 and list(id_map[300:]) == [298, 299]

    # CapacityError leaves the stream as it was
    se = build(x[:300], ls[:300], device="cpu", max_delta_fraction=None,
               max_tombstone_fraction=None, min_delta_capacity=64,
               max_delta_capacity=64)
    se.insert(px[:40], pls[:40])
    snap = (se.delta, {name: b.clone() for name, b in
                       se.delta._buffers().items()}, se.sentinel,
            se.staged_state())
    want = se.search_batched(qv, qls, 4)
    with pytest.raises(pbase.CapacityError):
        se.ensure_insert_capacity(30)
    with pytest.raises(pbase.CapacityError):
        se.insert(px[40:70], pls[40:70])
    assert se.delta is snap[0] and se.sentinel == snap[2]
    for name, b in se.delta._buffers().items():
        assert torch.equal(b, snap[1][name])
    for key, value in se.staged_state().items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, snap[3][key])
        else:
            assert value == snap[3][key], key
    assert_bitwise(se.search_batched(qv, qls, 4), want, "after capacity")

    # an armed compaction fault leaves the stream searching as before
    from repro.core import faults as jax_faults
    assert "compact.mid_fold" in pcore.FAULT_POINTS
    assert pcore.FAULT_POINTS is not jax_faults.FAULT_POINTS
    se.delete([1, 2, 3])
    want = se.search_batched(qv, qls, 4)
    with pcore.inject(pcore.FaultPlan({"compact.mid_fold": 1})) as plan:
        with pytest.raises(pcore.InjectedFault):
            se.flush()
        assert jax_faults.active_plan() is None
    assert plan.fired == {"compact.mid_fold": 1}
    assert not se.compaction_log
    assert_bitwise(se.search_batched(qv, qls, 4), want, "after the fault")

    # a drift-triggered reselect piggybacks on a compaction
    mon = pcore.WorkloadMonitor()
    se = build(x[:1200], ls[:1200], device="cpu", max_delta_fraction=None,
               max_tombstone_fraction=None, monitor=mon, min_queries=50,
               drift_threshold=0.2, space_budget=2400)
    mon.snapshot()
    skew = [(0, 1)] * 8
    for _ in range(10):
        se.search_batched(qv[:8], skew, 4)
    assert mon.drift() > 0.2
    before = set(se.base.selection.selected)
    se.insert(px[:50], pls[:50])
    rep = se.flush()
    assert rep["reselected"] and mon.drift() < 0.05
    assert set(se.base.selection.selected) != before
    assert se.search_batched(qv[:8], skew, 4)[1].shape == (8, 4)
    se.insert(px[50:80], pls[50:80])
    assert se.flush()["reselected"] is False

    # warmup_serving: the buckets 1..16 and the delta tiers to 512 slots
    se = build(x[:1000], ls[:1000], device="cpu", max_delta_fraction=0.5,
               max_tombstone_fraction=None)
    out = se.warmup_serving([3], 1, 16)
    spans = len({pbase.pow2_bucket(n)
                 for _, n in se.base.segments.values()})
    assert out["programs"] == 5 * (1 + 2 * spans + 2) + 5 * 1
