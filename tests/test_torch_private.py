"""Port parity, the private-storage slice: the dense ``masked_distance`` and
``filtered_topk`` searches, the private-copy ``FlatIndex``, ``IVFIndex``
and the engine on the ``ivf`` backend, against the JAX package.

Tiers:
  * integer data (``rint(randn·4)``, small-integer IVF rows): every f32 sum
    is exact in any order, so positions, ids and values are bitwise — the
    kernels' plain versions against the Pallas kernels (interpret mode)
    and the ``"ref"`` oracles, ``FlatIndex`` against the JAX ``FlatIndex``,
    ``IVFIndex`` against the sequential-probe oracle and against the JAX
    ``IVFIndex`` carrying the same clusters;
  * random data (the 10k/500 fixture): the engine's ids equal the JAX
    engine's for k ∈ {1, 4, 17} (values allclose at rtol 1e-5: the two
    packages sum in different orders, ROADMAP C0);
  * within the port, batched ≡ looped bitwise — also on the 400-row
    configuration where the reference's matmul drifts with the Q-bucket
    (ROADMAP C1)."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

from repro.core import LabelHybridEngine as JaxEngine
from repro.core import (LabelWorkloadConfig, encode_many, generate_label_sets,
                        generate_query_label_sets, masks_to_int32_words)
from repro.index import FlatIndex as JaxFlat
from repro.index import IVFIndex as JaxIVF
from repro.kernels import ops as jops

# The port is imported by the ``_port`` fixture, not at collection (see
# test_torch_engine.py: loading torch slows the JAX tests of a worker).
torch = tops = tmd = tft = PortFlat = PortIVF = PortEngine = None
pack_tombstones = None

KS = (1, 4, 17)


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, tops, tmd, tft, PortFlat, PortIVF, PortEngine
    global pack_tombstones
    import torch
    from repro_torch.core import LabelHybridEngine as PortEngine
    from repro_torch.index import FlatIndex as PortFlat
    from repro_torch.index import IVFIndex as PortIVF
    from repro_torch.index.base import pack_tombstones
    from repro_torch.kernels import filtered_topk as tft
    from repro_torch.kernels import masked_distance as tmd
    from repro_torch.kernels import ops as tops
    # one intra-op thread: the suite runs in several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def dense_case(Q=6, N=300, D=8, W=4, seed=0):
    """Integer rows and queries; label words with the last query asking
    for a bit no row holds (an empty filter) and one query unfiltered."""
    rng = np.random.default_rng(seed)
    x = np.rint(rng.standard_normal((N, D)) * 4).astype(np.float32)
    q = np.rint(rng.standard_normal((Q, D)) * 4).astype(np.float32)
    lx = (rng.random((N, W)) < 0.6).astype(np.int32)
    lq = (rng.random((Q, W)) < 0.3).astype(np.int32)
    lq[0] = 0
    lq[-1, 0] = 1 << 5                     # no row holds bit 5
    tomb = rng.integers(0, 256, (-(-N // 8),)).astype(np.uint8)
    return q, x, lq, lx, tomb


def test_dense_plain_versions_match_pallas_and_oracles():
    """B4 and B3: the port's plain versions (``ops`` on ``"ref"``, and the
    kernel wrappers on CPU tensors) against JAX ``ops`` on ``"pallas"``
    (interpret) and ``"ref"``: l2 / ip, N = 300 (not a multiple of the
    Pallas row block), the empty filter, k > N and a tombstone bitmap."""
    q, x, lq, lx, tomb = dense_case()
    small = dense_case(Q=3, N=5, seed=1)
    for metric in ("l2", "ip"):
        want = np.asarray(jops.masked_distance(q, x, lq, lx, metric=metric,
                                               backend="pallas"))
        np.testing.assert_array_equal(
            want, np.asarray(jops.masked_distance(q, x, lq, lx,
                                                  metric=metric,
                                                  backend="ref")))
        assert np.isinf(want[-1]).all() and np.isfinite(want[0]).all()
        for backend in ("ref", "cuda"):
            got = tops.masked_distance(q, x, lq, lx, metric=metric,
                                       backend=backend, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)
        cases = [(q, x, lq, lx, k, None, "pallas") for k in (4, 17)]
        cases += [(q, x, lq, lx, 4, tomb, "pallas"),
                  (*small[:4], 17, None, "pallas"),       # k > N
                  (*small[:4], 17, small[4], "ref")]
        for qq, xx, lqq, lxx, k, tb, jb in cases:
            jv, ji = jops.filtered_topk(qq, xx, lqq, lxx, k=k, metric=metric,
                                        backend=jb, tomb=tb)
            rv, ri = jops.filtered_topk(qq, xx, lqq, lxx, k=k, metric=metric,
                                        backend="ref", tomb=tb)
            np.testing.assert_array_equal(np.asarray(ji), np.asarray(ri))
            for backend in ("ref", "cuda"):
                v, i = tops.filtered_topk(qq, xx, lqq, lxx, k=k,
                                          metric=metric, backend=backend,
                                          tomb=tb, device="cpu")
                tag = f"{metric} k={k} tomb={tb is not None} {backend}"
                np.testing.assert_array_equal(i.numpy(), np.asarray(ji),
                                              err_msg=tag)
                np.testing.assert_array_equal(v.numpy(), np.asarray(jv),
                                              err_msg=tag)
                assert i.dtype == torch.int32
    assert (tops.filtered_topk(*small[:4], k=17, device="cpu")[1][:, 5:]
            == 5).all()
    with pytest.raises(ValueError, match="kernel backend"):
        tops.masked_distance(q, x, lq, lx, backend="pallas", device="cpu")


def test_dense_plain_versions_do_not_depend_on_the_batch():
    """Random data: a query row's distances are bitwise the same at
    buckets 1, 8 and 64 and across the plain version's row chunks (the
    multiply + reduce form; ``q @ x.T`` drifts, ROADMAP C0), and the
    query-tiled plain top-k equals the untiled one."""
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((700, 32)).astype(np.float32))
    qs = t(rng.standard_normal((64, 32)).astype(np.float32))
    lx = t((rng.random((700, 4)) < 0.7).astype(np.int32))
    lq = t(np.zeros((64, 4), np.int32))
    for metric in ("l2", "ip"):
        full = tmd.masked_distance_plain(qs, x, lq, lx, metric=metric)
        for bucket in (1, 8):
            part = tmd.masked_distance_plain(qs[:bucket], x, lq[:bucket], lx,
                                             metric=metric)
            assert torch.equal(part, full[:bucket])
        old = tmd.PLAIN_CHUNK_ELEMS, tft.PLAIN_TILE_ELEMS
        try:
            tmd.PLAIN_CHUNK_ELEMS, tft.PLAIN_TILE_ELEMS = 4096, 1500
            assert torch.equal(tmd.masked_distance_plain(
                qs, x, lq, lx, metric=metric), full)
            tiled = tft.filtered_topk_plain(qs, x, lq, lx, k=10,
                                            metric=metric)
        finally:
            tmd.PLAIN_CHUNK_ELEMS, tft.PLAIN_TILE_ELEMS = old
        whole = tft.filtered_topk_plain(qs, x, lq, lx, k=10, metric=metric)
        assert all(torch.equal(a, b) for a, b in zip(tiled, whole))


def test_flat_index_matches_reference():
    """The private-copy FlatIndex against the JAX FlatIndex (``"ref"``,
    and ``"pallas"`` once): ``search``, ``search_padded`` on a padded
    bucket, a tombstone bitmap over local rows; ``nbytes`` equal."""
    q, x, lq, lx, tomb = dense_case(Q=7, N=130, D=16, seed=2)
    jflat = JaxFlat(x, lx)
    pflat = PortFlat(x, lx, device="cpu")
    assert pflat.kernel_backend == "ref" and pflat.nbytes == jflat.nbytes
    qp = np.zeros((8, 16), np.float32)
    qp[:7] = q
    lp = np.zeros((8, 4), np.int32)
    lp[:7] = lq
    for k in KS:
        for tb in (None, tomb):
            jd, ji = jflat.search(q, lq, k, tomb=tb)
            pd, pi = pflat.search(q, lq, k, tomb=tb)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pd, jd)
            bd, bi = pflat.search_padded(qp, lp, k, tomb=tb)
            np.testing.assert_array_equal(bi[:7].numpy(), pi)
            np.testing.assert_array_equal(bd[:7].numpy(), pd)
    assert sorted(pflat._bucket_fns) == [(k, 8) for k in KS]
    jd, ji = JaxFlat(x, lx, kernel_backend="pallas").search(q, lq, 4)
    pd, pi = PortFlat(x, lx, kernel_backend="cuda", device="cpu").search(
        q, lq, 4)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)


def ivf_case(N=300, D=8, Q=40):
    """The integer configuration of tests/test_search_padded_parity.py::
    test_ivf_padded_matches_sequential_probe_oracle."""
    rng = np.random.default_rng(31)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=8, seed=17))
    lx = masks_to_int32_words(encode_many(ls))
    qv = rng.integers(-3, 4, (Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 2, seed=18,
                                    from_base_fraction=0.7)
    qls += [tuple(range(9)), ()]      # impossible combo + unfiltered
    lq = masks_to_int32_words(encode_many(qls))
    dead = rng.random(N) < 0.3
    return x, lx, qv, lq, dead


def test_ivf_matches_sequential_probe_oracle():
    """The port's IVFIndex (its own clusters; kmeans_iters=0 makes the
    centroids data rows) against the JAX package's independent oracle,
    the sequential incremental probe loop, with and without deleted
    rows: bitwise."""
    from test_search_padded_parity import _ivf_reference

    x, lx, qv, lq, dead = ivf_case()
    for cfg in (dict(nprobe=3), dict(n_clusters=5, nprobe=2),
                dict(n_clusters=4, nprobe=4)):
        idx = PortIVF(x, lx, kmeans_iters=0, device="cpu", **cfg)
        for k in KS:
            for dd in (None, dead):
                tb = None if dd is None else pack_tombstones(dd)
                d_ref, i_ref = _ivf_reference(idx, qv, lq, k, dead=dd)
                d_got, i_got = idx.search(qv, lq, k, tomb=tb)
                tag = f"{cfg} k={k} dead={dd is not None}"
                np.testing.assert_array_equal(i_got, i_ref, err_msg=tag)
                np.testing.assert_array_equal(d_got, d_ref, err_msg=tag)


def test_ivf_from_reference_state_matches_jax():
    """A JAX IVFIndex's clusters (real k-means, jax.random init) carried
    into the port: ``search`` bitwise on integer data for l2 and ip, with
    and without tombstones; the host attributes and ``nbytes`` equal."""
    x, lx, qv, lq, dead = ivf_case()
    tb = pack_tombstones(dead)
    for metric in ("l2", "ip"):
        j = JaxIVF(x, lx, metric=metric, nprobe=2, kmeans_iters=3)
        p = PortIVF.from_reference_state(
            dict(centroids=j.centroids, vectors=j.vectors,
                 label_words=j.label_words, row_map=j.row_map,
                 offsets=j.offsets, nprobe=j.nprobe,
                 n_clusters=j.n_clusters), metric=metric, device="cpu")
        assert p.nbytes == j.nbytes and p.n_clusters == j.n_clusters
        np.testing.assert_array_equal(p.row_map, j.row_map)
        for k in KS:
            for tomb in (None, tb):
                jd, ji = j.search(qv, lq, k, tomb=tomb)
                pd, pi = p.search(qv, lq, k, tomb=tomb)
                np.testing.assert_array_equal(pi, ji)
                np.testing.assert_array_equal(pd, jd)


@pytest.fixture(scope="module")
def fixture_10k():
    """The 10k/500 acceptance fixture (tests/test_search_padded_parity.py)."""
    rng = np.random.default_rng(11)
    N, D, Q = 10_000, 32, 500
    x = rng.standard_normal((N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=10, seed=3))
    qv = rng.standard_normal((Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 4, seed=4,
                                    from_base_fraction=0.75)
    qls += [(0, 1, 2, 3, 4, 5), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 2, 4, 6, 8), ()]
    return dict(x=x, ls=ls, qv=qv, qls=qls)


def test_ivf_engine_matches_reference(fixture_10k):
    """The port's ivf engine built on the JAX ivf engine's selection and
    clusters (nprobe 4): ids equal to the JAX engine's for k ∈ {1, 4, 17}
    on random data (the measured tier is "equal": no boundary tie fell
    differently), values allclose; ``stats().nbytes`` equal."""
    qv, qls = fixture_10k["qv"], fixture_10k["qls"]
    je = JaxEngine.build(fixture_10k["x"], fixture_10k["ls"], mode="eis",
                         c=0.2, backend="ivf", nprobe=4)
    sel = je.selection
    state = dict(
        vectors=np.asarray(je.vectors), label_sets=je.label_sets,
        closure_sizes=dict(je.table.closure_sizes),
        selected=list(sel.selected.items()), assignment=dict(sel.assignment),
        cost=sel.cost, rounds=list(sel.rounds), c=sel.c, storage=je.storage,
        backend_params=dict(je.backend_params), metric=je.metric,
        backend="ivf",
        ivf_states={key: dict(centroids=ix.centroids, vectors=ix.vectors,
                              label_words=ix.label_words,
                              row_map=ix.row_map, offsets=ix.offsets,
                              nprobe=ix.nprobe, n_clusters=ix.n_clusters)
                    for key, ix in je.indexes.items()})
    pe = PortEngine.from_reference_state(state, device="cpu")
    assert pe.arena is None and pe._rows_concat_dev is None
    assert type(next(iter(pe.indexes.values()))) is PortIVF
    for k in KS:
        jd, ji = je.search_batched(qv, qls, k)
        pd, pi = pe.search_batched(qv, qls, k)
        np.testing.assert_array_equal(pi, ji, err_msg=f"k={k}")
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    js, ps = je.stats(), pe.stats()
    assert (ps.nbytes, ps.arena_nbytes, ps.segment_nbytes, ps.n_selected) \
        == (js.nbytes, js.arena_nbytes, js.segment_nbytes, js.n_selected)


def test_ivf_engine_batched_equals_looped(fixture_10k):
    """Within the port, with its own k-means: batched ≡ looped bitwise on
    the 10k fixture (k ∈ {1, 4, 17}, a min_bucket of 8, per-key
    tombstones) and on the 400-row configuration of
    tests/test_arena_engine.py::test_warmup_on_private_storage_backend,
    where the reference fails (ROADMAP C1)."""
    qv, qls = fixture_10k["qv"], fixture_10k["qls"]
    pe = PortEngine.build(fixture_10k["x"], fixture_10k["ls"], mode="eis",
                          c=0.2, backend="ivf", nprobe=4, device="cpu")
    for k in KS:
        bd, bi = pe.search_batched(qv, qls, k)
        ld, li = pe.search_looped(qv, qls, k)
        np.testing.assert_array_equal(bi, li, err_msg=f"k={k}")
        np.testing.assert_array_equal(bd, ld, err_msg=f"k={k}")
    rng = np.random.default_rng(7)
    tombs = {key: pack_tombstones(rng.random(ix.num_vectors) < 0.4)
             for key, ix in list(pe.indexes.items())[::2]}
    bd, bi = pe.search_batched(qv, qls, 4, min_bucket=8, tomb_by_key=tombs)
    ld, li = pe.search_looped(qv, qls, 4, tomb_by_key=tombs)
    np.testing.assert_array_equal(bi, li)
    np.testing.assert_array_equal(bd, ld)
    assert pe.supports_lazy_deletes
    assert all(ix._bucket_fns for ix in pe.indexes.values()
               if getattr(ix, "_bucket_fns", None) is not None)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    ls = generate_label_sets(400, LabelWorkloadConfig(num_labels=6, seed=2))
    eng = PortEngine.build(x, ls, mode="eis", c=0.2, backend="ivf",
                           nprobe=2, device="cpu")
    rep = eng.warmup([4], [8])
    assert rep["programs"] == len(eng.indexes)
    qv = rng.standard_normal((10, 16)).astype(np.float32)
    qls = generate_query_label_sets(ls, 10, seed=4)
    d, i = eng.search_batched(qv, qls, 4, min_bucket=8)
    dl, il = eng.search_looped(qv, qls, 4)
    np.testing.assert_array_equal(i, il)
    np.testing.assert_array_equal(d, dl)


def test_engine_backend_rules():
    """``distributed`` still raises (ROADMAP A10); a private backend takes
    only f32 storage; ``tomb_by_key`` belongs to the
    private-storage executor; an ivf engine keeps no arena."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    ls = generate_label_sets(200, LabelWorkloadConfig(num_labels=5, seed=1))
    with pytest.raises(NotImplementedError, match="A10"):
        PortEngine.build(x, ls, backend="distributed", device="cpu")
    with pytest.raises(ValueError, match="arena-native"):
        PortEngine.build(x, ls, backend="ivf", storage="int8", device="cpu")
    flat = PortEngine.build(x, ls, device="cpu")
    with pytest.raises(TypeError, match="tomb_by_key"):
        flat.search_batched(x[:2], [(), ()], 3, tomb_by_key={})
    ivf = PortEngine.build(x, ls, backend="ivf", nprobe=2, device="cpu")
    st = ivf.stats()
    assert ivf.arena is None and st.arena_nbytes == 0
    assert st.nbytes == sum(ix.nbytes for ix in ivf.indexes.values())
    assert all(ix.kernel_backend == "ref" for ix in ivf.indexes.values())
    # telemetry on a private backend: one query card per routed group,
    # results untouched
    from repro_torch.obs import metrics, trace
    qls = [(), (0,), (0, 1)]
    base = ivf.search_batched(x[:3], qls, 3)
    metrics.enable()
    trace.enable()
    try:
        trace.get_tracer().reset()
        on = ivf.search_batched(x[:3], qls, 3)
        cards = list(trace.get_tracer().cards)
    finally:
        metrics.disable()
        trace.disable()
    assert all(np.array_equal(a, b) for a, b in zip(on, base))
    assert sum(c.n_queries for c in cards) == 3
    assert all(c.span_tier is None and c.backend == "ivf" for c in cards)
