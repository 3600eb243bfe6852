"""Port parity, the graph slice: the per-hop ``gather_distance``, the Vamana
build, the filtered beam search of ``GraphIndex`` and the engine on the
``graph`` backend, against the JAX package.

Tiers:
  * ``gather_distance``: the plain version against the JAX Pallas kernel
    (interpret mode) and ``ref.gather_distance`` bitwise on integer data,
    allclose at rtol 1e-5 / atol 1e-4 on random data (the two packages sum
    in different orders, ROADMAP C0);
  * the build: adjacency and medoid bitwise on a fixture whose per-row
    candidate distances are distinct (the reference orders equal distances
    arbitrarily, ROADMAP C5); the card build's torch stages, run here on
    CPU tensors, bitwise against the plain stages;
  * the search on carried adjacency over integer data: dists, ids, hops and
    distance computations bitwise (the port's direct-form hop distances and
    the reference's norms form are exact there, ROADMAP C5);
  * random data (the 10k/500 fixture): recall within 0.01 of the JAX
    engine's and ≥ 95% of queries with identical ids (the rest are walks
    that a near-tie sent apart);
  * within the port, batched ≡ looped and sync cadence 1 ≡ 32, bitwise;
  * the walk kernel's contract on the CPU: each lane of the torch hop
    loop (its plain version) alone equals the same lane in a bucket of 8,
    bitwise, which is what a walk a lane on the card rests on; and the
    wrapper's raises, which hold without a card."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

import jax.numpy as jnp

from repro.core import LabelHybridEngine as JaxEngine
from repro.core import (LabelWorkloadConfig, brute_force_filtered,
                        encode_many, generate_label_sets,
                        generate_query_label_sets, masks_to_int32_words,
                        recall_at_k)
from repro.index import GraphIndex as JaxGraph
from repro.index import graph as jgraph
from repro.kernels import ops as jops
from repro.kernels import ref as jref

# The port is imported by the ``_port`` fixture, not at collection (see
# test_torch_engine.py: loading torch slows the JAX tests of a worker).
torch = tops = tref = tgd = tgw = pgraph = PortGraph = PortEngine = None
pack_tombstones = None

KS = (1, 4, 17)


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, tops, tref, tgd, tgw, pgraph, PortGraph, PortEngine
    global pack_tombstones
    import torch
    from repro_torch.core import LabelHybridEngine as PortEngine
    from repro_torch.index import graph as pgraph
    from repro_torch.index.base import pack_tombstones
    from repro_torch.index.graph import GraphIndex as PortGraph
    from repro_torch.kernels import gather_distance as tgd
    from repro_torch.kernels import graph_walk as tgw
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
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


def tie_free_points(n, D, n_cand, scale, seed):
    """Integer rows (exact f32 distances) whose nearest ``n_cand + 1``
    distances are distinct in every row: rows of a tied list are drawn
    again until none is left."""
    rng = np.random.default_rng(seed)
    x = np.rint(rng.standard_normal((n, D)) * scale)
    while True:
        sq = np.sum(x * x, axis=1)
        d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)    # f64: exact
        np.fill_diagonal(d, np.inf)
        near = np.sort(np.partition(d, n_cand, axis=1)[:, :n_cand + 1], 1)
        tied = np.flatnonzero((np.diff(near, axis=1) == 0).any(axis=1))
        if tied.size == 0:
            return x.astype(np.float32), near
        x[tied] = np.rint(rng.standard_normal((tied.size, D)) * scale)


def test_gather_distance_matches_pallas_and_oracles():
    """B5: the port's ``ops.gather_distance`` (``"ref"`` and ``"cuda"``
    on CPU tensors: the plain version) against the JAX ``ops`` on
    ``"pallas"`` (interpret mode, D padded to 128) and ``ref``; b ∈ {1,
    7, 64}, l2 and ip, ids < 0 -> +inf.  The batched form's rows are the
    Q = 1 calls' rows, bitwise."""
    rng = np.random.default_rng(0)
    for integer in (True, False):
        x = rng.standard_normal((90, 20)).astype(np.float32)
        qs = rng.standard_normal((3, 20)).astype(np.float32)
        if integer:
            x, qs = np.rint(x * 4), np.rint(qs * 4)
        for b in (1, 7, 64):
            ids = rng.integers(-3, 90, (3, b)).astype(np.int32)
            ids[0, 0] = -1
            for metric in ("l2", "ip"):
                rows = []
                for q, row_ids in zip(qs, ids):
                    want = np.asarray(jops.gather_distance(
                        jnp.asarray(q), jnp.asarray(x), jnp.asarray(row_ids),
                        metric=metric, backend="pallas"))
                    oracle = np.asarray(jref.gather_distance(
                        jnp.asarray(q), jnp.asarray(x),
                        jnp.asarray(row_ids), metric))
                    port_ref = tref.gather_distance(
                        torch.from_numpy(q), torch.from_numpy(x),
                        torch.from_numpy(row_ids), metric).numpy()
                    assert np.isinf(want[row_ids < 0]).all()
                    for backend in ("ref", "cuda"):
                        got = tops.gather_distance(
                            q, x, row_ids, metric=metric, backend=backend,
                            device="cpu").numpy()
                        for other in (want, oracle, port_ref):
                            if integer:
                                np.testing.assert_array_equal(got, other)
                            else:
                                np.testing.assert_allclose(
                                    got, other, rtol=1e-5, atol=1e-4)
                    rows.append(got)
                batched = tops.gather_distance_batched(
                    qs, x, ids, metric=metric, device="cpu").numpy()
                np.testing.assert_array_equal(batched, np.stack(rows))
    with pytest.raises(ValueError, match="metric"):
        tgd.gather_distance(torch.zeros(1, 4), torch.zeros(2, 4),
                            torch.zeros((1, 1), dtype=torch.int32),
                            metric="cos")


def test_plain_build_matches_reference_and_card_stages_match_plain():
    """The port's plain ``build_vamana`` against the JAX package's on a
    fixture whose per-row candidate distances are distinct (n 400, M 8,
    n_cand 16): adjacency and medoid bitwise; the card build's torch
    stages on CPU tensors — candidate lists through ``masked_distance``,
    the vectorised forward prune — equal the plain stages, the forward
    prune also on random data (its distances are numpy's pairwise sums);
    n = 1 and n_cand ≥ n; and without a card the default device raises."""
    x, near = tie_free_points(400, 16, 16, 50.0, seed=3)
    assert (np.diff(near, axis=1) > 0).all()
    jadj, jmed = jgraph.build_vamana(x, M=8, n_cand=16)
    padj, pmed = pgraph.build_vamana(x, M=8, n_cand=16, device="cpu")
    np.testing.assert_array_equal(padj, jadj)
    assert pmed == jmed
    assert ((padj >= 0).sum(1) <= 8).all()
    xd = torch.from_numpy(x)
    cands = pgraph._pairwise_block_topk(x, 16)
    np.testing.assert_array_equal(
        pgraph.candidate_lists(xd, 16, backend="ref").numpy(), cands)
    rng = np.random.default_rng(4)
    xr = rng.standard_normal((300, 24)).astype(np.float32)
    for xx in (x, xr):
        c = pgraph._pairwise_block_topk(xx, 16)
        fa, fd = pgraph._forward_plain(xx, c, 1.2, 8)
        ta, td = pgraph.forward_prune(torch.from_numpy(xx),
                                      torch.from_numpy(c.astype(np.int64)),
                                      1.2, 8)
        np.testing.assert_array_equal(ta.numpy(), fa)
        np.testing.assert_array_equal(td.numpy(), fd)
    for n in (1, 5):
        xs = np.rint(rng.standard_normal((n, 4)) * 4).astype(np.float32)
        ja, jm = jgraph.build_vamana(xs, M=3, n_cand=16)
        pa, pm = pgraph.build_vamana(xs, M=3, n_cand=16, device="cpu")
        np.testing.assert_array_equal(pa, ja)
        assert pm == jm
    # like every entry point of the port, the build runs on the card unless
    # the caller asks for the CPU: without a card the default raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pgraph.build_vamana(x, M=8, n_cand=16)


def integer_graph_case(N=500, D=10, Q=40, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=6, seed=2))
    qv = rng.integers(-3, 4, (Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 1, seed=5,
                                    from_base_fraction=0.75) + [()]
    lx = masks_to_int32_words(encode_many(ls))
    lq = masks_to_int32_words(encode_many(qls))
    return x, ls, lx, qv, qls, lq, rng.random(N) < 0.3


@pytest.fixture(scope="module")
def carried():
    """A JAX graph over integer rows and the port's index on its
    adjacency (the build is carried, not repeated)."""
    x, ls, lx, qv, qls, lq, dead = integer_graph_case()
    j = JaxGraph(x, lx, M=8, n_cand=16, ef_search=32)
    p = PortGraph.from_reference_state(
        x, lx, dict(adjacency=j.adjacency, medoid=j.medoid, M=8,
                    ef_search=32), device="cpu")
    return dict(j=j, p=p, x=x, lx=lx, qv=qv, lq=lq, dead=dead)


def test_beam_search_matches_reference_on_integer_data(carried):
    """Beam search on the carried adjacency: dists, ids, hops and
    distance computations bitwise against the JAX ``GraphIndex.search``
    for strategies post and pre, k ∈ {1, 4, 17}, with and without a
    tombstone bitmap, and with every entry point (the medoid) tombstoned;
    ``search_padded`` sliced equals ``search``; ``nbytes`` equal."""
    j, p, qv, lq = carried["j"], carried["p"], carried["qv"], carried["lq"]
    dead_medoid = np.zeros(len(carried["x"]), bool)
    dead_medoid[j.medoid] = True
    assert p.nbytes == j.nbytes and p.medoid == j.medoid
    for strategy in ("post", "pre"):
        for k in KS:
            for dead in (None, carried["dead"], dead_medoid):
                tomb = None if dead is None else pack_tombstones(dead)
                jd, ji = j.search(qv, lq, k, strategy=strategy, tomb=tomb)
                pd, pi = p.search(qv, lq, k, strategy=strategy, tomb=tomb)
                tag = f"{strategy} k={k} dead={dead is not None}"
                np.testing.assert_array_equal(pi, np.asarray(ji), err_msg=tag)
                np.testing.assert_array_equal(pd, np.asarray(jd), err_msg=tag)
                np.testing.assert_array_equal(p.last_stats.hops,
                                              j.last_stats.hops, err_msg=tag)
                np.testing.assert_array_equal(p.last_stats.dist_comps,
                                              j.last_stats.dist_comps,
                                              err_msg=tag)
                if dead is not None:
                    live = pi[pi < len(dead)]
                    assert live.size and not dead[live].any()
    qp = np.zeros((64, qv.shape[1]), np.float32)
    qp[:40] = qv
    lp = np.zeros((64, lq.shape[1]), np.int32)
    lp[:40] = lq
    bd, bi = p.search_padded(qp, lp, 4)
    sd, si = p.search(qv, lq, 4)
    np.testing.assert_array_equal(bi[:40].numpy(), si)
    np.testing.assert_array_equal(bd[:40].numpy(), sd)


def test_walk_lanes_alone_equal_lanes_in_a_bucket(carried):
    """The walk kernel runs each lane on its own; it equals the torch hop
    loop because a lane of the loop does not depend on its bucket.  On
    CPU tensors, a bucket of 8 lanes — three entries each, -1 among them,
    the last lane a pad (all -1) — through ``beam_search`` on ``"cuda"``
    (the wrapper, which runs the plain version here) and on ``"ref"``
    equals each lane searched alone on ``"ref"``: dists (every bit), ids,
    hops and distance computations.  The four cases run in one test, not
    as parameters: see ``test_torch_cuda.test_port_on_the_card``."""
    for case in (("post", "l2", False, "k"), ("pre", "l2", True, 16),
                 ("post", "ip", True, 16), ("pre", "ip", False, "k")):
        _walk_lanes_alone_equal_lanes_in_a_bucket(carried, *case)


def _walk_lanes_alone_equal_lanes_in_a_bucket(carried, strategy, metric,
                                              tombstones, ef):
    j, x, lx, qv, lq = (carried[key] for key in ("j", "x", "lx", "qv", "lq"))
    p = PortGraph.from_reference_state(
        x, lx, dict(adjacency=j.adjacency, medoid=j.medoid, M=8,
                    ef_search=32), metric=metric, device="cpu")
    k = 4
    ef = k if ef == "k" else ef
    rng = np.random.default_rng(12)
    ent = rng.integers(-len(x) // 2, len(x), (8, 3))
    ent[:, 0] = p.medoid
    ent[ent < 0] = -1
    ent[3, 1] = -1
    ent[-1] = -1
    tomb = pack_tombstones(carried["dead"]) if tombstones else None

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    q8, l8, e8 = (t(qv[:8], torch.float32), t(lq[:8], torch.int32),
                  t(ent, torch.int64))
    tb = None if tomb is None else t(tomb, torch.uint8)
    kw = dict(k=k, ef=ef, strategy=strategy)

    def bits(out):              # dists as their bits, ids, hops, dc
        return [out[0].view(torch.int32), *out[1:]]
    bucket = bits(pgraph.beam_search(p, q8, l8, e8, tb, backend="cuda",
                                     **kw))
    for got, want in zip(bits(pgraph.beam_search(p, q8, l8, e8, tb,
                                                 backend="ref", **kw)),
                         bucket):
        np.testing.assert_array_equal(got, want)
    for b in range(8):
        alone = bits(pgraph.beam_search(p, q8[b:b + 1], l8[b:b + 1],
                                        e8[b:b + 1], tb, backend="ref",
                                        **kw))
        for got, want in zip(alone, bucket):
            np.testing.assert_array_equal(
                got[0], want[b], err_msg=f"{strategy} {metric} {b}")
    assert int(bucket[2][-1]) == 0 and int(bucket[3][-1]) == 0
    assert (bucket[1][-1] == len(x)).all()
    assert int(bucket[2][:-1].min()) > 0


def test_walk_wrapper_raises_on_what_the_kernel_does_not_take():
    """``graph_walk`` checks its arguments on every device, so these raise
    without a card: wrong dtypes or layouts, ``ef`` above 1,024, ``M``
    above 32, more than 32 entries, k above ef, an unknown strategy or
    metric, and a planted fault asked of a CPU tensor (the faulty
    instances are the kernel's, behind their own entry)."""
    N, D, B = 40, 6, 3
    args = dict(q=torch.zeros((B, D)),
                lq=torch.zeros((B, 1), dtype=torch.int32),
                entries=torch.zeros((B, 1), dtype=torch.int64),
                x=torch.zeros((N, D)),
                adj=torch.full((N + 1, 4), N, dtype=torch.int64),
                lxw=torch.zeros((N + 1, 1), dtype=torch.int32))
    kw = dict(k=2, ef=8)
    out = tgw.graph_walk(*args.values(), **kw)
    assert [tuple(o.shape) for o in out] == [(B, 2), (B, 2), (B,), (B,)]
    bad = [dict(q=args["q"].double()), dict(lq=args["lq"].long()),
           dict(entries=args["entries"].int()),
           dict(adj=args["adj"].int()),
           dict(x=torch.zeros((D, N)).t()),
           dict(adj=torch.full((N + 1, 33), N, dtype=torch.int64)),
           dict(entries=torch.zeros((B, 33), dtype=torch.int64))]
    for change in bad:
        with pytest.raises(ValueError, match="graph_walk"):
            tgw.graph_walk(*{**args, **change}.values(), **kw)
    for change in (dict(ef=1025), dict(k=9), dict(k=0)):
        with pytest.raises(ValueError, match="graph_walk"):
            tgw.graph_walk(*args.values(), **{**kw, **change})
    with pytest.raises(ValueError, match="strategy"):
        tgw.graph_walk(*args.values(), **kw, strategy="mid")
    with pytest.raises(ValueError, match="metric"):
        tgw.graph_walk(*args.values(), **kw, metric="cos")
    with pytest.raises(ValueError, match="planted"):
        tgw.graph_walk_planted(*args.values(), **kw, fault=1)
    assert tgw.walk_smem_bytes(1024, 32, 1024, 32, True) < 160 * 1024
    assert tgw.walk_smem_bytes(128, 16, 64, 1, True) == 10_704


@pytest.fixture(scope="module")
def own_graph():
    """The port's own plain build over tests/test_index_backends.py's
    fixture (900 × 24 random rows, 8 labels, M 12)."""
    rng = np.random.default_rng(42)
    N, D, Q = 900, 24, 16
    x = rng.standard_normal((N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=8, seed=1))
    q = rng.standard_normal((Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q, seed=2)
    _, gt = brute_force_filtered(x, ls, q, qls, 10)
    return dict(ix=PortGraph(x, masks_to_int32_words(encode_many(ls)), M=12,
                             device="cpu"),
                q=q, lq=masks_to_int32_words(encode_many(qls)), gt=gt, N=N)


def test_search_within_the_port(own_graph):
    """Within the port: batched ≡ looped (one query at a time) and sync
    cadence 1 ≡ 32, bitwise; and the invariants of
    tests/test_index_backends.py — degree ≤ M, every result passes its
    filter, pre never beats post, hops monotone in k, a recall floor that
    ef does not lower."""
    ix, q, lq, gt, N = (own_graph[k] for k in ("ix", "q", "lq", "gt", "N"))
    assert ix.adjacency.shape == (N, 12)
    d, i = ix.search(q, lq, 10)
    hops = ix.last_stats.hops
    for r in range(0, len(q), 5):
        ld, li = ix.search(q[r:r + 1], lq[r:r + 1], 10)
        np.testing.assert_array_equal(li[0], i[r])
        np.testing.assert_array_equal(ld[0], d[r])
        assert ix.last_stats.hops[0] == hops[r]
    ix.sync_every = 1
    try:
        d1, i1 = ix.search(q, lq, 10, strategy="pre")
    finally:
        ix.sync_every = pgraph.SYNC_EVERY
    d32, i32 = ix.search(q, lq, 10, strategy="pre")
    np.testing.assert_array_equal(i1, i32)
    np.testing.assert_array_equal(d1, d32)
    lx64 = ix.label_words.astype(np.int64)
    for qi in range(len(q)):
        for v in i[qi][i[qi] < N]:
            assert np.all((lq[qi] & lx64[v]) == lq[qi])
    recalls = []
    for ef in (16, 64, 160):
        recalls.append(recall_at_k(ix.search(q, lq, 10, ef=ef)[1], gt, N))
    assert recalls[-1] >= recalls[0] - 1e-9 and recalls[-1] > 0.9
    r_pre = recall_at_k(i32, gt, N)
    r_post = recall_at_k(ix.search(q, lq, 10, ef=64)[1], gt, N)
    assert r_post >= r_pre - 0.02 and r_post > 0.8
    ix.search(q, lq, 1, ef=64)
    h1 = ix.last_stats.hops.mean()
    ix.search(q, lq, 10, ef=64)
    assert ix.last_stats.hops.mean() >= h1


def reference_state(je) -> dict:
    sel = je.selection
    return dict(
        vectors=np.asarray(je.vectors), label_sets=je.label_sets,
        closure_sizes=dict(je.table.closure_sizes),
        selected=list(sel.selected.items()), assignment=dict(sel.assignment),
        cost=sel.cost, rounds=list(sel.rounds), c=sel.c, storage=je.storage,
        backend_params=dict(je.backend_params), metric=je.metric,
        backend="graph",
        graph_states={key: dict(adjacency=ix.adjacency, medoid=ix.medoid,
                                M=ix.M, ef_search=ix.ef_search,
                                strategy=ix.strategy)
                      for key, ix in je.indexes.items()})


def test_graph_engine_matches_reference_on_integer_data():
    """The port engine on the JAX graph engine's selection and graphs
    (``from_reference_state``): ids and values equal to the JAX engine's
    for k ∈ {1, 4, 17} on integer rows; batched ≡ looped, also with
    per-key tombstones; ``stats`` equal.  ``min_bucket`` 64 puts every group on one bucket, so JAX
    traces one program per k."""
    x, ls, _, qv, qls, _, _ = integer_graph_case(N=600, D=12)
    je = JaxEngine.build(x, ls, mode="eis", c=0.2, backend="graph", M=8,
                         n_cand=16, ef_search=32)
    pe = PortEngine.from_reference_state(reference_state(je), device="cpu")
    assert pe.arena is None
    assert all(type(ix) is PortGraph for ix in pe.indexes.values())
    for k in KS:
        jd, ji = je.search_batched(qv, qls, k, min_bucket=64)
        pd, pi = pe.search_batched(qv, qls, k, min_bucket=64)
        np.testing.assert_array_equal(pi, ji, err_msg=f"k={k}")
        np.testing.assert_array_equal(pd, jd, err_msg=f"k={k}")
        ld, li = pe.search_looped(qv, qls, k)
        np.testing.assert_array_equal(li, pi, err_msg=f"k={k}")
        np.testing.assert_array_equal(ld, pd, err_msg=f"k={k}")
    rng = np.random.default_rng(7)
    tombs = {key: pack_tombstones(rng.random(ix.num_vectors) < 0.4)
             for key, ix in list(pe.indexes.items())[::2]}
    bd, bi = pe.search_batched(qv, qls, 4, min_bucket=8, tomb_by_key=tombs)
    ld, li = pe.search_looped(qv, qls, 4, tomb_by_key=tombs)
    np.testing.assert_array_equal(bi, li)
    np.testing.assert_array_equal(bd, ld)
    jd, ji = je.search_batched(qv, qls, 4, min_bucket=64, tomb_by_key=tombs)
    np.testing.assert_array_equal(bi, ji)
    assert pe.supports_lazy_deletes
    js, ps = je.stats(), pe.stats()
    assert (ps.nbytes, ps.n_selected) == (js.nbytes, js.n_selected)
    assert pe.warmup([4], [8])["programs"] == len(pe.indexes)


def test_graph_engine_on_the_10k_fixture():
    """The 10k/500 fixture (tests/test_search_padded_parity.py; M 8,
    n_cand 16, ef 32) with the JAX engine's graphs carried over: the
    port's recall@10 within 0.01 of the JAX engine's and ≥ 95% of the
    queries with identical ids (the rest are near-ties of the two
    distance forms, ROADMAP C5); within the port batched ≡ looped."""
    rng = np.random.default_rng(11)
    N, D, Q = 10_000, 32, 500
    x = rng.standard_normal((N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=10, seed=3))
    qv = rng.standard_normal((Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 4, seed=4,
                                    from_base_fraction=0.75)
    qls += [(0, 1, 2, 3, 4, 5), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 2, 4, 6, 8), ()]
    je = JaxEngine.build(x, ls, mode="eis", c=0.2, backend="graph", M=8,
                         n_cand=16, ef_search=32)
    pe = PortEngine.from_reference_state(reference_state(je), device="cpu")
    _, gt = brute_force_filtered(x, ls, qv, qls, 10)
    _, ji = je.search_batched(qv, qls, 10, min_bucket=256)
    pd, pi = pe.search_batched(qv, qls, 10)
    assert abs(recall_at_k(pi, gt, N) - recall_at_k(ji, gt, N)) <= 0.01
    assert (pi == ji).all(axis=1).mean() >= 0.95
    ld, li = pe.search_looped(qv, qls, 10)
    np.testing.assert_array_equal(li, pi)
    np.testing.assert_array_equal(ld, pd)
