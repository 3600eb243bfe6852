"""Port parity, host selection layer: the port's label codec, GroupTable,
greedy EIS, SIS and the sampled estimator give exactly the JAX package's
results (keys, order, assignment, costs) on the paper's running example
and on seeded random workloads."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

import repro.core as J
from repro.data.pipeline import VectorLabelDataset as JD

# The port is imported by the ``_port`` fixture, not at collection: every
# test worker imports every test module, and a process that has loaded
# torch runs the JAX tests ~17% slower (one JAX parity file timed with and
# without ``import torch`` first), so only workers that run this file
# load it.
torch = T = TD = t_labels = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, T, TD, t_labels
    import torch
    import repro_torch.core as T
    from repro_torch.core import labels as t_labels
    from repro_torch.data import VectorLabelDataset as TD
    # one intra-op thread: the suite runs in several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def paper_label_sets():
    A, B, C = 0, 1, 2
    groups = {(): 3, (A,): 3, (B,): 1, (C,): 1, (A, B): 1, (A, C): 3,
              (B, C): 2, (A, B, C): 3}
    out = []
    for ls, cnt in groups.items():
        out.extend([ls] * cnt)
    return out


def random_workload(seed, n=1500, labels=10, dist="zipf"):
    ls = J.generate_label_sets(n, J.LabelWorkloadConfig(
        num_labels=labels, distribution=dist, seed=seed))
    qls = J.generate_query_label_sets(ls, 200, seed=seed + 1,
                                      from_base_fraction=0.75)
    return ls, qls


def assert_same_eis(a, b):
    assert list(a.selected.items()) == list(b.selected.items())
    assert a.assignment == b.assignment
    assert a.cost == b.cost and a.total_entries == b.total_entries
    assert a.rounds == b.rounds and a.c == b.c


def test_codec_dataset_and_estimator_match_reference():
    ls, qls = random_workload(5)
    for name in ("uniform", "poisson", "multinormal", "zipf"):
        cfg = dict(num_labels=12, distribution=name, seed=7)
        assert (T.generate_label_sets(500, T.LabelWorkloadConfig(**cfg))
                == J.generate_label_sets(500, J.LabelWorkloadConfig(**cfg)))
    assert (T.generate_query_label_sets(ls, 300, seed=9,
                                        from_base_fraction=0.6)
            == J.generate_query_label_sets(ls, 300, seed=9,
                                           from_base_fraction=0.6))
    np.testing.assert_array_equal(T.encode_many(ls), J.encode_many(ls))
    np.testing.assert_array_equal(
        T.masks_to_int32_words(T.encode_many(qls)),
        J.masks_to_int32_words(J.encode_many(qls)))
    assert t_labels.LABEL_WORDS == 4 == 2 * J.NUM_WORDS
    for kw in (dict(n=400, dim=8, seed=3),
               dict(n=300, dim=4, n_clusters=5, distribution="uniform")):
        (tv, tl), (jv, jl) = TD(**kw).generate(), JD(**kw).generate()
        np.testing.assert_array_equal(tv, jv)
        assert tl == jl
        (tq, tql), (jq, jql) = TD(**kw).queries(50), JD(**kw).queries(50)
        np.testing.assert_array_equal(tq, jq)
        assert tql == jql
    # the sampled closure-size estimator
    ls, _ = random_workload(3)
    a = T.sampled_group_table(ls, 500, seed=2)
    b = J.sampled_group_table(ls, 500, seed=2)
    assert a.closure_sizes == b.closure_sizes
    assert T.estimate_closure_size(ls, (0, 1), 400) == \
        J.estimate_closure_size(ls, (0, 1), 400)


def test_selection_matches_on_paper_example_and_random_workloads():
    for seed, dist in ((0, "zipf"), (1, "uniform"), (2, "multinormal")):
        ls, qls = random_workload(seed, dist=dist)
        qk_t, qk_j = T.observed_query_keys(qls), J.observed_query_keys(qls)
        assert qk_t == qk_j
        for qkeys in (None, qk_j):
            jt, tt = J.GroupTable.build(ls, qkeys), T.GroupTable.build(ls, qkeys)
            assert tt.closure_sizes == jt.closure_sizes
            assert list(tt.groups) == list(jt.groups)
            for c in (0.2, 0.5):
                a = T.greedy_eis(tt.closure_sizes, c, qkeys)
                b = J.greedy_eis(jt.closure_sizes, c, qkeys)
                assert_same_eis(a, b)
                for key in list(b.selected)[:20]:
                    np.testing.assert_array_equal(tt.closure_members(key),
                                                  jt.closure_members(key))
                assert T.min_elastic_factor(qk_j, tt.closure_sizes, a.selected) \
                    == J.min_elastic_factor(qk_j, jt.closure_sizes, b.selected)
        budget = len(ls) // 2
        a = T.sis(T.GroupTable.build(ls, qk_t).closure_sizes, budget, qk_t)
        b = J.sis(J.GroupTable.build(ls, qk_j).closure_sizes, budget, qk_j)
        assert a.c == b.c
        assert_same_eis(a.eis, b.eis)
    # the paper's running example
    ls = paper_label_sets()
    jt, tt = J.GroupTable.build(ls), T.GroupTable.build(ls)
    assert list(tt.closure_sizes.items()) == list(jt.closure_sizes.items())
    assert {k: v.tolist() for k, v in tt.groups.items()} == \
        {k: v.tolist() for k, v in jt.groups.items()}
    for key in jt.closure_sizes:
        np.testing.assert_array_equal(tt.closure_members(key),
                                      jt.closure_members(key))
    for c in (0.0, 0.3, 1.0):
        assert T.coverage_pairs(tt.closure_sizes, c) == \
            J.coverage_pairs(jt.closure_sizes, c)
        assert_same_eis(T.greedy_eis(tt.closure_sizes, c),
                        J.greedy_eis(jt.closure_sizes, c))
    closure = jt.closure_sizes
    for budget in (7, 100):
        a, b = T.sis(closure, budget), J.sis(closure, budget)
        assert a.c == b.c and a.probes == b.probes
        assert_same_eis(a.eis, b.eis)


def test_engine_build_modes_select_as_the_reference():
    ls, _ = random_workload(4, n=1200)
    x = np.random.default_rng(4).standard_normal((1200, 8)).astype(np.float32)
    for how in ("sis", "sampled"):
        kw = (dict(mode="sis", space_budget=600) if how == "sis"
              else dict(sample_size=400, c=0.3))
        je = J.LabelHybridEngine.build(x, ls, backend="flat", **kw)
        te = T.LabelHybridEngine.build(x, ls, backend="flat", device="cpu", **kw)
        assert_same_eis(te.selection, je.selection)
        np.testing.assert_array_equal(te.rows_concat, je.rows_concat)
        if how == "sis":
            assert te.sis_result.c == je.sis_result.c
