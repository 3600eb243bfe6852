"""Port parity, the end-to-end engine on the 10k/500 acceptance fixture
(tests/test_search_padded_parity.py): the port engine built on the JAX
engine's state (``from_reference_state``) and the port engine built by
itself return the JAX engine's ids bitwise for k ∈ {1, 4, 17} (both on the
``"ref"`` kernel backend, f32 storage); within the port, batched ≡ looped
bitwise and fused ≡ unfused; ``stats()`` equals the JAX engine's."""
from __future__ import annotations

import dataclasses

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

from repro.core import LabelHybridEngine as JaxEngine
from repro.core import (LabelWorkloadConfig, brute_force_filtered,
                        generate_label_sets, generate_query_label_sets)

# The port is imported by the ``_port`` fixture, not at collection: every
# test worker imports every test module, and a process that has loaded
# torch runs the JAX tests ~17% slower (one JAX parity file timed with and
# without ``import torch`` first), so only workers that run this file
# load it.
torch = PortEngine = port_engine = port_metrics = port_trace = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, PortEngine, port_engine, port_metrics, port_trace
    import torch
    from repro_torch.core import LabelHybridEngine as PortEngine
    from repro_torch.core import engine as port_engine
    from repro_torch.obs import metrics as port_metrics
    from repro_torch.obs import trace as port_trace
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

KS = (1, 4, 17)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    N, D, Q = 10_000, 32, 500
    x = rng.standard_normal((N, D)).astype(np.float32)
    ls = generate_label_sets(N, LabelWorkloadConfig(num_labels=10, seed=3))
    qv = rng.standard_normal((Q, D)).astype(np.float32)
    qls = generate_query_label_sets(ls, Q - 4, seed=4,
                                    from_base_fraction=0.75)
    qls += [(0, 1, 2, 3, 4, 5), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 2, 4, 6, 8), ()]
    return dict(x=x, ls=ls, qv=qv, qls=qls, N=N)


def reference_state(eng) -> dict:
    """The JAX engine's state as plain numpy arrays, dicts and lists."""
    sel = eng.selection
    return dict(vectors=np.asarray(eng.vectors), label_sets=eng.label_sets,
                closure_sizes=dict(eng.table.closure_sizes),
                selected=list(sel.selected.items()),
                assignment=dict(sel.assignment), cost=sel.cost,
                rounds=list(sel.rounds), c=sel.c, storage=eng.storage,
                backend_params=dict(eng.backend_params),
                metric=eng.metric)


@pytest.fixture(scope="module")
def engines(data):
    je = JaxEngine.build(data["x"], data["ls"], mode="eis", c=0.2,
                         backend="flat")
    from_state = PortEngine.from_reference_state(reference_state(je),
                                                 device="cpu")
    built = PortEngine.build(data["x"], data["ls"], mode="eis", c=0.2,
                             backend="flat", device="cpu")
    return dict(jax=je, from_state=from_state, built=built, results={})


def search(engines, name, k, data):
    key = (name, k)
    if key not in engines["results"]:
        engines["results"][key] = engines[name].search_batched(
            data["qv"], data["qls"], k)
    return engines["results"][key]


def test_port_ids_are_the_reference_ids(engines, data):
    for k in KS:
        jd, ji = search(engines, "jax", k, data)
        for name in ("from_state", "built"):
            td, ti = search(engines, name, k, data)
            np.testing.assert_array_equal(ti, ji, err_msg=name)
            np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
            fin = np.isfinite(jd)
            np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
    # and the ids are exact: the brute force of both packages agrees
    eng = engines["built"]
    qv, qls = data["qv"][:60], data["qls"][:60]
    _, ids = eng.search_batched(qv, qls, 10)
    td, ti = port_engine.brute_force_filtered(data["x"], data["ls"], qv, qls,
                                              10, device="cpu")
    jd, ji = brute_force_filtered(data["x"], data["ls"], qv, qls, 10)
    np.testing.assert_array_equal(ti, ji)
    assert port_engine.recall_at_k(ids, ti, data["N"]) == 1.0
    # the selection, the CSR row table and stats() are the reference's
    je, tb = engines["jax"], engines["built"]
    assert list(tb.selection.selected.items()) == \
        list(je.selection.selected.items())
    assert tb.selection.assignment == je.selection.assignment
    assert tb.segments == je.segments
    np.testing.assert_array_equal(tb.rows_concat, je.rows_concat)
    np.testing.assert_array_equal(engines["from_state"].rows_concat,
                                  je.rows_concat)
    a = dataclasses.asdict(engines["built"].stats())
    b = dataclasses.asdict(engines["jax"].stats())
    for timing in ("select_seconds", "build_seconds"):
        a.pop(timing), b.pop(timing)
    assert a == b
    c = dataclasses.asdict(engines["from_state"].stats())
    c.pop("select_seconds"), c.pop("build_seconds")
    assert c == b


def test_batched_equals_looped_bitwise(engines, data):
    for k in KS:
        td, ti = search(engines, "built", k, data)
        ld, li = engines["built"].search_looped(data["qv"], data["qls"], k)
        np.testing.assert_array_equal(ti, li)
        np.testing.assert_array_equal(td, ld)


def test_fused_equals_unfused(engines, data):
    eng = engines["built"]
    fused = PortEngine(eng.vectors, eng.label_sets, eng.table,
                       eng.selection, None, "flat", "l2",
                       {"fused": True}, 0.0, device="cpu")
    for k in KS:
        td, ti = search(engines, "built", k, data)
        fd, fi = fused.search_batched(data["qv"], data["qls"], k, min_bucket=4)
        np.testing.assert_array_equal(fi, ti)
        np.testing.assert_array_equal(fd, td)   # the ref path: same arithmetic


def test_warmup_and_telemetry_leave_results_alone(engines, data):
    eng = engines["built"]
    out = eng.warmup_serving([4], min_bucket=2, max_batch=8)
    tiers = {1 << (length - 1).bit_length() if length else 1
             for _, length in eng.segments.values()}
    assert out["programs"] == 3 * len(tiers)
    qv, qls = data["qv"][:50], data["qls"][:50]
    base = eng.search_batched(qv, qls, 4)
    port_metrics.enable()
    port_trace.enable()
    try:
        port_trace.get_tracer().reset()
        on = eng.search_batched(qv, qls, 4)
        cards = list(port_trace.get_tracer().cards)
    finally:
        port_metrics.disable()
        port_trace.disable()
    for a, b in zip(on, base):
        np.testing.assert_array_equal(a, b)
    assert cards and not any(c.recompiled for c in cards)
    assert sum(c.n_queries for c in cards) == 50


def test_device_and_backend_rules(data, monkeypatch):
    x, ls = data["x"][:300], data["ls"][:300]
    with pytest.raises(NotImplementedError, match="A10"):
        PortEngine.build(x, ls, backend="distributed", device="cpu")
    eng = PortEngine.build(x, ls, device="cpu", storage="int8+rerank")
    assert eng._seg_backend == "ref" and eng._seg_fused is False
    assert eng.arena.device.type == "cpu"
    auto = PortEngine.build(x, ls, device="cpu", kernel_backend="cuda",
                            fused="auto")
    assert auto._seg_fused is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortEngine.build(x, ls)
