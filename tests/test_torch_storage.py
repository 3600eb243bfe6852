"""Port parity, storage layer: ``Arena.from_host`` holds the JAX arena's
bytes for every storage spec (codes, scales and zeros byte-equal; norms
bitwise on integer data and allclose on random data), ``tier_nbytes``
follows the reference's closed forms, and the storage helpers agree."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

from repro.index import base as J

# The port is imported by the ``_port`` fixture, not at collection: every
# test worker imports every test module, and a process that has loaded
# torch runs the JAX tests ~17% slower (one JAX parity file timed with and
# without ``import torch`` first), so only workers that run this file
# load it.
torch = T = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, T
    import torch
    from repro_torch.index import base as T
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

SPECS = ("f32", "fp16", "int8", "fp16+rerank", "int8+rerank")
_ITEM = {"f32": 4, "fp16": 2, "int8": 1}


def _data(integer, n=300, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = (np.rint(rng.standard_normal((n, d)) * 4) if integer
         else rng.standard_normal((n, d))).astype(np.float32)
    lw = rng.integers(0, 2**31 - 1, (n, 4)).astype(np.int32)
    return x, lw


def _np(t):
    return None if t is None else np.asarray(t.cpu().numpy()
                                             if hasattr(t, "cpu") else t)


def test_arena_bytes_match_reference():
    for spec in SPECS:
        for integer in (True, False):
            x, lw = _data(integer)
            ja = J.Arena.from_host(x, lw, storage=spec)
            ta = T.Arena.from_host(x, lw, storage=spec, device="cpu")
            assert ta.storage == ja.storage == spec and ta.dtype == ja.dtype
            for name in ("vectors", "label_words", "scales", "zeros", "rerank",
                         "tombstones"):
                a, b = _np(getattr(ta, name)), _np(getattr(ja, name))
                assert (a is None) == (b is None), name
                if a is not None:
                    assert a.dtype == b.dtype and a.shape == b.shape, name
                    assert a.tobytes() == b.tobytes(), name
            for name in ("norms", "rerank_norms"):
                a, b = _np(getattr(ta, name)), _np(getattr(ja, name))
                assert (a is None) == (b is None), name
                if a is None:
                    continue
                if integer and not (name == "norms" and ta.dtype == "int8"):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:   # f32 sums of non-integers in another order: allclose tier
                    np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            assert ta.tier_nbytes == ja.tier_nbytes
            assert ta.nbytes == ja.nbytes
    # tier_nbytes follows the closed forms
    for spec in SPECS:
        n, d, w = 123, 40, 4
        x, lw = _data(True, n=n, d=d)
        dtype, rerank = T.parse_storage(spec)
        want = dict(codes=n * d * _ITEM[dtype], labels=n * w * 4, norms=n * 4,
                    scales=2 * n * 4 if dtype == "int8" else 0,
                    rerank=n * (d + 1) * 4 if rerank else 0,
                    tombstone=-(-n // 8))
        assert T.Arena.from_host(x, lw, storage=spec,
                                 device="cpu").tier_nbytes == want


def test_storage_helpers_tombstones_and_device_rules(monkeypatch):
    x, _ = _data(False, n=50)
    x[3] = 1.5      # a zero-range row: scale 1, codes 0
    for a, b in zip(T.quantize_int8(x), J.quantize_int8(x)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    codes, scale, zero = T.quantize_int8(x)
    assert T.dequantize_int8(codes, scale, zero).tobytes() == \
        J.dequantize_int8(codes, scale, zero).tobytes()
    dead = np.random.default_rng(1).random(77) < 0.3
    for n_rows in (None, 77, 200):
        np.testing.assert_array_equal(T.pack_tombstones(dead, n_rows),
                                      J.pack_tombstones(dead, n_rows))
        m = n_rows or 77
        assert T.tombstone_bytes(m) == J.tombstone_bytes(m)
    for spec in SPECS:
        assert T.parse_storage(spec) == J.parse_storage(spec)
    for bad in ("f32+rerank", "int4", "int8+foo", "fp16rerank"):
        with pytest.raises(ValueError):
            T.parse_storage(bad)
    for g, mb in [(1, 1), (5, 1), (5, 8), (64, 1), (65, 4)]:
        assert T.pow2_bucket(g, mb) == J.pow2_bucket(g, mb)
    assert T.serving_buckets(2, 100) == J.serving_buckets(2, 100)
    assert T.as_row_ids(np.arange(5), 9).dtype == np.int32
    with pytest.raises(ValueError):
        T.as_row_ids(np.array([0, 9]), 9)
    with pytest.raises(OverflowError):
        T.check_global_id_contract(2**31)
    # tombstones, and the entry point's device rule
    x, lw = _data(True, n=20)
    a = T.Arena.from_host(x, lw, storage="int8", device="cpu")
    dead = np.zeros(20, bool)
    dead[[1, 9]] = True
    b = a.with_tombstones(dead)
    assert b.version == a.version + 1 and b.vectors is a.vectors
    np.testing.assert_array_equal(b.tombstones.numpy(),
                                  T.pack_tombstones(dead, 20))
    x, lw = _data(True, n=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Arena.from_host(x, lw)
    assert T.Arena.from_host(x, lw, device="cpu").device.type == "cpu"
