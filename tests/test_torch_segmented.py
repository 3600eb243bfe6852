"""Port parity, the segmented arena search: the port's
``ops.segmented_topk`` against the JAX package's, for both backends (port
``"ref"`` against JAX ``"ref"``; port ``"cuda"`` on CPU tensors — the
kernels' plain versions — against JAX ``"pallas"`` in interpret mode at
tiny size), all five storage specs, l2 and ip, with and without
tombstones, k > lmax and empty segments.

Tiers: on tie-heavy integer data (``rint(randn·4)``) positions and global
ids are bitwise for every spec, f32/fp16 values bitwise, int8 values
allclose at rtol 1e-5 (reduce order, DESIGN.md §3.9).  On random-normal
data the ids are held against a float64 numpy oracle up to boundary
ties."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

import jax.numpy as jnp

from repro.index.base import quantize_int8
from repro.kernels import ops as jops

# The port is imported by the ``_port`` fixture, not at collection: every
# test worker imports every test module, and a process that has loaded
# torch runs the JAX tests ~17% slower (one JAX parity file timed with and
# without ``import torch`` first), so only workers that run this file
# load it.
torch = tops = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, tops
    import torch
    from repro_torch.kernels import ops as tops
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


def make_case(spec, *, N=200, D=16, Q=16, W=4, lmax=32, seed=0,
              integer=True, tiled=False):
    """Raw segmented_topk operands (numpy).  ``tiled``: segments tile the
    row table (the only layout on which the JAX Pallas fused scan agrees
    with its oracle, ROADMAP C); else ragged segments anywhere, the last
    ending at the table's end.  Every third segment is empty."""
    rng = np.random.default_rng(seed)
    xf = (np.rint(rng.standard_normal((N, D)) * 4) if integer
          else rng.standard_normal((N, D))).astype(np.float32)
    q = (np.rint(rng.standard_normal((Q, D)) * 4) if integer
         else rng.standard_normal((Q, D))).astype(np.float32)
    alw = (rng.random((N, W)) < 0.7).astype(np.int32)
    lq = np.zeros((Q, W), np.int32)
    lq[:, 0] = rng.integers(0, 2, Q)
    R = Q * lmax if tiled else 2 * lmax + 7
    rows = rng.integers(0, N, R).astype(np.int32)
    starts = ((np.arange(Q) * lmax) if tiled
              else rng.integers(0, R - lmax // 2, Q)).astype(np.int32)
    lens = rng.integers(1, lmax + 1, Q).astype(np.int32)
    lens[::3] = 0
    if not tiled:
        starts[-1], lens[-1] = R - lmax // 2, lmax // 2
    lens = np.minimum(lens, R - starts).astype(np.int32)
    tomb = rng.integers(0, 256, (-(-N // 8),)).astype(np.uint8)
    dtype = spec.split("+")[0]
    kw = dict(dtype=dtype)
    if dtype == "f32":
        ax = xf
    elif dtype == "fp16":
        ax = xf.astype(np.float16)
    else:
        ax, scale, zero = quantize_int8(xf)
        kw.update(scales=scale, zeros=zero)
    xd = (ax.astype(np.float32) if dtype != "int8"
          else kw["zeros"][:, None] + kw["scales"][:, None]
          * ax.astype(np.float32))
    axn = np.sum(xd * xd, axis=1).astype(np.float32)
    if spec.endswith("+rerank"):
        kw.update(rerank=xf, rerank_norms=np.sum(xf * xf, axis=1)
                  .astype(np.float32), kprime=8)
    args = (q, lq, ax, alw, axn, rows, starts, lens)
    return args, tomb, kw, xd


def run_jax(args, tomb, kw, **call):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    out = jops.segmented_topk(*[jnp.asarray(a) for a in args],
                              tomb=None if tomb is None else jnp.asarray(tomb),
                              **jkw, **call)
    return [np.asarray(o) for o in out]


def run_port(args, tomb, kw, backend, **call):
    out = tops.segmented_topk(*args, tomb=tomb, backend=backend,
                              device="cpu", **kw, **call)
    return [o.numpy() for o in out]


def assert_tier(spec, got, want, tag):
    gv, gp, gg = got
    wv, wp, wg = want
    np.testing.assert_array_equal(gp, wp, err_msg=tag + " pos")
    np.testing.assert_array_equal(gg, wg, err_msg=tag + " gid")
    if spec.startswith("int8") and not spec.endswith("+rerank"):
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-4,
                                   err_msg=tag + " vals")
    else:
        np.testing.assert_array_equal(gv, wv, err_msg=tag + " vals")


# (metric, tombstones, fused, k): every axis takes each of its values in
# some row; k = 40 and 20 exceed the span tier (lmax 32 / 16)
REF_CONFIGS = (("l2", True, False, 4), ("ip", False, True, 40),
               ("l2", False, True, 40), ("ip", True, False, 4))
PALLAS_CONFIGS = (("l2", True, False, 4), ("ip", False, True, 4),
                  ("l2", False, False, 20))


def test_ref_backend_matches_jax_ref_and_follows_the_device(monkeypatch):
    for spec in SPECS:
        args, tomb, kw, _ = make_case(spec, seed=1)
        for metric, use_tomb, fused, k in REF_CONFIGS:
            tb = tomb if use_tomb else None
            call = dict(k=k, lmax=32, metric=metric, fused=fused, chunk=8)
            tag = f"{spec} {metric} k={k} tomb={use_tomb} fused={fused}"
            assert_tier(spec, run_port(args, tb, kw, "ref", **call),
                        run_jax(args, tb, kw, backend="ref", **call), tag)
    # chunk and fused tiling never change a bit
    args, tomb, kw, _ = make_case("int8+rerank", seed=4, integer=False)
    base = run_port(args, tomb, kw, "ref", k=6, lmax=32)
    for call in (dict(chunk=8), dict(chunk=32), dict(fused=True),
                 dict(fused=True, chunk=4, qtile=1)):
        out = run_port(args, tomb, kw, "ref", k=6, lmax=32, **call)
        for a, b in zip(out, base):
            np.testing.assert_array_equal(a, b, err_msg=str(call))
    # the defaults follow the device
    args, tomb, kw, _ = make_case("f32", seed=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.segmented_topk(*args, k=3, lmax=32)
    ref = tops.segmented_topk(*args, k=3, lmax=32, backend="ref",
                              device="cpu")
    default = tops.segmented_topk(*args, k=3, lmax=32, device="cpu")
    for a, b in zip(ref, default):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tops.segmented_topk(*args, k=3, lmax=32, backend="pallas",
                            device="cpu")
    assert tops.masked_topk_tail(torch.tensor([[2.0, 1.0, 1.0]]), None, 3,
                                 k=4)[1].tolist() == [[1, 2, 0, 3]]


def test_cuda_backend_plain_matches_jax_pallas():
    """Pallas interpret mode is slow: 4 queries, lmax 16."""
    for spec in SPECS:
        args, tomb, kw, _ = make_case(spec, Q=4, lmax=16, seed=2, tiled=True)
        for metric, use_tomb, fused, k in PALLAS_CONFIGS:
            tb = tomb if use_tomb else None
            call = dict(k=k, lmax=16, metric=metric, fused=fused, chunk=8,
                        qtile=2)
            tag = f"{spec} {metric} k={k} tomb={use_tomb} fused={fused}"
            assert_tier(spec, run_port(args, tb, kw, "cuda", **call),
                        run_jax(args, tb, kw, backend="pallas", **call), tag)


def test_random_data_ids_match_f64_oracle():
    for spec in SPECS:
        args, tomb, kw, xd = make_case(spec, seed=3, integer=False, Q=24)
        q, lq, _, alw, _, rows, starts, lens = args
        k, lmax = 5, 32
        rr = spec.endswith("+rerank")
        x64 = (kw["rerank"] if rr else xd).astype(np.float64)
        alive = ((tomb[np.arange(x64.shape[0]) >> 3]
                  >> (np.arange(x64.shape[0]) & 7)) & 1) == 0
        for backend in ("ref", "cuda"):
            for fused in (False, True):
                _, pos, gid = run_port(args, tomb, kw, backend, k=k, lmax=lmax,
                                       fused=fused)
                for qi in range(q.shape[0]):
                    seg = rows[starts[qi]:starts[qi] + lens[qi]]
                    keep = np.all((lq[qi] & alw[seg]) == lq[qi], axis=1) \
                        & alive[seg]
                    d64 = np.where(keep, np.sum(
                        (x64[seg] - q[qi].astype(np.float64)) ** 2, axis=1),
                        np.inf)
                    want_n = min(k, int(np.isfinite(d64).sum()))
                    got = pos[qi][pos[qi] < lmax]
                    assert got.size == want_n, (backend, fused, qi)
                    np.testing.assert_array_equal(gid[qi][:want_n], seg[got])
                    if want_n:
                        kth = np.sort(d64)[want_n - 1]
                        # every returned row is within boundary-tie distance
                        # of the exact k-th neighbour
                        assert np.all(d64[got] <= kth * (1 + 1e-5) + 1e-6)
