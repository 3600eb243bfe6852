"""Port parity, kernels: the plain versions of the port's two CUDA kernels
against the JAX package's Pallas kernels run in interpret mode (tiny
shapes: k=4, chunk=8, qtile=2) and against its oracles; the tail-segment
case where the Pallas fused scan departs from its oracle; the wrappers'
CPU routing; and the Hopper tile model.

Parity tiers: on integer data (``rint(randn·4)``) every f32 sum is exact,
so positions and values are bitwise, int8 values allclose (its dequantized
rows are not integers)."""
from __future__ import annotations

import types

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

import jax
import jax.numpy as jnp

from repro.index.base import quantize_int8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_scan import _lax_fused_scan, _pallas_fused_scan
from repro.kernels.gather_distance import segmented_gather_distance_pallas

# The port is imported by the ``_port`` fixture, not at collection: every
# test worker imports every test module, and a process that has loaded
# torch runs the JAX tests ~17% slower (one JAX parity file timed with and
# without ``import torch`` first), so only workers that run this file
# load it.
torch = tfs = tgd = tops = tref = roofline = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, tfs, tgd, tops, tref, roofline
    import torch
    from repro_torch.kernels import fused_scan as tfs
    from repro_torch.kernels import gather_distance as tgd
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    from repro_torch.launch import roofline
    # release the JAX programs compiled in this worker before this
    # module (and, at the end, by it): each holds memory maps, and
    # a worker that reaches vm.max_map_count segfaults in its next
    # XLA compile (ROADMAP C1)
    jax.clear_caches()
    # one intra-op thread: the suite runs in several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()

DTYPES = ("f32", "fp16", "int8")


def make_arena(dtype, *, N=60, D=16, W=4, seed=0, integer=True):
    rng = np.random.default_rng(seed)
    xf = (np.rint(rng.standard_normal((N, D)) * 4) if integer
          else rng.standard_normal((N, D))).astype(np.float32)
    alw = (rng.random((N, W)) < 0.6).astype(np.int32)
    scales = zeros = None
    if dtype == "f32":
        ax = xf
    elif dtype == "fp16":
        ax = xf.astype(np.float16)
    else:
        ax, scales, zeros = quantize_int8(xf)
    xd = (ax.astype(np.float32) if dtype != "int8"
          else zeros[:, None] + scales[:, None] * ax.astype(np.float32))
    axn = np.sum(xd * xd, axis=1).astype(np.float32)
    tomb = rng.integers(0, 256, (-(-N // 8),)).astype(np.uint8)
    return dict(ax=ax, alw=alw, axn=axn, scales=scales, zeros=zeros,
                tomb=tomb, xf=xf)


def queries(Q, D, W, seed, integer=True):
    rng = np.random.default_rng(seed + 100)
    q = (np.rint(rng.standard_normal((Q, D)) * 4) if integer
         else rng.standard_normal((Q, D))).astype(np.float32)
    lq = np.zeros((Q, W), np.int32)
    lq[:, 0] = rng.integers(0, 2, Q)
    return q, lq


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def check_vals(dtype, a, b):
    a, b = np.asarray(a), np.asarray(b)
    if dtype == "int8":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# segmented gather distance
# ---------------------------------------------------------------------------

def test_gather_plain_matches_pallas_interpret():
    Q, L, D, W = 3, 8, 16, 4
    for dtype in DTYPES:
        A = make_arena(dtype, seed=1)
        q, lq = queries(Q, D, W, 1)
        rng = np.random.default_rng(2)
        gids = rng.integers(0, 60, (Q, L)).astype(np.int32)
        lens = np.array([0, 5, L], np.int32)
        kw = {}
        if dtype == "int8":
            kw = dict(scales=A["scales"], zeros=A["zeros"])
        for metric in ("l2", "ip"):
            want = segmented_gather_distance_pallas(
                j(q), j(lq), j(A["ax"]), j(A["alw"]), j(gids), j(lens),
                metric=metric, interpret=True,
                **{k: j(v) for k, v in kw.items()})
            got = tgd.segmented_gather_distance_plain(
                t(q), t(lq), t(A["ax"]), t(A["alw"]), t(gids), t(lens),
                metric=metric, **{k: t(v) for k, v in kw.items()})
            np.testing.assert_array_equal(np.isinf(got.numpy()),
                                          np.isinf(np.asarray(want)))
            check_vals(dtype, got.numpy(), want)
            # the wrapper takes the plain version on CPU tensors, and
            # launches nothing
            before = tgd.segmented_gather_distance.launches
            wrapped = tgd.segmented_gather_distance(
                t(q), t(lq), t(A["ax"]), t(A["alw"]), t(gids), t(lens),
                metric=metric, **{k: t(v) for k, v in kw.items()})
            assert torch.equal(wrapped, got)
            assert tgd.segmented_gather_distance.launches == before
    # random data: allclose
    A = make_arena("f32", seed=3, integer=False)
    q, lq = queries(4, 16, 4, 3, integer=False)
    gids = np.random.default_rng(4).integers(0, 60, (4, 8)).astype(np.int32)
    lens = np.array([8, 8, 3, 8], np.int32)
    want = np.asarray(segmented_gather_distance_pallas(
        j(q), j(lq), j(A["ax"]), j(A["alw"]), j(gids), j(lens),
        metric="l2", interpret=True))
    got = tgd.segmented_gather_distance_plain(
        t(q), t(lq), t(A["ax"]), t(A["alw"]), t(gids), t(lens)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


# ---------------------------------------------------------------------------
# fused scan
# ---------------------------------------------------------------------------

def fused_operands(dtype, *, Q, lmax, tiled, seed, tomb=True, integer=True):
    """``tiled``: segments tile the row table exactly (no chunk window of
    the Pallas kernel ever reaches past its end); else ragged segments
    anywhere in it, the last one ending at the table's end."""
    A = make_arena(dtype, seed=seed, integer=integer)
    D, W = A["ax"].shape[1], A["alw"].shape[1]
    q, lq = queries(Q, D, W, seed, integer=integer)
    rng = np.random.default_rng(seed + 7)
    if tiled:
        R = Q * lmax
        starts = (np.arange(Q) * lmax).astype(np.int32)
    else:
        R = 3 * lmax
        starts = rng.integers(0, R, Q).astype(np.int32)
        starts[-1] = R - lmax // 2 - 1
    rows = rng.integers(0, A["ax"].shape[0], R).astype(np.int32)
    lens = rng.integers(0, lmax + 1, Q).astype(np.int32)
    lens[-1] = lmax // 2 + 1
    return dict(q=q, lq=lq, ax=A["ax"], alw=A["alw"], axn=A["axn"],
                rows_concat=rows, starts=starts, lens=lens,
                tomb=A["tomb"] if tomb else None, scales=A["scales"],
                zeros=A["zeros"])


ORDER = ("q", "lq", "ax", "alw", "axn", "rows_concat", "starts", "lens",
         "tomb", "scales", "zeros")


def run_port(ops_, **kw):
    return tfs.fused_scan_plain(*[t(ops_[n]) for n in ORDER], **kw)


def test_fused_plain_matches_pallas_interpret():
    for dtype, metric in (("f32", "l2"), ("f32", "ip"), ("fp16", "l2"),
                          ("int8", "ip")):
        o = fused_operands(dtype, Q=4, lmax=16, tiled=True, seed=5)
        kw = dict(kp=4, lmax=16, chunk=8, qtile=2, metric=metric,
                  dtype=dtype)
        wv, wp = _pallas_fused_scan(*[j(o[n]) for n in ORDER], dcols=None,
                                    interpret=True, **kw)
        gv, gp = run_port(o, **kw)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        check_vals(dtype, gv.numpy(), wv)


def test_fused_plain_matches_oracles_and_wrapper_routes():
    for dtype in DTYPES:
        o = fused_operands(dtype, Q=8, lmax=32, tiled=False, seed=6)
        for kp in (4, 40):     # 40 > lmax: the k' > span case
            kw = dict(kp=kp, lmax=32, chunk=8, metric="l2", dtype=dtype)
            lv, lp = _lax_fused_scan(*[j(o[n]) for n in ORDER], qtile=2,
                                     **kw)
            gv, gp = run_port(o, qtile=2, **kw)
            np.testing.assert_array_equal(gp.numpy(), np.asarray(lp))
            check_vals(dtype, gv.numpy(), lv)
            if kp <= 32:
                ov, op = jref.segmented_filtered_topk(
                    *[j(o[n]) for n in ORDER[:8]], k=kp, lmax=32,
                    metric="l2", tomb=j(o["tomb"]), dtype=dtype,
                    scales=j(o["scales"]), zeros=j(o["zeros"]))
                np.testing.assert_array_equal(gp.numpy(), np.asarray(op))
            # the tiling never changes a bit
            for chunk, qtile in ((32, 8), (16, 1)):
                v2, p2 = run_port(o, kp=kp, lmax=32, chunk=chunk,
                                  qtile=qtile, metric="l2", dtype=dtype)
                assert torch.equal(p2, gp) and torch.equal(v2, gv)
    # the wrapper routes CPU tensors to the plain version; the options
    o = fused_operands("f32", Q=4, lmax=16, tiled=False, seed=8)
    kw = dict(kp=5, lmax=16, chunk=8, qtile=2, metric="l2", dtype="f32")
    before = tfs.fused_segmented_scan.launches
    for backend in ("ref", "cuda"):
        v, p = tfs.fused_segmented_scan(*[t(o[n]) for n in ORDER],
                                        backend=backend, **kw)
        pv, pp = run_port(o, **kw)
        assert torch.equal(v, pv) and torch.equal(p, pp)
    assert tfs.fused_segmented_scan.launches == before
    with pytest.raises(ValueError):
        tfs.fused_segmented_scan(*[t(o[n]) for n in ORDER], backend="ref",
                                 **dict(kw, chunk=5))
    assert tfs.resolve_fused("auto", backend="cuda") is True
    assert tfs.resolve_fused("auto", backend="ref") is False
    assert tfs.resolve_fused(True, backend="ref") is True
    assert tfs.resolve_fused(False, backend="cuda") is False
    with pytest.raises(ValueError):
        tfs.resolve_fused("yes", backend="ref")
    assert [tfs.clamp_qtile(a, b) for a, b in
            ((8, 24), (16, 24), (4, 6), (3, 7))] == [8, 8, 2, 1]


def test_fused_tail_segment_follows_the_oracle():
    """N = R = 40, chunk 8, lmax 32, k' 4, one segment (start 30, len 10)
    ending at the table's end.  The Pallas kernel clamps the second chunk's
    id window to rows 32..39 and labels them positions 8, 9: the nearest
    row (position 8, row 38) is lost.  The oracles and the port agree on
    [8, 1, 6, 4]."""
    N, D, W = 40, 8, 4
    x = np.full((N, D), 0.0, np.float32)
    order = [38, 31, 36, 34, 32] + [r for r in range(N)
                                    if r not in (38, 31, 36, 34, 32)]
    for rank, row in enumerate(order):
        x[row, 0] = rank + 1.0
    o = dict(q=np.zeros((2, D), np.float32), lq=np.zeros((2, W), np.int32),
             ax=x, alw=np.zeros((N, W), np.int32),
             axn=np.sum(x * x, axis=1).astype(np.float32),
             rows_concat=np.arange(N, dtype=np.int32),
             starts=np.array([0, 30], np.int32),
             lens=np.array([4, 10], np.int32), tomb=None, scales=None,
             zeros=None)
    kw = dict(kp=4, lmax=32, chunk=8, qtile=2, metric="l2", dtype="f32")
    _, pp = _pallas_fused_scan(*[j(o[n]) for n in ORDER], dcols=None,
                               interpret=True, **kw)
    _, lp = _lax_fused_scan(*[j(o[n]) for n in ORDER], **kw)
    _, op = jref.segmented_filtered_topk(*[j(o[n]) for n in ORDER[:8]],
                                         k=4, lmax=32)
    _, gp = run_port(o, **kw)
    assert np.asarray(pp)[1].tolist() == [1, 6, 4, 2]   # reference fault
    assert np.asarray(lp)[1].tolist() == [8, 1, 6, 4]
    assert np.asarray(op)[1].tolist() == [8, 1, 6, 4]
    assert gp[1].tolist() == [8, 1, 6, 4]


# ---------------------------------------------------------------------------
# tile model
# ---------------------------------------------------------------------------

H100 = types.SimpleNamespace(
    name="NVIDIA H100 80GB HBM3", multi_processor_count=132,
    max_threads_per_multi_processor=2048, shared_memory_per_block=49152,
    shared_memory_per_block_optin=232448,
    shared_memory_per_multiprocessor=233472)


def test_tile_model_is_deterministic_and_fills_the_card():
    for d in (16, 128, 768):
        for lmax in (1, 64, 1024, 2**20):
            for dtype in DTYPES:
                for q_bucket in (1, 8, 64, 1024):
                    for kw in (dict(backend="ref"),
                               dict(backend="cuda", props=H100)):
                        a = roofline.fused_scan_tiles(d, lmax, dtype,
                                                      q_bucket, **kw)
                        assert a == roofline.fused_scan_tiles(
                            d, lmax, dtype, q_bucket, **kw)
                        assert lmax % a.rows_per_chunk == 0
                        assert a.rows_per_chunk & (a.rows_per_chunk - 1) == 0
                        assert 1 <= a.queries_per_tile <= q_bucket
                        assert a.bytes_per_row > 0 and a.intensity > 0
    small = roofline.fused_scan_tiles(128, 2**20, "f32", 4, backend="cuda",
                                      props=H100)
    big = roofline.fused_scan_tiles(128, 2**20, "f32", 256, backend="cuda",
                                    props=H100)
    one = roofline.fused_scan_tiles(128, 2**20, "f32", 256, backend="cuda",
                                    props=H100, max_qtile=1)
    # few queries over a huge span: one query per block, split finely;
    # the top tier (256 queries): the largest query tile, coarser splits
    assert small.queries_per_tile == one.queries_per_tile == 1
    assert big.queries_per_tile == tfs.TILE_QUERIES
    assert small.rows_per_chunk == roofline.MIN_ROWS_PER_BLOCK
    assert big.rows_per_chunk > small.rows_per_chunk
    assert big.rows_per_chunk >= roofline.MIN_ROWS_PER_TILE
    # the chosen blocks fill WAVES waves at the blocks an SM holds: the
    # tile kernel's launch bound, the one-query kernel's threads
    tiles = 256 // big.queries_per_tile * (2**20 // big.rows_per_chunk)
    assert tiles >= roofline.WAVES * 132 * tfs.TILE_BLOCKS_PER_SM
    assert 256 * (2**20 // one.rows_per_chunk) >= roofline.WAVES * 132 * 8
    # a tile is taken only where it leaves as many blocks as one query per
    # block needs (short spans keep one query per block), and its block
    # fits the opt-in shared memory
    assert roofline.fused_scan_tiles(128, 1024, "f32", 256, backend="cuda",
                                     props=H100).queries_per_tile == 1
    mid = roofline.fused_scan_tiles(128, 2**18, "f32", 128, backend="cuda",
                                    props=H100)
    assert 1 < mid.queries_per_tile < tfs.TILE_QUERIES
    assert (128 // mid.queries_per_tile
            * (2**18 // roofline.MIN_ROWS_PER_TILE)
            >= roofline.WAVES * 132 * 8)
    for d, kp in ((128, 10), (128, 64), (768, 40)):
        assert tfs.block_smem_bytes(d, kp, 64) > 48 * 1024
        assert tfs.block_smem_bytes(d, kp, 64) \
            <= H100.shared_memory_per_block_optin
        assert tfs.block_smem_bytes(d, kp) <= tfs.block_smem_bytes(d, kp, 64)
    narrow = types.SimpleNamespace(**dict(
        vars(H100), shared_memory_per_block_optin=48 * 1024))
    assert roofline.fused_scan_tiles(128, 2**20, "f32", 256, backend="cuda",
                                     props=narrow).queries_per_tile == 1
    tiny = types.SimpleNamespace(**dict(vars(H100),
                                        shared_memory_per_block_optin=1024))
    with pytest.raises(ValueError):
        roofline.fused_scan_tiles(128, 1024, "f32", 4, backend="cuda",
                                  props=tiny)
    assert roofline.scan_bytes_per_row(128, "f32") == 4 * 128 + 16 + 8
    assert roofline.scan_bytes_per_row(128, "int8") == 128 + 16 + 8 + 8


# ---------------------------------------------------------------------------
# the plain oracles of kernels/ref.py
# ---------------------------------------------------------------------------

def test_ref_oracles_and_stable_topk_match_reference():
    for metric in ("l2", "ip"):
        A = make_arena("f32", N=50, seed=9)
        q, lq = queries(7, 16, 4, 9)
        args_t = (t(q), t(A["ax"]), t(lq), t(A["alw"]))
        args_j = (j(q), j(A["ax"]), j(lq), j(A["alw"]))
        np.testing.assert_array_equal(
            tref.distances(t(q), t(A["ax"]), metric).numpy(),
            np.asarray(jref.distances(j(q), j(A["ax"]), metric)))
        np.testing.assert_array_equal(
            tref.containment_mask(t(lq), t(A["alw"])).numpy(),
            np.asarray(jref.containment_mask(j(lq), j(A["alw"]))))
        np.testing.assert_array_equal(
            tref.masked_distance(t(q), t(A["ax"]), t(lq), t(A["alw"]),
                                 metric).numpy(),
            np.asarray(jref.masked_distance(j(q), j(A["ax"]), j(lq),
                                            j(A["alw"]), metric)))
        for k, tomb in ((5, None), (5, A["tomb"]), (60, A["tomb"])):
            tv, ti = tref.filtered_topk(*args_t, k, metric, tomb=t(tomb))
            jv, ji = jref.filtered_topk(*args_j, k, metric, tomb=j(tomb))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        gid = torch.arange(50, dtype=torch.int32)
        np.testing.assert_array_equal(
            tref.tombstone_mask(t(A["tomb"]), gid).numpy(),
            np.asarray(jref.tombstone_mask(j(A["tomb"]), j(gid.numpy()))))
        B = make_arena("int8", N=50, seed=9, integer=False)
        np.testing.assert_array_equal(
            tref.np_quantized_distances(q, B["ax"], B["scales"],
                                        B["zeros"], lq, B["alw"], metric),
            jref.np_quantized_distances(q, B["ax"], B["scales"],
                                        B["zeros"], lq, B["alw"], metric))
        xg = t(B["ax"][:6])
        np.testing.assert_array_equal(
            tref.dequantize_rows(xg, "int8", t(B["scales"][:6]),
                                 t(B["zeros"][:6])).numpy(),
            np.asarray(jref.dequantize_rows(j(B["ax"][:6]), "int8",
                                            j(B["scales"][:6]),
                                            j(B["zeros"][:6]))))
    # every top-k ranks as lax.top_k does, ties by index
    d = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, float("inf"), 0.0, -0.0]])
    v, i = tref.lex_topk(d, 7)
    # total order: -0.0 before +0.0, as lax.top_k(-d) ranks them
    assert i.tolist() == [[7, 3, 6, 1, 2, 4, 0]]
    assert torch.signbit(v[0, 0]) and not torch.signbit(v[0, 1])
    jv, ji = jax.lax.top_k(-jnp.asarray(d.numpy()), 7)
    assert np.asarray(ji).tolist() == i.tolist()
    assert np.array_equal(np.signbit(-np.asarray(jv)), torch.signbit(v))
    # masked_topk_tail: the unfused path's stable top-k over [Q, L]
    rng = np.random.default_rng(12)
    d = np.rint(rng.standard_normal((5, 30)) * 2).astype(np.float32)
    d[1, ::3] = np.inf
    tomb = rng.integers(0, 256, (4,)).astype(np.uint8)
    for k, tb in ((4, None), (4, tomb), (40, tomb)):
        tv, ti = tops.masked_topk_tail(t(d), t(tb), 30, k=k)
        jv, ji = jops.masked_topk_tail(j(d), j(tb), 30, k=k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
