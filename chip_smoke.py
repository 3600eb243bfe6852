#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one JSON line each on standard output:

  1. device  — the card, its power limit; TF32 off for matmuls and cuDNN;
  2. build   — nvcc builds every kernel of ``src/repro_torch/csrc`` into
     ``build/`` (one compiler per source, all started together, while the
     host generates the data);
  3. kernels — each kernel against its plain torch version on the card.
     The segmented kernels: f32 / fp16 / int8, l2 / ip, tombstones on and
     off, ragged and empty segments, a tail segment, k' > lmax.  The dense
     kernels (masked_distance, filtered_topk): l2 / ip, N not a multiple
     of the row tile, ragged Q, the empty query mask, an empty filter,
     k up to the pool's 32, k > N, a tombstone bitmap, and the same query
     rows bitwise equal at buckets 1, 8 and 256.  The graph's per-hop
     gather_distance: l2 / ip, ids < 0, D = 128 and 100, Q = 1 and
     batches, buckets 1 / 8 / 256; and the card build of the graph against
     the plain build (bitwise on tie-free integer rows, the compiled
     reverse pass bitwise on its own; identical rows reported on random
     data).  Integer data
     (``rint(randn·4)``, every f32 sum exact): positions, ids and values
     bitwise.  Random data, and int8 (its dequantized rows are not
     integers): values allclose at rtol 1e-5, positions equal up to
     boundary ties;
  4. main path at the paper's scale (ELIPaperConfig: 1,000,000 vectors,
     D = 128, a 32-label Zipf(1.5) universe, mean set size 3, c = 0.2,
     k = 10) with a 1,000-query workload, 75% of it subsets of base label
     sets: one EIS selection, then flat engines with f32 and int8+rerank
     storage, each run with fused="auto" (the fused-scan kernel) and
     fused=False (the gather-distance kernel): warmup, batched == looped
     on 200 queries, recall@10 against an exact float64 brute force on the
     card, warm QPS and p50/p99 latency of 32-query batches;
  4b. the same selection on the ``ivf`` backend (nprobe 8, 8 k-means
     iterations, √n clusters): build seconds, batched == looped on 200
     queries, the ``"cuda"`` results against the same indexes on
     ``kernel_backend="ref"`` (equal up to ties), recall@10 (reported,
     not gated: IVF is approximate), warm QPS and p50/p99;
  4c. the private-copy FlatIndex over all 1,000,000 rows, the
     no-selection PostFiltering scan: recall@10 >= 0.999, search ==
     search_padded sliced, warm QPS and p50/p99;
  4d. the ``graph`` backend (M 16, n_cand 64, α 1.2, ef 64, post) over
     the data's first 100,000 rows (raised along 200k / 500k / 10^6 while
     a build takes under 20 s and the phase fits its ~5 minutes) with its
     own selection: build seconds by stage, batched == looped on 200
     queries, ``"cuda"`` == ``"ref"`` up to ties, every result passing its
     filter, every degree <= M; recall@10, QPS, p50/p99, hops and distance
     computations reported.
     Every launch count is set to 0 just before each of 4, 4b, 4c and 4d
     and read just after; each kernel of that path must have launched;
  5. each kernel timed at its path's top-tier shapes beside its plain
     version and its bound (gather_distance at one hop: [256, 16] ids).

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and the contract line
``{"ok": true, "device": {...}}`` last.  Any failure raises and exits
non-zero; without a card, or without the repository's ``src/repro_torch``
beside this file, it exits non-zero before doing anything.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain: rtol 1e-5, and an absolute floor for values near 0 (an
# f32 sum of 128 products of unit size carries ~1e-5 absolute error)
RTOL, ATOL = 1e-5, 1e-4

PAPER = dict(n_vectors=1_000_000, dim=128, n_labels=32, zipf_a=1.5,
             avg_label_size=3.0, elastic_bound=0.2, k=10)
N_QUERIES = 1000
STORAGES = ("f32", "int8+rerank")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


class Clock:
    """Device time of a callable: CUDA events around ``reps`` launches
    after a warm-up, in milliseconds (host clock on a CPU device, which
    only rehearsals use)."""

    def __init__(self, dev):
        self.dev = dev

    def ms(self, fn, budget_s: float = 0.5, max_reps: int = 50) -> float:
        import torch
        fn()
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        reps = max(1, min(max_reps, int(budget_s / max(
            time.perf_counter() - t0, 1e-6))))
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        self.sync()
        return a.elapsed_time(b) / reps

    def sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _arena(dtype, N, D, W, integer, rng, dev):
    import torch

    from repro_torch.index.base import quantize_int8

    xf = rng.standard_normal((N, D)).astype(np.float32)
    if integer:
        xf = np.rint(xf * 4).astype(np.float32)
    scales = zeros = None
    if dtype == "f32":
        ax = xf
    elif dtype == "fp16":
        ax = xf.astype(np.float16)
    else:
        ax, scales, zeros = quantize_int8(xf)
    xd = (ax.astype(np.float32) if dtype != "int8"
          else zeros[:, None] + scales[:, None] * ax.astype(np.float32))
    alw = (rng.random((N, W)) < 0.7).astype(np.int32)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)
    return dict(ax=t(ax), alw=t(alw),
                axn=t(np.sum(xd * xd, axis=1).astype(np.float32)),
                scales=t(scales), zeros=t(zeros),
                tomb=t(rng.integers(0, 256, (-(-N // 8),)).astype(np.uint8)),
                xf=t(xf))


def _queries(Q, D, W, integer, rng, dev):
    import torch
    q = rng.standard_normal((Q, D)).astype(np.float32)
    if integer:
        q = np.rint(q * 4).astype(np.float32)
    lq = np.zeros((Q, W), np.int32)
    lq[:, 0] = rng.integers(0, 2, Q)
    return torch.from_numpy(q).to(dev), torch.from_numpy(lq).to(dev)


def _compare(kv, kp, pv, pp, *, integer, int8, tag):
    """Hold a kernel's (vals, pos) against the plain version's (moved to
    the kernel's device); returns the largest absolute value error over
    finite entries."""
    import torch
    pv = pv.to(kv.device)
    fin = torch.isfinite(pv)
    if not torch.equal(torch.isfinite(kv), fin):
        raise AssertionError(f"{tag}: finite masks differ")
    err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    # integer data makes every f32 sum exact — except int8, whose
    # dequantized rows are not integers: its sums round, so near-ties
    # fall either way and positions are held up to ties like random data
    exact = integer and not int8
    if exact:
        if not torch.equal(kv, pv):
            raise AssertionError(f"{tag}: values differ (max {err})")
    elif not torch.allclose(kv[fin], pv[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{tag}: values not allclose (max {err})")
    if kp is not None:
        diff = kp != pp.to(kp.device)
        if exact and diff.any():
            raise AssertionError(f"{tag}: positions differ")
        # a position may differ only at a boundary tie, where the two
        # values it displaced agree within the tolerance
        if diff.any() and not torch.allclose(kv[diff], pv[diff], rtol=RTOL,
                                             atol=ATOL):
            raise AssertionError(f"{tag}: positions differ beyond ties")
    return err


def kernel_checks(dev, *, N=32768, D=128, W=4, Q=48, lmax=2048, seed=0):
    """Every kernel and the segmented search against their plain versions
    on synthetic arenas at the main path's row width."""
    import torch

    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    errs = {"fused_scan": 0.0, "segmented_gather_distance": 0.0}
    cases = 0
    for integer in (True, False):
        for dtype in ("f32", "fp16", "int8"):
            A = _arena(dtype, N, D, W, integer, rng, dev)
            q, lq = _queries(Q, D, W, integer, rng, dev)
            R = 3 * lmax
            rc = torch.from_numpy(rng.integers(0, N, R).astype(np.int32)).to(dev)
            starts = rng.integers(0, R - lmax, Q).astype(np.int32)
            lens = rng.integers(0, lmax + 1, Q).astype(np.int32)
            lens[::5] = 0
            starts[-1], lens[-1] = R - 700, 700          # tail segment
            starts = torch.from_numpy(starts).to(dev)
            lens = torch.from_numpy(lens).to(dev)
            int8 = dtype == "int8"
            sz = dict(scales=A["scales"], zeros=A["zeros"])
            for metric in ("l2", "ip"):
                gids = torch.from_numpy(rng.integers(0, N, (Q, lmax))
                                        .astype(np.int32)).to(dev)
                glens = torch.clamp(lens, max=lmax).contiguous()
                kv = gd.segmented_gather_distance(
                    q, lq, A["ax"], A["alw"], gids, glens, metric=metric,
                    **sz)
                pv = gd.segmented_gather_distance_plain(
                    q, lq, A["ax"], A["alw"], gids, glens, metric=metric,
                    **sz)
                errs["segmented_gather_distance"] = max(
                    errs["segmented_gather_distance"],
                    _compare(kv, None, pv, None, integer=integer, int8=int8,
                             tag=f"gather {dtype} {metric} int={integer}"))
                for tomb in (None, A["tomb"]):
                    for kp, span, lm in ((10, 256, lmax), (40, lmax, lmax),
                                         (40, 16, 16)):   # k' > lmax
                        ln = torch.clamp(lens, max=lm).contiguous()
                        args = (q, lq, A["ax"], A["alw"], A["axn"], rc,
                                starts, ln, tomb, A["scales"], A["zeros"])
                        kv, kp_ = fs.fused_scan_cuda(
                            *args, kp=kp, lmax=lm, span=span, metric=metric,
                            dtype=dtype)
                        pv, pp = fs.fused_scan_plain(
                            *args, kp=kp, lmax=lm, chunk=min(lm, 512),
                            qtile=16, metric=metric, dtype=dtype)
                        errs["fused_scan"] = max(errs["fused_scan"], _compare(
                            kv, kp_, pv, pp, integer=integer, int8=int8,
                            tag=f"fused {dtype} {metric} tomb="
                                f"{tomb is not None} kp={kp} span={span} "
                                f"int={integer}"))
                        cases += 1
    # the whole segmented search, every storage spec, fused and unfused,
    # against the same call on host copies (the plain versions)
    rng = np.random.default_rng(seed + 1)
    for spec in ("f32", "fp16", "int8", "fp16+rerank", "int8+rerank"):
        dtype = spec.split("+")[0]
        A = _arena(dtype, 4096, D, W, True, rng, dev)
        q, lq = _queries(32, D, W, True, rng, dev)
        rc = torch.from_numpy(rng.integers(0, 4096, 3000).astype(np.int32)).to(dev)
        st = torch.from_numpy(rng.integers(0, 1976, 32).astype(np.int32)).to(dev)
        ln = torch.from_numpy(rng.integers(0, 1025, 32).astype(np.int32)).to(dev)
        kw = dict(dtype=dtype, scales=A["scales"], zeros=A["zeros"])
        if spec.endswith("+rerank"):
            kw.update(rerank=A["xf"], rerank_norms=torch.sum(
                A["xf"] * A["xf"], dim=1))
        for fused in (True, False):
            for metric in ("l2", "ip"):
                call = dict(k=10, lmax=1024, metric=metric, fused=fused,
                            backend="cuda", tomb=A["tomb"])
                args = (q, lq, A["ax"], A["alw"], A["axn"], rc, st, ln)
                got = ops.segmented_topk(*args, device=dev, **call, **kw)
                want = ops.segmented_topk(
                    *[a.cpu() for a in args], device="cpu", **call,
                    **{k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in kw.items()})
                tag = f"segmented_topk {spec} fused={fused} {metric}"
                _compare(got[0], got[1], want[0], want[1], integer=True,
                         int8=dtype == "int8", tag=tag)
                same = got[1].cpu() == want[1]
                if not torch.equal(got[2].cpu()[same], want[2][same]):
                    raise AssertionError(f"{tag}: ids differ")
                cases += 1
    return dict(cases=cases, max_abs_err=errs,
                tolerance=f"integer data: bitwise; random data and int8: "
                          f"rtol {RTOL} atol {ATOL}, positions up to ties")


def dense_kernel_checks(dev, *, N=20011, D=128, W=4, seed=2):
    """The dense kernels (masked_distance, filtered_topk) against their
    plain versions: l2 / ip, N not a multiple of the row tile, ragged Q
    on both query tiles (5 and 37 queries), the empty query mask, an empty
    filter (a label no row holds), k = 1, 10 and 32 (the pool's capacity),
    k > N, a tombstone bitmap (``ops.filtered_topk``'s composed path);
    filtered_topk's values bitwise those of masked_distance; and the same
    query rows bitwise equal at buckets 1, 8 and 256."""
    import torch

    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    errs = {"masked_distance": 0.0, "filtered_topk": 0.0}
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for integer in (True, False):
        for n in (N, 7):
            x = rng.standard_normal((n, D)).astype(np.float32)
            if integer:
                x = np.rint(x * 4).astype(np.float32)
            lx = t((rng.random((n, W)) < 0.7).astype(np.int32))
            x = t(x)
            tomb = t(rng.integers(0, 256, (-(-n // 8),)).astype(np.uint8))
            for Q in (5, 37):
                q, lq = _queries(Q, D, W, integer, rng, dev)
                lq[0] = 0                          # the empty query mask
                lq[-1, 0] = 1 << 30                # no row (0 / 1) holds it
                for metric in ("l2", "ip"):
                    tag = f"n={n} Q={Q} {metric} int={integer}"
                    kd = md.masked_distance(q, x, lq, lx, metric=metric)
                    pd = md.masked_distance_plain(q, x, lq, lx, metric=metric)
                    errs["masked_distance"] = max(
                        errs["masked_distance"],
                        _compare(kd, None, pd, None, integer=integer,
                                 int8=False, tag=f"masked_distance {tag}"))
                    if not torch.isinf(kd[-1]).all():
                        raise AssertionError(f"{tag}: empty filter passed")
                    for k in (1, 10, 32):
                        kv, ki = ft.filtered_topk(q, x, lq, lx, k=k,
                                                  metric=metric)
                        pv, pi = ft.filtered_topk_plain(q, x, lq, lx, k=k,
                                                        metric=metric)
                        errs["filtered_topk"] = max(
                            errs["filtered_topk"],
                            _compare(kv, ki, pv, pi, integer=integer,
                                     int8=False,
                                     tag=f"filtered_topk {tag} k={k}"))
                        fin = torch.isfinite(kv)
                        at = torch.gather(kd, 1, torch.clamp(ki, max=n - 1)
                                          .long())
                        if not torch.equal(at[fin], kv[fin]) or \
                                (ki[~fin] != n).any():
                            raise AssertionError(
                                f"{tag} k={k}: filtered_topk disagrees "
                                f"with masked_distance")
                        cases += 1
                    got = ops.filtered_topk(q, x, lq, lx, k=10, metric=metric,
                                            tomb=tomb, backend="cuda",
                                            device=dev)
                    want = ops.filtered_topk(q, x, lq, lx, k=10,
                                             metric=metric, tomb=tomb,
                                             backend="ref", device=dev)
                    _compare(got[0], got[1], want[0], want[1],
                             integer=integer, int8=False,
                             tag=f"filtered_topk tomb {tag}")
                    cases += 2
    # batch independence: bucket 1, 8 and 256 rows bitwise equal
    x = t(rng.standard_normal((N, D)).astype(np.float32))
    lx = t((rng.random((N, W)) < 0.7).astype(np.int32))
    q, lq = _queries(256, D, W, False, rng, dev)
    for metric in ("l2", "ip"):
        full = md.masked_distance(q, x, lq, lx, metric=metric)
        top = ft.filtered_topk(q, x, lq, lx, k=10, metric=metric)
        for b in (1, 8):
            if not torch.equal(md.masked_distance(q[:b], x, lq[:b], lx,
                                                  metric=metric), full[:b]):
                raise AssertionError(f"masked_distance bucket {b} != 256")
            part = ft.filtered_topk(q[:b], x, lq[:b], lx, k=10,
                                    metric=metric)
            if not all(torch.equal(a, c[:b]) for a, c in zip(part, top)):
                raise AssertionError(f"filtered_topk bucket {b} != 256")
        cases += 1
    return dict(cases=cases, max_abs_err=errs,
                tolerance=f"integer data: bitwise; random data: rtol {RTOL} "
                          f"atol {ATOL}, positions up to ties; buckets 1 / 8 "
                          f"/ 256: bitwise")


def graph_kernel_checks(dev, *, N=20011, seed=4):
    """B5 (gather_distance) against its plain version: integer and random
    data, l2 / ip, ids < 0 -> +inf, D = 128 (16-byte loads) and D = 100,
    Q = 1 through ``ops.gather_distance`` (the JAX signature) and batches
    whose pair count is not a multiple of the block; the same rows bitwise
    at Q = 1, 8 and 256."""
    import torch

    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    err, cases, bitwise = 0.0, 0, True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for integer in (True, False):
        for D in (128, 100):
            x = rng.standard_normal((N, D)).astype(np.float32)
            if integer:
                x = np.rint(x * 4).astype(np.float32)
            x = t(x)
            for metric in ("l2", "ip"):
                for Q, B in ((1, 16), (37, 16), (5, 301)):
                    q, _ = _queries(Q, D, 1, integer, rng, dev)
                    ids = rng.integers(-2, N, (Q, B)).astype(np.int32)
                    ids[0, 0] = -1
                    ids = t(ids)
                    kv = gd.gather_distance(q, x, ids, metric=metric)
                    pv = gd.gather_distance_plain(q, x, ids, metric=metric)
                    tag = f"gather_distance D={D} Q={Q} B={B} {metric} " \
                          f"int={integer}"
                    err = max(err, _compare(kv, None, pv, None,
                                            integer=integer, int8=False,
                                            tag=tag))
                    bitwise &= bool(torch.equal(kv, pv))
                    if not torch.isinf(kv[ids < 0]).all():
                        raise AssertionError(f"{tag}: ids < 0 not +inf")
                    one = ops.gather_distance(q[0], x, ids[0], metric=metric,
                                              backend="cuda", device=dev)
                    if not torch.equal(one, kv[0]):
                        raise AssertionError(f"{tag}: Q = 1 row differs")
                    cases += 1
    x = t(rng.standard_normal((N, 128)).astype(np.float32))
    q, _ = _queries(256, 128, 1, False, rng, dev)
    ids = t(rng.integers(-1, N, (256, 16)).astype(np.int32))
    for metric in ("l2", "ip"):
        full = gd.gather_distance(q, x, ids, metric=metric)
        for b in (1, 8):
            if not torch.equal(gd.gather_distance(q[:b], x, ids[:b],
                                                  metric=metric), full[:b]):
                raise AssertionError(f"gather_distance bucket {b} != 256")
        cases += 1
    return dict(cases=cases, max_abs_err={"gather_distance": err},
                random_bitwise=bitwise,
                tolerance=f"integer data: bitwise; random data: rtol {RTOL} "
                          f"atol {ATOL}; buckets 1 / 8 / 256: bitwise")


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
            return x.astype(np.float32)
        x[tied] = np.rint(rng.standard_normal((tied.size, D)) * scale)


def _plain_build_stages(x, M, n_cand, alpha):
    """The plain build, stage by stage: (adj, medoid, forward adj, forward
    deg, reverse-pass adj, reverse-pass deg)."""
    from repro_torch.index import graph as g
    medoid = g.medoid_of(x)
    fa, fd = g._forward_plain(x, g._pairwise_block_topk(x, n_cand), alpha, M)
    adj, deg = fa.copy(), fd.copy()
    g.reverse_edges_plain(x, adj, deg, alpha, M)
    ra, rd = adj.copy(), deg.copy()
    g.fix_orphans(adj, deg, medoid, M)
    return adj, medoid, fa, fd, ra, rd


def graph_build_checks(dev, *, n=4000, n_random=2000, D=128, M=16,
                       n_cand=64, alpha=1.2, seed=5):
    """The card build against the plain build: on integer rows whose
    per-row candidate distances are distinct, adjacency and medoid
    bitwise, and the compiled reverse pass, run on the plain forward
    lists, bitwise the plain reverse pass; on random rows the share of
    identical adjacency rows (reported: the card's candidate distances sum
    in another order than numpy's matmul)."""
    from repro_torch.index import graph as g

    out = {}
    x = tie_free_points(n, D, n_cand, 100.0, seed)
    xr = np.random.default_rng(seed + 1).standard_normal(
        (n_random, D)).astype(np.float32)
    for name, data in (("integer", x), ("random", xr)):
        t0 = time.perf_counter()
        adj, medoid, fa, fd, ra, rd = _plain_build_stages(data, M, n_cand,
                                                          alpha)
        plain_s = time.perf_counter() - t0
        ca, cd = fa.copy(), fd.copy()
        t0 = time.perf_counter()
        g.reverse_edges_compiled(data, ca, cd, alpha, M)
        compiled_s = time.perf_counter() - t0
        reverse_ok = bool(np.array_equal(ca, ra) and np.array_equal(cd, rd))
        stages = {}
        kadj, kmed = g.build_vamana(data, M, n_cand, alpha, device=dev,
                                    timings=stages)
        same = float(np.mean(np.all(kadj == adj, axis=1)))
        out[name] = dict(rows=len(data), plain_seconds=plain_s,
                         compiled_reverse_seconds=compiled_s,
                         compiled_reverse_equals_plain=reverse_ok,
                         card_stage_seconds=stages, medoid_equal=kmed == medoid,
                         identical_rows=same,
                         max_degree=int((kadj >= 0).sum(1).max()))
        if name == "integer" and not (reverse_ok and same == 1.0
                                      and kmed == medoid):
            raise AssertionError(f"graph build on tie-free integer rows: "
                                 f"{out[name]}")
        if out[name]["max_degree"] > M:
            raise AssertionError(f"graph build: degree above M ({name})")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def paper_data(n: int, seed: int = 0):
    from repro_torch.core import generate_query_label_sets
    from repro_torch.data import VectorLabelDataset

    ds = VectorLabelDataset(n=n, dim=PAPER["dim"], n_labels=PAPER["n_labels"],
                            zipf_a=PAPER["zipf_a"],
                            avg_size=PAPER["avg_label_size"], seed=seed)
    vectors, label_sets = ds.generate()
    qls = generate_query_label_sets(label_sets, N_QUERIES, seed=seed + 1,
                                    from_base_fraction=0.75)
    qv = np.random.default_rng(seed + 2).standard_normal(
        (N_QUERIES, PAPER["dim"])).astype(np.float32)
    return vectors, label_sets, qv, qls


def exact_topk(vectors_dev, lx_dev, qv, qls, k, dev, block=64):
    """Exact filtered top-k in float64 on the card (the recall truth)."""
    import torch

    from repro_torch.core import encode_many, masks_to_int32_words

    x = vectors_dev.double()
    xn = torch.sum(x * x, dim=1)
    lq = torch.from_numpy(masks_to_int32_words(encode_many(qls))).to(dev)
    n = x.shape[0]
    out = []
    for i in range(0, len(qls), block):
        q = torch.from_numpy(qv[i:i + block]).to(dev).double()
        d = torch.sum(q * q, 1)[:, None] - 2.0 * (q @ x.T) + xn[None, :]
        ql = lq[i:i + block]
        keep = torch.ones_like(d, dtype=torch.bool)
        for w in range(ql.shape[1]):
            keep &= (ql[:, None, w] & lx_dev[None, :, w]) == ql[:, None, w]
        d = torch.where(keep, d, torch.full_like(d, float("inf")))
        vals, idx = torch.topk(d, k, dim=1, largest=False)
        out.append(torch.where(torch.isinf(vals), n, idx).cpu().numpy())
    return np.concatenate(out)


def main_path(dev, *, data, data_seconds, counts, clock):
    """Selection once, then four engines (two storage specs, fused and
    unfused); returns per-engine results, the engines (for the timing
    phase) and what the later paths share: the workload, its exact truth
    and the selection."""
    import torch

    from repro_torch.core import (GroupTable, LabelHybridEngine, greedy_eis,
                                  observed_query_keys, recall_at_k)

    vectors, label_sets, qv, qls = data
    n = len(label_sets)
    t0 = time.perf_counter()
    qkeys = observed_query_keys(qls)
    table = GroupTable.build(label_sets, qkeys)
    selection = greedy_eis(table.closure_sizes, PAPER["elastic_bound"], qkeys)
    t_select = time.perf_counter() - t0
    emit("selection", n=n, queries=N_QUERIES, keys=len(qkeys),
         selected=len(selection.selected),
         total_entries=selection.total_entries,
         entries_over_n=selection.total_entries / n,
         data_seconds=data_seconds, select_seconds=t_select)

    k = PAPER["k"]
    results, engines, truth, lx_dev = {}, {}, None, None
    for storage in STORAGES:
        for fused in ("auto", False):
            t0 = time.perf_counter()
            eng = LabelHybridEngine(vectors, label_sets, table, selection,
                                    None, "flat", "l2", {"fused": fused},
                                    t_select, storage=storage, device=dev)
            clock.sync()
            build_s = time.perf_counter() - t0
            if truth is None:
                routed = eng.route_many(qls)
                tiers = {}
                for key in routed:
                    span = 1 << max(eng.segments[key][1] - 1, 0).bit_length()
                    tiers[span] = tiers.get(span, 0) + 1
                emit("routing", queries_per_span_tier=dict(sorted(
                    tiers.items())), span_tiers=sorted({
                        1 << max(length - 1, 0).bit_length()
                        for _, length in eng.segments.values()}))
                lx_dev = eng.arena.label_words
                vec_dev = (eng.arena.vectors if eng.arena.dtype == "f32"
                           else eng.arena.rerank)
                t0 = time.perf_counter()
                truth = exact_topk(vec_dev, lx_dev, qv, qls, k, dev)
                emit("truth", seconds=time.perf_counter() - t0)
            warm = eng.warmup_serving([k], min_bucket=1, max_batch=64)
            before = dict(counts())
            t0 = time.perf_counter()
            _, ids = eng.search_batched(qv, qls, k)
            first_s = time.perf_counter() - t0
            per_batch = {name: counts()[name] - before[name]
                         for name in before}
            recall = recall_at_k(ids, truth, n)
            bd, bi = eng.search_batched(qv[:200], qls[:200], k)
            ld, li = eng.search_looped(qv[:200], qls[:200], k)
            looped_ok = bool(np.array_equal(bi, li) and np.array_equal(bd, ld)
                             and np.array_equal(bi, ids[:200]))
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.search_batched(qv, qls, k)
                times.append(time.perf_counter() - t0)
            lat = []
            for rep in range(2):
                for i in range(0, N_QUERIES, 32):
                    t0 = time.perf_counter()
                    eng.search_batched(qv[i:i + 32], qls[i:i + 32], k)
                    if rep:
                        lat.append(time.perf_counter() - t0)
            name = f"{storage}/fused={fused}"
            results[name] = dict(
                storage=storage, fused=fused, build_seconds=build_s,
                warmup_seconds=warm["seconds"], warmup_launches=warm["programs"],
                first_batch_seconds=first_s,
                warm_qps=N_QUERIES / float(np.median(times)),
                batch_seconds=times, p50_ms_32=float(np.percentile(lat, 50)) * 1e3,
                p99_ms_32=float(np.percentile(lat, 99)) * 1e3,
                recall_at_10=recall, batched_equals_looped=looped_ok,
                launches_per_1000_query_batch=per_batch,
                arena_bytes=eng.arena.nbytes,
                peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None))
            emit("engine", **results[name])
            if not looped_ok:
                raise AssertionError(f"{name}: batched != looped")
            if recall < 0.999:
                raise AssertionError(f"{name}: recall@10 {recall} < 0.999")
            engines[name] = eng
    return results, engines, dict(qv=qv, qls=qls, truth=truth, table=table,
                                  selection=selection, select_seconds=t_select)


def _serve_numbers(search, qv, qls, k):
    """Warm QPS of the 1,000-query batch (median of 3) and p50 / p99
    latency of 32-query batches (the second of two passes)."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        search(qv, qls, k)
        times.append(time.perf_counter() - t0)
    lat = []
    for rep in range(2):
        for i in range(0, len(qls), 32):
            t0 = time.perf_counter()
            search(qv[i:i + 32], qls[i:i + 32], k)
            if rep:
                lat.append(time.perf_counter() - t0)
    return dict(warm_qps=len(qls) / float(np.median(times)),
                batch_seconds=times,
                p50_ms_32=float(np.percentile(lat, 50)) * 1e3,
                p99_ms_32=float(np.percentile(lat, 99)) * 1e3)


def _ivf_cuda_vs_ref(eng, qv, qls, k, qsel, dev):
    """The ivf engine's ``"cuda"`` results against the same indexes
    searched with ``kernel_backend="ref"`` (plain torch on the card).  A
    query may differ only at a tie: at the top-k boundary (the displaced
    values agree within the tolerance) or at the probe boundary (the two
    backends order near-equal centroid distances differently)."""
    import torch

    from repro_torch.kernels import ops

    qs, ls = qv[qsel], [qls[i] for i in qsel]
    got = eng.search_batched(qs, ls, k)
    for ix in eng.indexes.values():
        ix.kernel_backend = "ref"
    try:
        want = eng.search_batched(qs, ls, k)
    finally:
        for ix in eng.indexes.values():
            ix.kernel_backend = "cuda"
    gd, gi = (torch.from_numpy(a) for a in got)
    wd, wi = (torch.from_numpy(a) for a in want)
    rows = (gi != wi).any(dim=1).nonzero().flatten().tolist()
    value_ties = probe_ties = 0
    for r in rows:
        diff = gi[r] != wi[r]
        fin = torch.isfinite(wd[r])
        if torch.equal(torch.isfinite(gd[r]), fin) and torch.allclose(
                gd[r][diff & fin], wd[r][diff & fin], rtol=RTOL, atol=ATOL):
            value_ties += 1
            continue
        ix = eng.indexes[eng.route(tuple(ls[r]))]
        q = torch.from_numpy(qs[r:r + 1]).to(dev)
        none = torch.zeros((1, ix._cwords.shape[1]), dtype=torch.int32,
                           device=dev)
        cds = [ops.masked_distance(q, ix._cents, none, ix._cwords,
                                   metric=ix.metric, backend=b, device=dev)[0]
               for b in ("cuda", "ref")]
        orders = [torch.argsort(c, stable=True) for c in cds]
        if torch.equal(orders[0], orders[1]) or not torch.allclose(
                cds[0][orders[0]], cds[1][orders[1]], rtol=RTOL, atol=ATOL):
            raise AssertionError(f"ivf cuda vs ref: query {qsel[r]} differs "
                                 f"beyond ties")
        probe_ties += 1
    return dict(queries=len(qsel), equal=len(qsel) - len(rows),
                value_ties=value_ties, probe_ties=probe_ties)


def ivf_path(dev, *, data, ctx, counts, clock):
    """Phase 4b: the engine on the ``ivf`` backend (JAX defaults: nprobe 8,
    8 k-means iterations, √n clusters; f32 storage) over the phase-4
    selection.  Returns its results and the engine."""
    from repro_torch.core import EMPTY_KEY, LabelHybridEngine, recall_at_k

    vectors, label_sets, qv, qls = data
    n, k = len(label_sets), PAPER["k"]
    t0 = time.perf_counter()
    eng = LabelHybridEngine(vectors, label_sets, ctx["table"],
                            ctx["selection"], None, "ivf", "l2", {},
                            ctx["select_seconds"], device=dev)
    clock.sync()
    build_s = time.perf_counter() - t0
    before = dict(counts())
    t0 = time.perf_counter()
    _, ids = eng.search_batched(qv, qls, k)
    first_s = time.perf_counter() - t0
    per_batch = {name: counts()[name] - before[name] for name in before}
    recall = recall_at_k(ids, ctx["truth"], n)
    bd, bi = eng.search_batched(qv[:200], qls[:200], k)
    ld, li = eng.search_looped(qv[:200], qls[:200], k)
    looped_ok = bool(np.array_equal(bi, li) and np.array_equal(bd, ld)
                     and np.array_equal(bi, ids[:200]))
    if not looped_ok:
        raise AssertionError("ivf: batched != looped")
    routed = eng.route_many(qls)
    top = [i for i, key in enumerate(routed) if key == EMPTY_KEY]
    qsel = sorted(set(range(64)) | set(top[:32]))
    vs_ref = _ivf_cuda_vs_ref(eng, qv, qls, k, qsel, dev)
    res = dict(backend="ivf", nprobe=8, kmeans_iters=8,
               indexes=len(eng.indexes), build_seconds=build_s,
               first_batch_seconds=first_s, recall_at_10=recall,
               batched_equals_looped=looped_ok, cuda_vs_ref=vs_ref,
               launches_per_1000_query_batch=per_batch,
               private_bytes=eng.stats().nbytes,
               top_index_rows=int(eng.indexes[EMPTY_KEY].num_vectors),
               top_index_clusters=int(eng.indexes[EMPTY_KEY].n_clusters),
               queries_at_top_index=len(top),
               **_serve_numbers(eng.search_batched, qv, qls, k))
    emit("engine", **res)
    return res, eng


def flat_scan_path(dev, *, data, ctx, counts, clock):
    """Phase 4c: the private-copy FlatIndex over all N rows — the
    no-selection PostFiltering scan — answering the workload through
    filtered_topk.  Returns its results and the index."""
    from repro_torch.core import encode_many, masks_to_int32_words, recall_at_k
    from repro_torch.index import FlatIndex

    vectors, label_sets, qv, qls = data
    n, k = len(label_sets), PAPER["k"]
    lx = masks_to_int32_words(encode_many(label_sets))
    qw = masks_to_int32_words(encode_many(qls))
    t0 = time.perf_counter()
    flat = FlatIndex(vectors, lx, device=dev)
    clock.sync()
    build_s = time.perf_counter() - t0
    before = dict(counts())
    d, ids = flat.search(qv, qw, k)
    per_batch = {name: counts()[name] - before[name] for name in before}
    recall = recall_at_k(ids, ctx["truth"], n)
    bucket = 1 << (len(qls) - 1).bit_length()
    qp = np.zeros((bucket, qv.shape[1]), np.float32)
    qp[:len(qls)] = qv
    lp = np.zeros((bucket, qw.shape[1]), np.int32)
    lp[:len(qls)] = qw
    pd, pi = flat.search_padded(qp, lp, k)
    padded_ok = bool(np.array_equal(pi[:len(qls)].cpu().numpy(), ids)
                     and np.array_equal(pd[:len(qls)].cpu().numpy(), d))
    res = dict(index="FlatIndex", rows=n, build_seconds=build_s,
               recall_at_10=recall, search_equals_padded=padded_ok,
               launches_per_1000_query_batch=per_batch,
               **_serve_numbers(lambda q, ls, kk: flat.search(
                   q, masks_to_int32_words(encode_many(ls)), kk), qv, qls, k))
    emit("flat_scan", **res)
    if not padded_ok:
        raise AssertionError("FlatIndex: search != search_padded sliced")
    if recall < 0.999:
        raise AssertionError(f"FlatIndex: recall@10 {recall} < 0.999")
    return res, flat


GRAPH = dict(M=16, n_cand=64, alpha=1.2, ef_search=64, strategy="post")
GRAPH_ROWS = (100_000, 200_000, 500_000, 1_000_000)
GRAPH_RAISE_BELOW_S = 20.0      # raise N only if the first build is faster
GRAPH_PHASE_BUDGET_S = 300.0


def _graph_engine(dev, data, n):
    """The graph engine over the paper data's first ``n`` rows with its
    own EIS selection at c = 0.2 for the phase-4 workload; returns the
    engine and its selection and build seconds."""
    from repro_torch.core import LabelHybridEngine

    vectors, label_sets, _, qls = data
    t0 = time.perf_counter()
    eng = LabelHybridEngine.build(vectors[:n], label_sets[:n], mode="eis",
                                  c=PAPER["elastic_bound"],
                                  query_label_sets=qls, backend="graph",
                                  device=dev, **GRAPH)
    total = time.perf_counter() - t0
    st = eng.stats()
    return eng, dict(select_seconds=st.select_seconds,
                     build_seconds=st.build_seconds, seconds=total)


def _graph_cuda_vs_ref(eng, qv, qls, k, qsel):
    """The graph engine's ``"cuda"`` results against the same graphs
    searched with ``kernel_backend="ref"``; a query may differ only at a
    boundary tie (the displaced values agree within the tolerance)."""
    import torch

    qs, ls = qv[qsel], [qls[i] for i in qsel]
    got = eng.search_batched(qs, ls, k)
    for ix in eng.indexes.values():
        ix.kernel_backend = "ref"
    try:
        want = eng.search_batched(qs, ls, k)
    finally:
        for ix in eng.indexes.values():
            ix.kernel_backend = "cuda"
    gd, gi = (torch.from_numpy(a) for a in got)
    wd, wi = (torch.from_numpy(a) for a in want)
    rows = (gi != wi).any(dim=1).nonzero().flatten().tolist()
    for r in rows:
        diff = gi[r] != wi[r]
        fin = torch.isfinite(wd[r])
        if not (torch.equal(torch.isfinite(gd[r]), fin) and torch.allclose(
                gd[r][diff & fin], wd[r][diff & fin], rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"graph cuda vs ref: query {qsel[r]} "
                                 f"differs beyond ties")
    return dict(queries=len(qsel), equal=len(qsel) - len(rows),
                value_ties=len(rows))


def _graph_walk_stats(eng, qv, qls, k):
    """Mean hops and distance computations per query: each routed group
    searched once through its index's ``search`` (which keeps them)."""
    from repro_torch.core import encode_many, masks_to_int32_words

    hops, dcs = [], []
    by_key = {}
    for qi, key in enumerate(eng.route_many(qls)):
        by_key.setdefault(key, []).append(qi)
    qw = masks_to_int32_words(encode_many(qls))
    for key, qids in by_key.items():
        ix = eng.indexes[key]
        ix.search(qv[qids], qw[qids], k)
        hops.append(ix.last_stats.hops)
        dcs.append(ix.last_stats.dist_comps)
    return (float(np.concatenate(hops).mean()),
            float(np.concatenate(dcs).mean()))


def graph_path(dev, *, data, counts, clock):
    """Phase 4d: the engine on the ``graph`` backend (JAX defaults: M 16,
    n_cand 64, α 1.2, ef 64, PostFiltering) over the paper data's first
    100,000 rows, its own selection and the phase-4 workload; if that
    build takes under 20 s, N is raised along ``GRAPH_ROWS`` while the
    phase is predicted to stay within its budget.  Gates: batched ≡ looped on 200
    queries, ``"cuda"`` ≡ ``"ref"`` up to boundary ties on the first 64
    queries and 32 of the top index's, every returned id passes its
    query's filter, every degree ≤ M.  Hops and distance computations
    are the means over the first 200 queries.  Returns its results and
    engine."""
    import torch

    from repro_torch.core import (EMPTY_KEY, encode_many,
                                  masks_to_int32_words, recall_at_k)

    vectors, label_sets, qv, qls = data
    k = PAPER["k"]
    t_phase = time.perf_counter()
    tried = []
    n = GRAPH_ROWS[0]
    eng, built = _graph_engine(dev, data, n)
    tried.append(dict(rows=n, **built))
    stop = None
    if built["build_seconds"] >= GRAPH_RAISE_BELOW_S:
        stop = (f"the {n}-row build took {built['build_seconds']:.1f} s "
                f"(raise only below {GRAPH_RAISE_BELOW_S:.0f} s)")
    for nxt in GRAPH_ROWS[1:] if stop is None else ():
        # selection and build grow a little faster than the rows; the
        # searches below took ~100 s at 200k rows on an H100 host
        predicted = (time.perf_counter() - t_phase
                     + built["seconds"] * nxt / n * 1.5 + 150.0)
        if predicted > GRAPH_PHASE_BUDGET_S:
            stop = (f"{nxt} rows would take the phase to ~{predicted:.0f} s "
                    f"(budget {GRAPH_PHASE_BUDGET_S:.0f} s; the {n}-row "
                    f"selection and build took {built['seconds']:.1f} s)")
            break
        del eng
        torch.cuda.empty_cache()
        n = nxt
        eng, built = _graph_engine(dev, data, n)
        tried.append(dict(rows=n, **built))
    stages: dict[str, float] = {}
    for ix in eng.indexes.values():
        for name, sec in ix.build_seconds.items():
            stages[name] = stages.get(name, 0.0) + sec
    st = eng.stats()
    rows_total = sum(ix.num_vectors for ix in eng.indexes.values())
    degree_ok = all(bool(((ix.adjacency >= 0).sum(1) <= ix.M).all())
                    and int(ix.adjacency.max()) < ix.num_vectors
                    for ix in eng.indexes.values())

    lx_dev = torch.from_numpy(masks_to_int32_words(
        encode_many(label_sets[:n]))).to(dev)
    truth = exact_topk(torch.from_numpy(vectors[:n]).to(dev), lx_dev, qv,
                       qls, k, dev)
    before = dict(counts())
    t0 = time.perf_counter()
    _, ids = eng.search_batched(qv, qls, k)
    first_s = time.perf_counter() - t0
    per_batch = {name: counts()[name] - before[name] for name in before}
    recall = recall_at_k(ids, truth, n)
    lq = masks_to_int32_words(encode_many(qls)).astype(np.int64)
    lxh = masks_to_int32_words(encode_many(label_sets[:n])).astype(np.int64)
    live = ids < n
    got = lxh[np.where(live, ids, 0)]
    filters_ok = bool(np.all(((got & lq[:, None, :]) == lq[:, None, :])
                             .all(-1) | ~live))
    bd, bi = eng.search_batched(qv[:200], qls[:200], k)
    ld, li = eng.search_looped(qv[:200], qls[:200], k)
    looped_ok = bool(np.array_equal(bi, li) and np.array_equal(bd, ld)
                     and np.array_equal(bi, ids[:200]))
    routed = eng.route_many(qls)
    top = [i for i, key in enumerate(routed) if key == EMPTY_KEY]
    qsel = sorted(set(range(64)) | set(top[:32]))
    vs_ref = _graph_cuda_vs_ref(eng, qv, qls, k, qsel)
    hops, dcomps = _graph_walk_stats(eng, qv[:200], qls[:200], k)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.search_batched(qv, qls, k)
        times.append(time.perf_counter() - t0)
    lat = []
    for i in range(0, len(qls), 32):
        t0 = time.perf_counter()
        eng.search_batched(qv[i:i + 32], qls[i:i + 32], k)
        lat.append(time.perf_counter() - t0)
    res = dict(backend="graph", **GRAPH, rows=n, paper_rows=PAPER["n_vectors"],
               builds=tried,
               reduced=(f"N = {n} of the paper's {PAPER['n_vectors']}: "
                        f"{stop}" if stop else None),
               indexes=len(eng.indexes), graph_rows=rows_total,
               build_stage_seconds=stages, select_seconds=st.select_seconds,
               build_seconds=st.build_seconds, graph_bytes=st.nbytes,
               adjacency_bytes=sum(ix.adjacency.nbytes
                                   for ix in eng.indexes.values()),
               top_index_rows=int(eng.indexes[EMPTY_KEY].num_vectors),
               queries_at_top_index=len(top), routed_groups=len(set(routed)),
               first_batch_seconds=first_s, recall_at_10=recall,
               launches_per_1000_query_batch=per_batch,
               batched_equals_looped=looped_ok, cuda_vs_ref=vs_ref,
               filters_pass=filters_ok, degree_at_most_M=degree_ok,
               mean_hops=hops, mean_dist_comps=dcomps,
               warm_qps=len(qls) / float(np.median(times)),
               batch_seconds=times,
               p50_ms_32=float(np.percentile(lat, 50)) * 1e3,
               p99_ms_32=float(np.percentile(lat, 99)) * 1e3,
               phase_seconds=time.perf_counter() - t_phase)
    emit("engine", **res)
    if not looped_ok:
        raise AssertionError("graph: batched != looped")
    if not filters_ok:
        raise AssertionError("graph: a returned id fails its filter")
    if not degree_ok:
        raise AssertionError("graph: a degree above M or an id out of range")
    return res, eng


# ---------------------------------------------------------------------------
# phase 5: kernel times at the main path's shapes, beside their bounds
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def top_tier(eng, qv, qls):
    """The main path's largest span tier of the workload batch, as the
    engine hands it to ``ops.segmented_topk``."""
    import torch

    from repro_torch.core import encode_many, masks_to_int32_words

    qw = masks_to_int32_words(encode_many(qls))
    routed = eng.route_many(qls)
    *_, last = eng.arena_tier_batches(qv, qw, routed)
    _, qp, lp, starts, lens, lmax, g = last
    dev = eng.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(q=t(qp), lq=t(lp), starts=t(starts), lens=t(lens), lmax=lmax,
                queries=g)


def _segment_work(T, arena, rc):
    """Rows and ids the tier's segments touch, each counted once, and the
    (query, row) pairs whose labels pass."""
    import torch
    N, R = arena.n, rc.shape[0]
    pos_seen = torch.zeros(R, dtype=torch.bool, device=rc.device)
    rows_seen = torch.zeros(N, dtype=torch.bool, device=rc.device)
    rows_pass = torch.zeros(N, dtype=torch.bool, device=rc.device)
    pairs = 0
    for i in range(T["q"].shape[0]):
        s, L = int(T["starts"][i]), min(int(T["lens"][i]), T["lmax"])
        if L <= 0:
            continue
        seg = rc[s:s + L].long()
        pos_seen[s:s + L] = True
        rows_seen[seg] = True
        ok = torch.all((T["lq"][i] & arena.label_words[seg]) == T["lq"][i],
                       dim=1)
        rows_pass[seg[ok]] = True
        pairs += int(ok.sum())
    return int(pos_seen.sum()), int(rows_seen.sum()), int(rows_pass.sum()), pairs


def time_kernels(engines, workload, clock, counts_at_main, errs):
    import torch

    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline

    qv, qls = workload
    eng = engines["f32/fused=auto"]
    arena, rc = eng.arena, torch.from_numpy(eng.rows_concat).to(eng.device)
    T = top_tier(eng, qv, qls)
    Q, D = T["q"].shape
    W = T["lq"].shape[1]
    k = PAPER["k"]
    n_pos, n_seen, n_pass, pairs = _segment_work(T, arena, rc)
    out = []

    # fused scan at the top tier, tiles from the Hopper tile model
    tc = roofline.fused_scan_tiles(D, T["lmax"], "f32", Q, backend="cuda",
                                   device=eng.device)
    args = (T["q"], T["lq"], arena.vectors, arena.label_words, arena.norms,
            rc, T["starts"], T["lens"], None, None, None)
    kw = dict(kp=k, lmax=T["lmax"], metric="l2", dtype="f32")
    plain_chunk = min(T["lmax"], 16384)
    plain_qtile = max(1, min(Q, (1 << 29) // (plain_chunk * D * 4)))
    kv, kp_ = fs.fused_scan_cuda(*args, span=tc.rows_per_chunk, **kw)
    pv, pp = fs.fused_scan_plain(*args, chunk=plain_chunk, qtile=plain_qtile,
                                 **kw)
    err = _compare(kv, kp_, pv, pp, integer=False, int8=False,
                   tag="fused_scan at the top tier")
    ms = clock.ms(lambda: fs.fused_scan_cuda(*args, span=tc.rows_per_chunk,
                                             **kw))
    plain_ms = clock.ms(lambda: fs.fused_scan_plain(
        *args, chunk=plain_chunk, qtile=plain_qtile, **kw), max_reps=3)
    nbytes = (Q * D * 4 + Q * W * 4 + 8 * Q + 4 * n_pos + 4 * W * n_seen
              + (4 * D + 4) * n_pass + Q * k * 8)
    bound_ms, bound_by = _bound(nbytes, pairs * (2 * D + 3))
    out.append(dict(
        name="fused_scan", route="cuda",
        source="src/repro_torch/csrc/fused_scan.cu",
        replaces="src/repro/kernels/fused_scan.py:167",
        launches=counts_at_main["fused_scan"],
        max_abs_err=max(err, errs["fused_scan"]), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=dict(queries=T["queries"], q_bucket=Q, lmax=T["lmax"],
                   span_per_block=tc.rows_per_chunk, kp=k, dim=D,
                   pairs_passing=pairs, rows_touched=n_seen)))

    # gather distance: the unfused executor's first chunk at the top tier
    chunk = min(ops.SEG_CHUNK_CUDA, T["lmax"])
    pos = torch.arange(chunk, dtype=torch.int32, device=eng.device)
    gid, valid = ref.segment_gids(rc, T["starts"], T["lens"], pos)
    gids = gid.to(torch.int32).contiguous()
    glens = torch.sum(valid, dim=1).to(torch.int32)
    gargs = (T["q"], T["lq"], arena.vectors, arena.label_words, gids, glens)
    kv = gd.segmented_gather_distance(*gargs)
    pv = gd.segmented_gather_distance_plain(*gargs)
    err = _compare(kv, None, pv, None, integer=False, int8=False,
                   tag="gather at the top tier")
    ms = clock.ms(lambda: gd.segmented_gather_distance(*gargs))
    plain_ms = clock.ms(lambda: gd.segmented_gather_distance_plain(*gargs),
                        max_reps=5)
    live = valid.reshape(-1)
    flat = gid.reshape(-1)[live]
    passing = torch.all((T["lq"][:, None, :] & arena.label_words[gid])
                        == T["lq"][:, None, :], dim=-1) & valid
    rows_seen = int(torch.unique(flat).numel())
    rows_pass = int(torch.unique(gid[passing]).numel())
    gpairs = int(passing.sum())
    nbytes = (Q * D * 4 + Q * W * 4 + 4 * Q + 4 * gids.numel()
              + 4 * W * rows_seen + 4 * D * rows_pass + 4 * kv.numel())
    bound_ms, bound_by = _bound(nbytes, gpairs * 3 * D)
    out.append(dict(
        name="segmented_gather_distance", route="cuda",
        source="src/repro_torch/csrc/gather_distance.cu",
        replaces="src/repro/kernels/gather_distance.py:95",
        launches=counts_at_main["segmented_gather_distance"],
        max_abs_err=max(err, errs["segmented_gather_distance"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=T["queries"], q_bucket=Q, columns=chunk, dim=D,
                   pairs_passing=gpairs, rows_touched=rows_seen)))
    return out


def _dense_bound(Q: int, N: int, D: int, W: int, out_bytes: int):
    """Bound of a dense filtered pass: each input read once and the
    output written once; Q·N·(2D + 3) flops for the norms-form distances
    plus 2D for each norm."""
    nbytes = 4 * (Q + N) * (D + W) + out_bytes
    return _bound(nbytes, Q * N * (2 * D + 3) + 2 * D * (Q + N))


def time_dense_kernels(ivf_eng, flat, ctx, clock, launches, errs):
    """masked_distance at the ivf engine's top tier (the workload's
    queries routed to the largest index, on their power-of-two bucket)
    and filtered_topk at the whole-dataset scan's [1024-bucket, N] shape,
    each beside its plain version and its bound."""
    import torch

    from repro_torch.core import (EMPTY_KEY, encode_many,
                                  masks_to_int32_words)
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md

    qv, qls = ctx["qv"], ctx["qls"]
    dev = flat.device
    qw = masks_to_int32_words(encode_many(qls))
    out = []

    def padded(qids):
        b = 1 << (len(qids) - 1).bit_length()
        qp = torch.zeros((b, qv.shape[1]), dtype=torch.float32, device=dev)
        lp = torch.zeros((b, qw.shape[1]), dtype=torch.int32, device=dev)
        qp[:len(qids)] = torch.from_numpy(qv[qids]).to(dev)
        lp[:len(qids)] = torch.from_numpy(qw[qids]).to(dev)
        return qp, lp

    top = [i for i, key in enumerate(ivf_eng.route_many(qls))
           if key == EMPTY_KEY]
    ix = ivf_eng.indexes[EMPTY_KEY]
    qp, lp = padded(top)
    args = (qp, ix._xb, lp, ix._lxw)
    kd = md.masked_distance(*args)
    err = _compare(kd, None, md.masked_distance_plain(*args), None,
                   integer=False, int8=False,
                   tag="masked_distance at the ivf top tier")
    ms = clock.ms(lambda: md.masked_distance(*args))
    plain_ms = clock.ms(lambda: md.masked_distance_plain(*args), max_reps=2)
    Q, D = qp.shape
    N, W = ix._lxw.shape
    bound_ms, bound_by = _dense_bound(Q, N, D, W, 4 * Q * N)
    out.append(dict(
        name="masked_distance", route="cuda",
        source="src/repro_torch/csrc/masked_distance.cu",
        replaces="src/repro/kernels/masked_distance.py:64",
        launches=launches["masked_distance"],
        max_abs_err=max(err, errs["masked_distance"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=len(top), q_bucket=Q, rows=N, dim=D)))
    del kd

    k = PAPER["k"]
    qp, lp = padded(list(range(len(qls))))
    args = (qp, flat.vectors, lp, flat.label_words)
    kv, ki = ft.filtered_topk(*args, k=k)
    pv, pi = ft.filtered_topk_plain(*args, k=k)
    err = _compare(kv, ki, pv, pi, integer=False, int8=False,
                   tag="filtered_topk at the whole-dataset scan")
    ms = clock.ms(lambda: ft.filtered_topk(*args, k=k))
    plain_ms = clock.ms(lambda: ft.filtered_topk_plain(*args, k=k),
                        max_reps=1)
    Q, D = qp.shape
    N, W = flat.label_words.shape
    span, splits = ft.span_split(Q, N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    bound_ms, bound_by = _dense_bound(Q, N, D, W, 8 * Q * k)
    out.append(dict(
        name="filtered_topk", route="cuda",
        source="src/repro_torch/csrc/filtered_topk.cu",
        replaces="src/repro/kernels/filtered_topk.py:69",
        launches=launches["filtered_topk"],
        max_abs_err=max(err, errs["filtered_topk"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=len(qls), q_bucket=Q, rows=N, dim=D, k=k,
                   span_per_block=span, splits=splits)))
    return out


def time_graph_kernel(graph_eng, ctx, clock, launches, errs, seed=6):
    """gather_distance at one hop's shape: the ids [256, 16] of the
    neighbour lists of 256 nodes of the top graph index (the workload's
    top-index queries on their bucket), beside its plain version and its
    bound."""
    import torch

    from repro_torch.core import EMPTY_KEY
    from repro_torch.kernels import gather_distance as gd

    qv, qls = ctx["qv"], ctx["qls"]
    ix = graph_eng.indexes[EMPTY_KEY]
    dev = ix.device
    top = [i for i, key in enumerate(graph_eng.route_many(qls))
           if key == EMPTY_KEY]
    b = 1 << max(len(top) - 1, 0).bit_length()
    qp = torch.zeros((b, qv.shape[1]), dtype=torch.float32, device=dev)
    qp[:len(top)] = torch.from_numpy(qv[top]).to(dev)
    nodes = np.random.default_rng(seed).integers(0, ix.num_vectors, b)
    ids = torch.from_numpy(ix.adjacency[nodes]).to(dev)
    kv = gd.gather_distance(qp, ix._xb, ids)
    pv = gd.gather_distance_plain(qp, ix._xb, ids)
    err = _compare(kv, None, pv, None, integer=False, int8=False,
                   tag="gather_distance at the hop's shape")
    ms = clock.ms(lambda: gd.gather_distance(qp, ix._xb, ids))
    plain_ms = clock.ms(lambda: gd.gather_distance_plain(qp, ix._xb, ids),
                        max_reps=10)
    Q, D = qp.shape
    pairs = int((ids >= 0).sum())
    nbytes = 4 * (pairs * D + ids.numel() + Q * D + kv.numel())
    bound_ms, bound_by = _bound(nbytes, pairs * 3 * D)
    return [dict(
        name="gather_distance", route="cuda",
        source="src/repro_torch/csrc/gather_distance.cu",
        replaces="src/repro/kernels/gather_distance.py:163",
        launches=launches["gather_distance"],
        max_abs_err=max(err, errs["gather_distance"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=len(top), q_bucket=Q, ids_per_query=ids.shape[1],
                   dim=D, index_rows=ix.num_vectors, pairs=pairs))]


# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (needs "
              "src/repro_torch beside this file)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import masked_distance as md

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    props = torch.cuda.get_device_properties(dev)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, sms=props.multi_processor_count,
         smem_per_block=getattr(props, "shared_memory_per_block", None),
         smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", None),
         threads_per_sm=props.max_threads_per_multi_processor)

    clock = Clock(dev)
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        build = pool.submit(cuda_build.build)
        # the host generates the paper-scale data while nvcc runs
        data = paper_data(PAPER["n_vectors"])
        t_data = time.perf_counter() - t0
        seconds = build.result()
        emit("build", nvcc_seconds=seconds, data_seconds=t_data,
             phase_seconds=time.perf_counter() - t0,
             ptxas=sorted({line.split(":", 1)[1].strip()
                           for name in cuda_build.SOURCES
                           for line in (cuda_build.BUILD_DIR / f"{name}.log")
                           .read_text().splitlines() if "Used" in line}))

    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    dense = dense_kernel_checks(dev)
    checks["cases"] += dense["cases"]
    checks["max_abs_err"].update(dense["max_abs_err"])
    checks["dense_tolerance"] = dense["tolerance"]
    hop = graph_kernel_checks(dev)
    checks["cases"] += hop["cases"]
    checks["max_abs_err"].update(hop["max_abs_err"])
    checks["gather_distance_tolerance"] = hop["tolerance"]
    checks["gather_distance_random_bitwise"] = hop["random_bitwise"]
    emit("kernels_vs_plain", seconds=time.perf_counter() - t0, **checks)
    t0 = time.perf_counter()
    emit("graph_build_vs_plain", **graph_build_checks(dev),
         seconds=time.perf_counter() - t0)

    wrappers = {"fused_scan": fs.fused_segmented_scan,
                "segmented_gather_distance": gd.segmented_gather_distance,
                "masked_distance": md.masked_distance,
                "filtered_topk": ft.filtered_topk,
                "gather_distance": gd.gather_distance}

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def drive(phase, kernels_of_path, run):
        """Run one path with every launch count set to 0 just before it
        and read just after; each kernel of the path must have launched."""
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run()
        got = counts()
        emit(phase, seconds=time.perf_counter() - t0, launches=got)
        for name in kernels_of_path:
            if got[name] <= 0:
                raise AssertionError(f"{phase} never launched {name}")
        return out, got

    (results, engines, ctx), at_flat = drive(
        "main_path", ("fused_scan", "segmented_gather_distance"),
        lambda: main_path(dev, data=data, data_seconds=t_data, counts=counts,
                          clock=clock))
    (_, ivf_eng), at_ivf = drive(
        "ivf_path", ("masked_distance",),
        lambda: ivf_path(dev, data=data, ctx=ctx, counts=counts, clock=clock))
    (_, flat), at_scan = drive(
        "flat_scan_path", ("filtered_topk",),
        lambda: flat_scan_path(dev, data=data, ctx=ctx, counts=counts,
                               clock=clock))
    (_, graph_eng), at_graph = drive(
        "graph_path", ("gather_distance", "masked_distance"),
        lambda: graph_path(dev, data=data, counts=counts, clock=clock))
    launches = dict(at_flat)
    for name in ("masked_distance", "filtered_topk"):
        launches[name] = at_ivf[name] + at_scan[name]
    launches["gather_distance"] = at_graph["gather_distance"]

    t0 = time.perf_counter()
    kernels = time_kernels(engines, (ctx["qv"], ctx["qls"]), clock, launches,
                           checks["max_abs_err"])
    kernels += time_dense_kernels(ivf_eng, flat, ctx, clock, launches,
                                  checks["max_abs_err"])
    kernels += time_graph_kernel(graph_eng, ctx, clock, launches,
                                 checks["max_abs_err"])
    emit("kernel_times", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(smi, flush=True)
    emit("total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
