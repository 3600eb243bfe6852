#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one JSON line each on standard output:

  1. device  — the card, its power limit; TF32 off for matmuls and cuDNN;
  2. build   — nvcc builds every kernel of ``src/repro_torch/csrc`` into
     ``build/`` (one compiler per source, all started together, while the
     host generates the data); ``-Xptxas -v``'s registers, spills and
     shared memory of the redesigned B1, B2 (tile), B3 (five instances
     and two merges), B4 and B6 instances and of the graph walk, and
     their blocks' dynamic shared memory (B1's, B2's, B3's and the walk's
     held against their Python mirrors; B3's blocks an SM on the card at
     least those its span split counts);
  3. kernels — each kernel against its plain torch version on the card.
     The segmented kernels: f32 / fp16 / int8, l2 / ip, tombstones on and
     off, ragged and empty segments, a tail segment, k' > lmax; the fused
     scan also on runs of queries that share a segment beside singletons
     and a run whose segment runs past the end of the row table, at query
     tiles 1, 8 and 64, which must agree bitwise, and on the streaming
     delta's shape (every query's segment [0, count) of an identity row
     table, count no multiple of the span, tombstones in the run's tail
     and past count; no dead or out-of-run slot returned); the segmented gather
     also on runs of queries that list one window (a run of 70 across the
     64-query tile, ragged lens, runs of 9, 3 and 2) beside singletons, its
     tile schedule at 64, 16 and 12 queries a block (runs cut at the
     blocks' edges) bitwise its per-pair schedule (``max_qtile=1``) and
     both bitwise the same sum taken in order by torch.  The dense
     kernels (masked_distance, filtered_topk): l2 / ip, N not a multiple
     of the row tile, ragged Q, both kernels at Q 1, 16, 17, 32, 33, 64,
     65, 128 and 256 (the edges of their instances), D 127 and operands at
     an unaligned base (the tile's 4-byte copies), the empty query mask, an
     empty filter, k 1, 10, 32, 33, 100 and 256 (both pool capacities),
     k > N, a tombstone bitmap, filtered_topk's values bitwise
     masked_distance's, rows in descending distance order for every
     query (each row beats the threshold: every tile admits all its rows
     and overflows the k > 32 buffers), two planted faults in
     filtered_topk (only a ballot's first
     survivor enters; the threshold read one slot early) that must fail
     it, and the same query rows bitwise equal at buckets 1, 8 and 256.
     The graph's per-hop gather_distance: l2 / ip, ids < 0, D = 128 and
     100, Q = 1 and
     batches, buckets 1 / 8 / 256; the graph walk kernel (graph_walk)
     against the torch hop loop, every lane's dists, ids, hops and
     distance computations bitwise, on graphs of 4,099 rows (D 37, M 8
     and 16) and 20,011 rows (D 128, M 16) over integer and random rows,
     l2 / ip, pre / post, tombstones on and off, ef k / 64 (256 for two
     of those), three entries a lane with -1 among them and a pad lane,
     and two planted faults (ties merged the wrong way, a lane stopped
     one hop early) that must fail it; the decode attention
     flash_decode: f32
     and bf16, minitron's GQA (24 heads over 8), MQA and MHA, Dh 128 / 64 /
     16, S 1 / 127 / 4,096 / 32,768, lengths 1, S and random, poisoned
     slots past the length (bitwise no change) and rows bitwise equal at
     B = 1, 7 and 128 (rtol = atol 1e-5 in f32; rtol 2^-6, two to four bf16
     ulps, atol 1e-5 in bf16), and a planted fault (the plain version
     with the last of 64 splits skipped) that the check must reject; and
     the card
     build of the graph against
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
     search_padded sliced, warm QPS and p50/p99; after its launch counts
     are read, k = 100 against its plain version (up to boundary ties);
  4d. the ``graph`` backend (M 16, n_cand 64, α 1.2, ef 64, post) over
     the data's first 100,000 rows (raised along 200k / 500k / 10^6 while
     a build takes under 30 s and the phase fits its ~5 minutes) with its
     own selection: build seconds by stage, batched == looped on 200
     queries, ``"cuda"`` (the walk kernel, one launch a routed group, no
     gather_distance) == ``"ref"`` (the torch hop loop) bitwise on 82
     queries with their hops and distance computations, and on the whole
     batch with the hops and distance computations of the first 200,
     every result passing its filter, every degree <= M; recall@10, QPS,
     p50/p99, hops and distance computations reported.
  4e. minitron_4b at full width (4.19 B parameters, bf16, initialized on
     the card from a seeded generator) served by a BatchedDecoder with 8
     slots and max_len 2,048: 16 requests, prompts of 64–512 tokens,
     max_new 32.  Gates: every request complete, flash_decode launched
     once per layer per decode step, batched == sequential tokens for 4
     requests, and, in the first decode step of 8 admitted requests, each
     layer's kernel output against the plain version on the same inputs
     (phase 3's tolerance), and the step's logits against the plain
     attention's within 5% of the largest logit; a planted fault (the
     token just written left out) must fail both, and the plain attention
     with bf16 softmax weights is reported beside them.  Reported:
     prefill ms, decode ms per step p50/p99, generated tokens/s, weight
     and KV-cache bytes.
  4f. (run after 4d, before 4e) streaming at the paper's scale: two
     ``StreamingEngine``s (f32 and int8+rerank, fused) on phase 4's table
     and selection, ten rounds of 10,000 inserts (the paper's generator,
     another seed), 5,000 deletes (4,000 base, 1,000 inserted) and the
     1,000-query batch — 100,000 delta rows (capacity tier 131,072) and
     50,000 tombstones pending, under both 0.25 compaction thresholds —
     then a flush.  Gates: no threshold fired; recall@10 >= 0.999 against
     the survivors' exact float64 top-k and no dead id; flushed ==
     pending through the ``id_map`` (bitwise for f32, ROADMAP C3's tier
     for int8+rerank); ``"cuda"`` == ``"ref"`` on 82 queries at phase 3's
     tier for random rows (values allclose, ids up to ties: the plain
     versions sum with torch's reductions), bitwise rows counted.
     Reported: warm QPS pending and after the flush beside phase 4's
     static QPS, p50/p99 of 32-query batches, inserted rows/s, deleted
     ids/s, flush seconds, launches per batch (base tiers and the delta),
     the delta's capacity and bytes.  Then phase 4b's ivf engine in a
     stream with 50,000 base deletes pending: no dead id, ``"cuda"`` ==
     ``"ref"`` up to ties, QPS.  The phase must launch fused_scan,
     segmented_gather_distance and masked_distance;
     Every launch count is set to 0 just before each of 4, 4b, 4c, 4d, 4f
     and 4e and read just after; each kernel of that path must have
     launched;
  5. each kernel timed at its path's top-tier shapes beside its plain
     version and its bound (the dense kernels' and B1's and B2's
     operations counted over the pairs that pass the filter;
     gather_distance at one hop: [256, 16] ids;
     the graph walk over the top graph index's 256-lane bucket beside
     the torch hop loop;
     flash_decode at the decode_32k cell, B 128 × S 32,768 with
     minitron's heads, beside scaled_dot_product_attention; checked
     against the plain version, planted fault rejected, as in phase 3);
     the fused scan also at the tier with the most queries alone in
     their segment, both tiers beside the one-query-per-block schedule
     (bitwise equal); the segmented gather at the top tier's first chunk
     and at the (Q, L) one unfused f32 batch launches most often, each
     beside ``max_qtile=1`` (bitwise equal), a sweep of run lengths 1–64
     (tile against per-pair), and every (Q, L) launch of one unfused f32
     and one int8+rerank batch in both schedules, summed over the batch;
     masked_distance also at the (Q, N) one
     ivf batch launches most often; filtered_topk also at the 32-query
     latency batch ([32, N], k 10) and at k 100 and 256 ([1024, N]), each
     checked against the plain version, beside masked_distance at its
     [1024, N] (the same tile; the yardstick); the card's clocks, power
     and temperature after each.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and the contract line
``{"ok": true, "device": {...}}`` last.  Any failure raises and exits
non-zero; without a card, or without the repository's ``src/repro_torch``
beside this file, it exits non-zero before doing anything.
"""
from __future__ import annotations

import copy
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

# the fused scan's query tiles held against each other and the plain
# version: one query per block, tiles of 8 (a shared run split across
# tiles) and the largest tile
FUSED_QTILES = (1, 8, 64)

# filtered_topk's k in the checks: both pool capacities (32, 256), their
# edge and the main path's 10
FILTERED_TOPK_KS = (1, 10, 32, 33, 100, 256)

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
    runs = gather_run_checks(dev, N=N, D=D, W=W)
    errs = {"fused_scan": 0.0, "segmented_gather_distance": runs["max_abs_err"]}
    cases = runs["cases"]
    for integer in (True, False):
        for dtype in ("f32", "fp16", "int8"):
            A = _arena(dtype, N, D, W, integer, rng, dev)
            q, lq = _queries(Q, D, W, integer, rng, dev)
            R = 3 * lmax
            rc = torch.from_numpy(rng.integers(0, N, R).astype(np.int32)).to(dev)
            starts = rng.integers(0, R - lmax, Q).astype(np.int32)
            lens = rng.integers(0, lmax + 1, Q).astype(np.int32)
            lens[::5] = 0
            # runs of queries that share a segment beside singletons: a
            # run a query tile scans together, a run of 3 (scanned query
            # by query), a run whose segment runs past the end of R (its
            # tail lanes read row R − 1), and a tail segment
            run = max(5, Q // 3)
            starts[:run], lens[:run] = starts[0], lmax - 3
            starts[run:run + 3], lens[run:run + 3] = starts[run], lens[run]
            starts[Q - 6:Q - 1], lens[Q - 6:Q - 1] = R - 300, 700
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
                        pv, pp = fs.fused_scan_plain(
                            *args, kp=kp, lmax=lm, chunk=min(lm, 512),
                            qtile=16, metric=metric, dtype=dtype)
                        first = None
                        for qtile in FUSED_QTILES:
                            tag = (f"fused {dtype} {metric} tomb="
                                   f"{tomb is not None} kp={kp} span={span} "
                                   f"qtile={qtile} int={integer}")
                            kv, kp_ = fs.fused_scan_cuda(
                                *args, kp=kp, lmax=lm, span=span,
                                qtile=qtile, metric=metric, dtype=dtype)
                            errs["fused_scan"] = max(
                                errs["fused_scan"],
                                _compare(kv, kp_, pv, pp, integer=integer,
                                         int8=int8, tag=tag))
                            # every value is a function of its (query, row)
                            # pair: the query tile changes no bit
                            if first is None:
                                first = (kv, kp_)
                            elif not (torch.equal(kv, first[0])
                                      and torch.equal(kp_, first[1])):
                                raise AssertionError(f"{tag}: differs from "
                                                     f"query tile 1")
                            cases += 1
    # the streaming delta's shape: every query's segment is [0, count) of
    # an identity row table over the capacity tier — one run all queries
    # share — with count no multiple of the span and tombstones in the
    # run's tail and past count (the tile model's span and 256)
    from repro_torch.index.base import pack_tombstones
    from repro_torch.launch import roofline

    cap, count = 4 * lmax, 3 * lmax + 77
    ident = torch.arange(cap, dtype=torch.int32, device=dev)
    for integer in (True, False):
        for dtype in ("f32", "int8"):
            A = _arena(dtype, cap, D, W, integer, rng, dev)
            q, lq = _queries(Q, D, W, integer, rng, dev)
            dead = rng.random(cap) < 0.05
            tail = slice(count - 300, min(cap, count + 200))
            dead[tail] = rng.random(tail.stop - tail.start) < 0.5
            tomb = torch.from_numpy(pack_tombstones(dead)).to(dev)
            starts = torch.zeros(Q, dtype=torch.int32, device=dev)
            lens = torch.full((Q,), count, dtype=torch.int32, device=dev)
            tc = roofline.fused_scan_tiles(D, cap, dtype, Q, backend="cuda",
                                           device=dev)
            for metric in ("l2", "ip"):
                args = (q, lq, A["ax"], A["alw"], A["axn"], ident, starts,
                        lens, tomb, A["scales"], A["zeros"])
                pv, pp = fs.fused_scan_plain(
                    *args, kp=10, lmax=cap, chunk=512, qtile=16,
                    metric=metric, dtype=dtype)
                first = None
                for span in sorted({256, tc.rows_per_chunk}):
                    for qtile in FUSED_QTILES:
                        tag = (f"fused delta {dtype} {metric} span={span} "
                               f"qtile={qtile} int={integer}")
                        kv, kp_ = fs.fused_scan_cuda(
                            *args, kp=10, lmax=cap, span=span, qtile=qtile,
                            metric=metric, dtype=dtype)
                        errs["fused_scan"] = max(
                            errs["fused_scan"],
                            _compare(kv, kp_, pv, pp, integer=integer,
                                     int8=dtype == "int8", tag=tag))
                        live = kp_[torch.isfinite(kv)].long().cpu().numpy()
                        if (live >= count).any() or dead[live].any():
                            raise AssertionError(f"{tag}: a dead or "
                                                 f"out-of-run slot")
                        if first is None:
                            first = (kv, kp_)
                        elif not (torch.equal(kv, first[0])
                                  and torch.equal(kp_, first[1])):
                            raise AssertionError(f"{tag}: differs from "
                                                 f"the first schedule")
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
    return dict(cases=cases, gather_run_cases=runs["cases"],
                max_abs_err=errs,
                tolerance=f"integer data: bitwise; random data and int8: "
                          f"rtol {RTOL} atol {ATOL}, positions up to ties; "
                          f"fused_scan at query tiles {FUSED_QTILES} and "
                          f"segmented_gather_distance at max_qtile "
                          f"{GATHER_QTILES}: bitwise equal")


# B2's schedules held against each other: the model's tile (64 queries a
# block), tiles of 16 and 12 (the shared runs cut at other block edges,
# into tiled pieces of more than TILE_MIN_RUN and per-pair ones) and one
# thread per pair
GATHER_QTILES = (None, 16, 12, 1)


def _gather_in_order(q, lq, x, lxw, gids, lens, *, metric, scales=None,
                     zeros=None):
    """B2's function summed as its kernel sums it: in order over D, each
    product, difference and sum rounded on its own (one torch operation
    each, never fused), int8 codes dequantized as zeros + scales·codes.
    Both of the kernel's schedules must agree with it bitwise on any
    data."""
    import torch
    g = gids.long()
    xr = x[g].float()
    if x.dtype == torch.uint8:
        xr = zeros[g][..., None] + scales[g][..., None] * xr
    acc = torch.zeros(gids.shape, dtype=torch.float32, device=q.device)
    for e in range(q.shape[1]):
        if metric == "ip":
            acc = acc + xr[..., e] * q[:, None, e]
        else:
            t = q[:, None, e] - xr[..., e]
            acc = acc + t * t
    ok = torch.all((lq[:, None, :] & lxw[g]) == lq[:, None, :], dim=-1)
    ok &= (torch.arange(gids.shape[1], device=q.device)[None, :]
           < lens[:, None])
    return torch.where(ok, -acc if metric == "ip" else acc,
                       torch.full_like(acc, float("inf")))


def gather_run_checks(dev, *, N=32768, D=128, W=4, Q=96, L=20_000,
                      seed=3):
    """B2 on windows that runs of queries share, beside singletons and
    scattered per-query lists (as the +rerank shortlists are): f32 / fp16
    / int8, l2 / ip, integer and random data, a run of 70 across the
    64-query tile with ragged lens (one 0 inside it), runs of 9, 3 and 2
    (the tile takes runs of more than ``TILE_MIN_RUN``, 8), L not a
    multiple of the 128-column window and long enough that the tile
    grid fills the card (else the model takes one thread a pair), at
    ``GATHER_QTILES`` queries a block, so the runs are cut at different
    block edges into tiled pieces and per-pair ones (at 12 the run of 9
    becomes a 2 and a 7, both per pair).  Every schedule bitwise
    equal to ``max_qtile=1`` and to the in-order sum; against the plain
    version, phase 3's tolerance, except int8 on integer data: its
    dequantized rows are not integers and its ip sums cancel terms of
    ~10^3 to values near 0, where the two summation orders differ by more
    than the absolute floor (the in-order sum holds it bitwise instead)."""
    import torch

    from repro_torch.kernels import gather_distance as gd

    rng = np.random.default_rng(seed)
    err, cases = 0.0, 0
    for integer in (True, False):
        for dtype in ("f32", "fp16", "int8"):
            A = _arena(dtype, N, D, W, integer, rng, dev)
            q, lq = _queries(Q, D, W, integer, rng, dev)
            g = rng.integers(0, N, (Q, L)).astype(np.int32)
            g[1:70] = g[0]
            g[71:79] = g[70]
            g[80:82] = g[79]
            g[83] = g[82]
            lens = np.full(Q, L, np.int32)
            lens[5:40:7] = rng.integers(1, L, 5)
            lens[20], lens[71], lens[80], lens[-1] = 0, 129, 300, 7
            gids = torch.from_numpy(g).to(dev)
            lens = torch.from_numpy(lens).to(dev)
            for metric in ("l2", "ip"):
                args = (q, lq, A["ax"], A["alw"], gids, lens)
                kw = dict(metric=metric, scales=A["scales"], zeros=A["zeros"])
                one = gd.segmented_gather_distance(*args, **kw, max_qtile=1)
                if not torch.equal(one, _gather_in_order(*args, **kw)):
                    raise AssertionError(f"gather runs {dtype} {metric} "
                                         f"int={integer}: the per-pair "
                                         f"schedule is not the in-order sum")
                if not (integer and dtype == "int8"):
                    err = max(err, _compare(
                        one, None, gd.segmented_gather_distance_plain(
                            *args, **kw), None, integer=integer,
                        int8=dtype == "int8",
                        tag=f"gather runs {dtype} {metric} int={integer}"))
                for mq in GATHER_QTILES:
                    if mq != 1 and dtype != "int8" and gd.gather_qtile(
                            Q, L, storage=dtype, sms=gd._sms(dev),
                            max_qtile=mq) == 1:
                        raise AssertionError(f"gather runs at max_qtile="
                                             f"{mq}: the model takes one "
                                             f"thread a pair; raise L")
                    kv = gd.segmented_gather_distance(*args, **kw,
                                                      max_qtile=mq)
                    if not torch.equal(kv, one):
                        raise AssertionError(
                            f"gather runs {dtype} {metric} int={integer} "
                            f"max_qtile={mq}: differs from the per-pair "
                            f"schedule")
                    cases += 1
    return dict(cases=cases, max_abs_err=err)


def dense_kernel_checks(dev, *, N=20011, D=128, W=4, seed=2):
    """The dense kernels (masked_distance, filtered_topk) against their
    plain versions: l2 / ip, N not a multiple of the row tile, ragged Q
    (5 and 37 queries), the empty query mask, an empty filter (a label no
    row holds), a label in the last word (filtered_topk tests only the
    words up to the last one its block's queries set), k = 1, 10, 32,
    33, 100 and 256 (both pool capacities and their edge), k > N, a
    tombstone bitmap (``ops.filtered_topk``'s
    composed path); masked_distance at Q 1, 16, 17, 32, 33, 64, 65, 128
    and 256 (the edges of its instances and of filtered_topk's), and at D
    127 and on operands at an unaligned base (the tile's 4-byte copies);
    filtered_topk's values bitwise those of masked_distance at k 10 and
    100; rows in descending distance order for every query, so that
    every row beats the threshold (every tile admits all its rows and
    overflows the k > 32 buffers; bitwise); filtered_topk's two planted
    faults, which must
    fail the check; and the same query rows bitwise equal at buckets 1, 8
    and 256."""
    import torch

    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md
    from repro_torch.kernels import ops
    from repro_torch.kernels.filtered_topk import masked_topk_tail

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
                # a label in the last word: B3's first query tile tests
                # every word, at Q 37 its second only the first
                lq[1, W - 1] = 1
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
                    for k in FILTERED_TOPK_KS:
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
    # every instance and its edges: Q 1 and 16 (16 × 128), 17 and 64
    # (64 × 128), 65, 128 and 256 (128 × 64), N not a multiple of the row
    # tile; B3 at the same Q holds B4's values bitwise
    for integer in (True, False):
        x = rng.standard_normal((N, D)).astype(np.float32)
        if integer:
            x = np.rint(x * 4).astype(np.float32)
        x = t(x)
        lx = t((rng.random((N, W)) < 0.7).astype(np.int32))
        for Q in (1, 16, 17, 32, 33, 64, 65, 128, 256):
            q, lq = _queries(Q, D, W, integer, rng, dev)
            for metric in ("l2", "ip"):
                tag = f"masked_distance Q={Q} {metric} int={integer}"
                kd = md.masked_distance(q, x, lq, lx, metric=metric)
                pd = md.masked_distance_plain(q, x, lq, lx, metric=metric)
                errs["masked_distance"] = max(
                    errs["masked_distance"],
                    _compare(kd, None, pd, None, integer=integer, int8=False,
                             tag=tag))
                for k in (10, 100):   # both pool capacities' instances
                    kv, ki = ft.filtered_topk(q, x, lq, lx, k=k,
                                              metric=metric)
                    pv, pi = masked_topk_tail(pd, None, N, k=k)
                    errs["filtered_topk"] = max(
                        errs["filtered_topk"],
                        _compare(kv, ki, pv, pi, integer=integer, int8=False,
                                 tag=f"filtered_topk Q={Q} k={k} {metric} "
                                     f"int={integer}"))
                    fin = torch.isfinite(kv)
                    at = torch.gather(kd, 1,
                                      torch.clamp(ki, max=N - 1).long())
                    if not torch.equal(at[fin], kv[fin]):
                        raise AssertionError(f"{tag} k={k}: filtered_topk "
                                             f"disagrees with "
                                             f"masked_distance")
                    cases += 1
    # the tile's 4-byte copies: D 127 (D % 4 != 0), and D 128 in
    # contiguous views one float into their buffers (bases not 16-byte
    # aligned), at Q 1, 17 and 65 (one query tile of each instance)
    def shifted(a, off):
        v = torch.empty(a.numel() + off, dtype=a.dtype, device=dev)[off:]
        return v.view(a.shape).copy_(a)
    for integer in (True, False):
        for d_, off in ((127, 0), (D, 1)):
            x = rng.standard_normal((N, d_)).astype(np.float32)
            if integer:
                x = np.rint(x * 4).astype(np.float32)
            x = shifted(t(x), off)
            lx = t((rng.random((N, W)) < 0.7).astype(np.int32))
            qa, lqa = _queries(65, d_, W, integer, rng, dev)
            qa = shifted(qa, off)
            if off and (x.data_ptr() % 16 == 0 or qa.data_ptr() % 16 == 0):
                raise AssertionError("the shifted operands are aligned")
            for Q in (1, 17, 65):
                q, lq = qa[:Q], lqa[:Q]
                for metric in ("l2", "ip"):
                    tag = (f"masked_distance D={d_} offset={off} Q={Q} "
                           f"{metric} int={integer}")
                    kd = md.masked_distance(q, x, lq, lx, metric=metric)
                    errs["masked_distance"] = max(
                        errs["masked_distance"],
                        _compare(kd, None,
                                 md.masked_distance_plain(q, x, lq, lx,
                                                          metric=metric),
                                 None, integer=integer, int8=False, tag=tag))
                    kv, ki = ft.filtered_topk(q, x, lq, lx, k=10,
                                              metric=metric)
                    fin = torch.isfinite(kv)
                    at = torch.gather(kd, 1,
                                      torch.clamp(ki, max=N - 1).long())
                    if not torch.equal(at[fin], kv[fin]):
                        raise AssertionError(f"{tag}: filtered_topk "
                                             f"disagrees with masked_distance")
                    cases += 1
    out = _filtered_topk_overflow_and_faults(dev, N=N, D=D, W=W, rng=rng)
    cases += out.pop("cases")
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
    return dict(cases=cases, max_abs_err=errs, filtered_topk=out,
                tolerance=f"integer data: bitwise; random data: rtol {RTOL} "
                          f"atol {ATOL}, positions up to ties; buckets 1 / 8 "
                          f"/ 256: bitwise")


def _filtered_topk_overflow_and_faults(dev, *, N, D, W, rng):
    """filtered_topk on rows in descending distance order for every query
    (l2: zero queries and ‖x_j‖² = (N − j)²; ip: queries e_0 and x_j[0] =
    j + 1), every row passing every filter: each row beats its query's
    threshold, so every tile admits all its rows (and overflows the k > 32
    buffers); integer values, held bitwise at Q 5 and 200 for k 10, 32,
    100 and 256.  Then
    the planted faults (``ft.PLANTED_FAULTS``) at Q 200, k 10, on those
    rows, on integer random rows and on rows that arrive at rank k − 1 of
    the pool (l2, zero queries: rows 0–8 nearest, rows 9–127 in
    descending order behind them, inside the first span, which is at
    least 128 rows; every other row far): each must change at least one
    query's result, where the shipped kernel changes none."""
    import torch

    from repro_torch.kernels import filtered_topk as ft

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = 0
    lx = t(np.ones((N, W), np.int32))
    desc = {}
    for metric in ("l2", "ip"):
        x = np.zeros((N, D), np.float32)
        x[:, 0] = (np.arange(N, 0, -1) if metric == "l2"
                   else np.arange(1, N + 1))
        q = np.zeros((200, D), np.float32)
        if metric == "ip":
            q[:, 0] = 1.0
        desc[metric] = (t(q), t(x), t(np.zeros((200, W), np.int32)), lx)
        for Q in (5, 200):
            args = tuple(a[:Q] if i in (0, 2) else a
                         for i, a in enumerate(desc[metric]))
            for k in (10, 32, 100, 256):
                kv, ki = ft.filtered_topk(*args, k=k, metric=metric)
                pv, pi = ft.filtered_topk_plain(*args, k=k, metric=metric)
                _compare(kv, ki, pv, pi, integer=True, int8=False,
                         tag=f"filtered_topk descending rows Q={Q} k={k} "
                             f"{metric}")
                if not torch.equal(ki[:, 0], torch.full_like(ki[:, 0],
                                                             N - 1)):
                    raise AssertionError("descending rows: the last row is "
                                         "not first")
                cases += 1
    xr = np.rint(rng.standard_normal((N, D)) * 4).astype(np.float32)
    lxr = t((rng.random((N, W)) < 0.7).astype(np.int32))
    qr, lqr = _queries(200, D, W, True, rng, dev)
    xk = np.zeros((N, D), np.float32)
    xk[:, 0] = 1000 + np.arange(N)
    xk[:9, 0] = np.arange(9)
    xk[9:128, 0] = 9 + np.arange(128 - 9, 0, -1)
    inputs = {"descending rows, l2": (desc["l2"], "l2"),
              "rows at rank k - 1, l2": ((desc["l2"][0], t(xk),
                                          desc["l2"][2], lx), "l2"),
              "integer random rows, l2": ((qr, t(xr), lqr, lxr), "l2"),
              "integer random rows, ip": ((qr, t(xr), lqr, lxr), "ip")}
    changed = {}
    for fault in ft.PLANTED_FAULTS:
        for name, (args, metric) in inputs.items():
            pv, pi = ft.filtered_topk_plain(*args, k=10, metric=metric)
            for planted in (False, True):
                kv, ki = (ft.filtered_topk_planted(*args, k=10,
                                                   metric=metric, fault=fault)
                          if planted else ft.filtered_topk(*args, k=10,
                                                           metric=metric))
                same = (kv == pv).all(1) & (ki == pi).all(1)
                n_changed = int((~same).sum())
                if planted:
                    changed[f"fault {fault} on {name}"] = n_changed
                elif n_changed:
                    raise AssertionError(f"filtered_topk on {name}: "
                                         f"{n_changed} queries differ")
            cases += 1
        if not any(n for key, n in changed.items()
                   if key.startswith(f"fault {fault} ")):
            raise AssertionError(f"filtered_topk planted fault {fault} "
                                 f"({ft.PLANTED_FAULTS[fault]}) passed the "
                                 f"check")
    return dict(cases=cases, planted_fault_queries_changed=changed)


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


# the walk kernel's checks: (rows, D, M) of each graph (D 37: the
# staging's 4-byte copies; D 128: its 16-byte copies), and the ef of each
# case ("k": ef = k); ef 256, whose torch loop walks ~4x as many hops,
# only for (metric, strategy, tombstones) in WALK_WIDE
WALK_GRAPHS = ((4099, 37, 8), (4099, 37, 16), (20011, 128, 16))
WALK_EFS = ("k", 64, 256)
WALK_WIDE = (("l2", "post", True), ("ip", "pre", False))


def _walk_equal(got, want) -> tuple[int, float]:
    """Lanes of two graph walks (dists, ids, hops, distance computations)
    that differ in any bit, and the largest absolute difference of their
    finite dists."""
    import torch
    gd, gi, gh, gc = got
    wd, wi, wh, wc = (t.to(gd.device) for t in want)
    same = ((gd.view(torch.int32) == wd.view(torch.int32)).all(1)
            & (gi == wi).all(1) & (gh == wh) & (gc == wc))
    fin = torch.isfinite(gd) & torch.isfinite(wd)
    err = float((gd - wd)[fin].abs().max()) if fin.any() else 0.0
    return int((~same).sum()), err


def graph_walk_checks(dev, *, graphs=WALK_GRAPHS, Q=64, k=10, seed=9):
    """The walk kernel (``graph_walk``) against its plain version, the
    torch hop loop, on the card: dists (every bit), ids, hops and
    distance computations of every lane equal.  Graphs built on the card
    over integer (``rint(randn·2)``: many equal distances) and random
    rows; l2 / ip, pre / post, with and without a tombstone bitmap (30%),
    ef ∈ {k, 64}, and ef 256 for the cases of ``WALK_WIDE``; each lane
    seeded at the medoid and two more entries, random or -1, and one pad
    lane (all -1).  Two planted faults must fail it: new candidates
    merged ahead of equal pool entries, and each lane stopped one hop
    early (integer graphs, l2, post, ef 64)."""
    import torch

    from repro_torch.index.base import pack_tombstones
    from repro_torch.index.graph import GraphIndex
    from repro_torch.kernels import graph_walk as gw

    rng = np.random.default_rng(seed)
    cases = lanes = hops = max_hops = 0
    err = 0.0
    faults = {name: 0 for name in gw.PLANTED_FAULTS.values()}
    W = 2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for N, D, M in graphs:
        for integer in (True, False):
            x = rng.standard_normal((N, D)).astype(np.float32)
            q = rng.standard_normal((Q, D)).astype(np.float32)
            if integer:
                x, q = np.rint(x * 2), np.rint(q * 2)
            lxw = np.zeros((N, W), np.int32)
            lxw[:, 0] = rng.integers(0, 256, N) | rng.integers(0, 256, N)
            lxw[:, 1] = rng.integers(0, 2, N)
            lq = np.zeros((Q, W), np.int32)
            lq[:, 0] = rng.integers(0, 256, Q) & rng.integers(0, 256, Q) \
                & rng.integers(0, 256, Q)
            lq[: Q // 4, 1] = 1
            base = GraphIndex(x, lxw, M=M, n_cand=32, device=dev)
            ent = np.full((Q, 3), -1, np.int64)
            ent[:, 0] = base.medoid
            ent[:, 1:] = rng.integers(-N // 2, N, (Q, 2))
            ent[ent < 0] = -1
            ent[-1] = -1                                    # a pad lane
            tomb = t(pack_tombstones(rng.random(N) < 0.3))
            qd, lqd, entd = t(q), t(lq), t(ent)
            for metric in ("l2", "ip"):
                ix = base if metric == "l2" else GraphIndex(
                    x, lxw, metric="ip", M=M, adjacency=base.adjacency,
                    medoid=base.medoid, device=dev)
                args = (qd, lqd, entd, ix._xb, ix._adj_ext, ix._lxw_ext)
                for strategy in ("post", "pre"):
                    for tb in (None, tomb):
                        for ef in WALK_EFS:
                            ef = k if ef == "k" else ef
                            if ef == 256 and (metric, strategy, tb is not
                                              None) not in WALK_WIDE:
                                continue
                            kw = dict(k=k, ef=ef, metric=metric,
                                      strategy=strategy)
                            want = gw.graph_walk_plain(*args, tb, **kw)
                            got = gw.graph_walk(*args, tb, **kw)
                            tag = (f"graph_walk N={N} D={D} M={M} int="
                                   f"{integer} {metric} {strategy} tomb="
                                   f"{tb is not None} ef={ef}")
                            bad, e = _walk_equal(got, want)
                            err = max(err, e)
                            if bad:
                                raise AssertionError(f"{tag}: {bad} of {Q} "
                                                     f"lanes differ")
                            if int(got[2][-1]) != 0 or int(got[3][-1]) != 0:
                                raise AssertionError(f"{tag}: the pad lane "
                                                     f"walked")
                            cases += 1
                            lanes += Q
                            hops += int(got[2].sum())
                            max_hops = max(max_hops, int(got[2].max()))
                            if integer and metric == "l2" and \
                                    strategy == "post" and tb is None \
                                    and ef == 64:
                                for code, name in gw.PLANTED_FAULTS.items():
                                    faults[name] += _walk_equal(
                                        gw.graph_walk_planted(
                                            *args, tb, **kw, fault=code),
                                        want)[0]
    for name, bad in faults.items():
        if bad == 0:
            raise AssertionError(f"graph_walk: the planted fault ({name}) "
                                 f"was not caught")
    return dict(cases=cases, lanes=lanes, hops=hops, max_hops=max_hops,
                planted_fault_lanes_differing=faults,
                max_abs_err={"graph_walk": err},
                tolerance="every lane bitwise: dists, ids, hops and "
                          "distance computations")


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


# flash_decode against its plain version, (rtol, atol) by dtype.  Both
# compute in f32 from the same inputs and round once to the output dtype,
# so they differ by f32 rounding (~1e-7 relative) and, in bf16, by at most
# one ulp where the two f32 values straddle a rounding point: rtol 2^-6 is
# two to four bf16 ulps of |plain|.  A split of 64 left out at S = 32,768
# moves a typical output (√(e/S) ≈ 0.009) by ~1e-3, ~12% of its size.
DECODE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 1e-5)}


def decode_tol_ratio(got, want) -> float:
    """max |got − want| / (atol + rtol·|want|) at ``want``'s dtype's
    ``DECODE_TOL``: the check passes at ≤ 1."""
    rtol, atol = DECODE_TOL[str(want.dtype).split(".")[1]]
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def dropped_split(q, k, v, lens):
    """A planted fault: the plain version of a kernel that skips the last
    live split of each row (the rows' slots past ``lens − split_len(S)``
    left out)."""
    from repro_torch.kernels import flash_decode as fd
    sl = fd.split_len(k.shape[1])
    short = (lens - ((lens - 1) % sl + 1)).clamp(min=1)
    return fd.flash_decode_plain(q, k, v, short)


def flash_decode_checks(dev, *, long_s=32_768, mid_s=4096, batch=128,
                        seed=7):
    """B6 (flash_decode) against its plain version, ``ref.
    decode_attention_ref``: f32 and bf16; minitron's GQA (24 heads over
    8), MQA and MHA; Dh 128, 64 and 16; S 1, 127, 4,096 and ``long_s``;
    lengths 1, S and random; slots past the length poisoned with ±1e4
    (bitwise no change); the same rows bitwise equal at B = 1, 7 and
    ``batch``; and, at ``long_s`` with lengths = S, a planted fault (the
    last of the 64 splits skipped) that the check must reject."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def lengths_for(S, B):
        r = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        r[0], r[-1] = 1, S
        return r.to(torch.int32)

    ratio = {"float32": 0.0, "bfloat16": 0.0}

    def check(q, k, v, lens, tag):
        kv = fd.flash_decode(q, k, v, lens)
        pv = fd.flash_decode_plain(q, k, v, lens)
        e = float((kv.float() - pv.float()).abs().max())
        r = decode_tol_ratio(kv, pv)
        if not (kv.dtype == q.dtype and kv.shape == q.shape
                and torch.isfinite(kv).all() and r <= 1.0):
            raise AssertionError(f"flash_decode {tag}: max abs err {e}, "
                                 f"{r} x the tolerance")
        name = str(q.dtype).split(".")[1]
        ratio[name] = max(ratio[name], r)
        return kv, e

    heads = {"gqa_24_8": (8, 3), "mqa_8_1": (1, 8), "mha_8_8": (8, 1)}
    err = {"float32": 0.0, "bfloat16": 0.0}
    fault = {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for hname, (KH, G) in heads.items():
            for Dh in (128, 64, 16):
                for S in (1, 127, mid_s, long_s):
                    B = 3
                    q = randn(B, KH * G, Dh, dtype=dtype)
                    k = randn(B, S, KH, Dh, dtype=dtype)
                    v = randn(B, S, KH, Dh, dtype=dtype)
                    _, e = check(q, k, v, lengths_for(S, B),
                                 f"{name} {hname} Dh={Dh} S={S}")
                    err[name] = max(err[name], e)
                    cases += 1
        # poisoning: slots at or past a row's length are never read
        KH, G, Dh, S = 8, 3, 128, mid_s
        q = randn(3, KH * G, Dh, dtype=dtype)
        k = randn(3, S, KH, Dh, dtype=dtype)
        v = randn(3, S, KH, Dh, dtype=dtype)
        lens = torch.tensor([100, 17, S - 96], dtype=torch.int32,
                            device=dev)
        base, e = check(q, k, v, lens, f"{name} before poisoning")
        for r, n in enumerate(lens.tolist()):
            k[r, n:] = 1e4 * (-1) ** r
            v[r, n:] = -1e4 * (-1) ** r
        poisoned, _ = check(q, k, v, lens, f"{name} poisoned")
        if not torch.equal(base, poisoned):
            raise AssertionError(f"flash_decode {name}: poisoned slots "
                                 f"changed the output")
        # batch invariance: row r alone, and rows 3 .. 9 as a batch of 7,
        # equal the same rows of B = 128, bitwise
        B = batch
        q = randn(B, KH * G, Dh, dtype=dtype)
        k = randn(B, S, KH, Dh, dtype=dtype)
        v = randn(B, S, KH, Dh, dtype=dtype)
        lens = lengths_for(S, B)
        full, e2 = check(q, k, v, lens, f"{name} B={B}")
        for r in sorted({0, 1, B // 2 + 13, B - 1} & set(range(B))):
            one = fd.flash_decode(q[r:r + 1].contiguous(),
                                  k[r:r + 1].contiguous(),
                                  v[r:r + 1].contiguous(),
                                  lens[r:r + 1].contiguous())
            if not torch.equal(one[0], full[r]):
                raise AssertionError(f"flash_decode {name}: row {r} at "
                                     f"B = 1 differs from B = {B}")
        seven = fd.flash_decode(q[3:10].contiguous(), k[3:10].contiguous(),
                                v[3:10].contiguous(), lens[3:10].contiguous())
        if not torch.equal(seven, full[3:10]):
            raise AssertionError(f"flash_decode {name}: rows 3 .. 9 at B = 7 "
                                 f"differ from B = {B}")
        err[name] = max(err[name], e, e2)
        # the planted fault: the last split skipped must fail the check
        KH, G, Dh, S = 8, 3, 128, long_s
        q = randn(2, KH * G, Dh, dtype=dtype)
        k = randn(2, S, KH, Dh, dtype=dtype)
        v = randn(2, S, KH, Dh, dtype=dtype)
        lens = torch.full((2,), S, dtype=torch.int32, device=dev)
        kv, e3 = check(q, k, v, lens, f"{name} lengths = S")
        pv = fd.flash_decode_plain(q, k, v, lens)
        fault[name] = decode_tol_ratio(dropped_split(q, k, v, lens), pv)
        if fault[name] <= 1.0:
            raise AssertionError(f"flash_decode {name}: the check passed a "
                                 f"split skipped ({fault[name]} x the "
                                 f"tolerance)")
        err[name] = max(err[name], e3)
        cases += 3
    return dict(cases=cases, max_abs_err={"flash_decode": max(err.values())},
                max_abs_err_by_dtype=err, tol_ratio_by_dtype=ratio,
                planted_fault_tol_ratio_by_dtype=fault,
                tolerance=f"(rtol, atol) {DECODE_TOL}; poisoned slots and "
                          f"B = 1 and 7 vs B = {batch}: bitwise; a split "
                          f"skipped at S = {long_s} rejected")


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


def _ivf_cuda_vs_ref(eng, qv, qls, k, qsel, dev, search=None):
    """The ivf engine's ``"cuda"`` results against the same indexes
    searched with ``kernel_backend="ref"`` (plain torch on the card),
    through ``search`` (default: the engine's ``search_batched``; a
    stream over it passes its own).  A query may differ only at a tie: at
    the top-k boundary (the displaced values agree within the tolerance)
    or at the probe boundary (the two backends order near-equal centroid
    distances differently)."""
    import torch

    from repro_torch.kernels import ops

    search = search or eng.search_batched
    qs, ls = qv[qsel], [qls[i] for i in qsel]
    got = search(qs, ls, k)
    for ix in eng.indexes.values():
        ix.kernel_backend = "ref"
    try:
        want = search(qs, ls, k)
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
    first_d, ids = eng.search_batched(qv, qls, k)
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


def flat_index_k100(flat, data):
    """Phase 4c's check after the path's launch counts are read: the
    FlatIndex at k = 100 (the kernel's larger pools) against its plain
    version."""
    import torch

    from repro_torch.core import encode_many, masks_to_int32_words

    _, _, qv, qls = data
    qw = masks_to_int32_words(encode_many(qls))
    plain = copy.copy(flat)
    plain.kernel_backend = "ref"
    kd, ki = flat.search(qv, qw, 100)
    pd, pi = plain.search(qv, qw, 100)
    err = _compare(torch.from_numpy(kd), torch.from_numpy(ki),
                   torch.from_numpy(pd), torch.from_numpy(pi), integer=False,
                   int8=False, tag="FlatIndex k=100 against its plain version")
    emit("flat_scan_k100", max_abs_err_vs_plain=err,
         positions_equal_to_plain=float(np.mean(ki == pi)))


GRAPH = dict(M=16, n_cand=64, alpha=1.2, ef_search=64, strategy="post")
GRAPH_ROWS = (100_000, 200_000, 500_000, 1_000_000)
GRAPH_RAISE_BELOW_S = 30.0      # raise N only if the first build is faster
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


class _OnRef:
    """Every index of a graph engine on ``kernel_backend="ref"`` (the
    torch hop loop) inside the block."""

    def __init__(self, eng):
        self.indexes = list(eng.indexes.values())

    def __enter__(self):
        for ix in self.indexes:
            ix.kernel_backend = "ref"

    def __exit__(self, *exc):
        for ix in self.indexes:
            ix.kernel_backend = "cuda"


def _graph_walk_stats(eng, qv, qls, k):
    """Per-query hops and distance computations: each routed group
    searched once through its index's ``search`` (which keeps them)."""
    from repro_torch.core import encode_many, masks_to_int32_words

    hops = np.zeros(len(qls), np.int64)
    dcs = np.zeros(len(qls), np.int64)
    by_key = {}
    for qi, key in enumerate(eng.route_many(qls)):
        by_key.setdefault(key, []).append(qi)
    qw = masks_to_int32_words(encode_many(qls))
    for key, qids in by_key.items():
        ix = eng.indexes[key]
        ix.search(qv[qids], qw[qids], k)
        hops[qids] = ix.last_stats.hops
        dcs[qids] = ix.last_stats.dist_comps
    return hops, dcs


def _graph_cuda_vs_ref(eng, qv, qls, k, qsel):
    """The graph engine's ``"cuda"`` results (the walk kernel) against the
    same graphs searched with ``kernel_backend="ref"`` (the torch hop
    loop): every selected query's dists and ids equal bit for bit, and
    its hops and distance computations."""
    import torch

    qs, ls = qv[qsel], [qls[i] for i in qsel]
    got = eng.search_batched(qs, ls, k)
    got_stats = _graph_walk_stats(eng, qs, ls, k)
    with _OnRef(eng):
        want = eng.search_batched(qs, ls, k)
        want_stats = _graph_walk_stats(eng, qs, ls, k)
    gd, gi = (torch.from_numpy(a) for a in got)
    wd, wi = (torch.from_numpy(a) for a in want)
    same = ((gd.view(torch.int32) == wd.view(torch.int32)).all(1)
            & (gi == wi).all(1))
    ties = ((gi != wi).any(1) & torch.isclose(gd, wd, rtol=RTOL,
                                              atol=ATOL).all(1))
    out = dict(queries=len(qsel), equal=int(same.sum()),
               value_ties=int((ties & ~same).sum()),
               hops_equal=int((got_stats[0] == want_stats[0]).sum()),
               dist_comps_equal=int((got_stats[1] == want_stats[1]).sum()))
    if not (out["equal"] == out["hops_equal"] == out["dist_comps_equal"]
            == len(qsel)):
        raise AssertionError(f"graph cuda vs ref: {out}")
    return out


def graph_path(dev, *, data, counts, clock):
    """Phase 4d: the engine on the ``graph`` backend (JAX defaults: M 16,
    n_cand 64, α 1.2, ef 64, PostFiltering) over the paper data's first
    100,000 rows, its own selection and the phase-4 workload; if that
    build takes under 30 s, N is raised along ``GRAPH_ROWS`` while the
    phase is predicted to stay within its budget.  Gates: batched ≡ looped on 200
    queries; ``"cuda"`` (the walk kernel) ≡ ``"ref"`` (the torch hop
    loop) bitwise, with equal hops and distance computations, on the
    first 64 queries and 32 of the top index's, and on the whole batch;
    one walk launch per routed group and no ``gather_distance``; every
    returned id passes its query's filter, every degree ≤ M.  Hops and
    distance computations are the means over the first 200 queries.
    Returns its results and engine."""
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
        # searches below, most of it the torch hop loop's, take ~60-100 s
        predicted = (time.perf_counter() - t_phase
                     + built["seconds"] * nxt / n * 1.5 + 100.0)
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
    first_d, ids = eng.search_batched(qv, qls, k)
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
    # the torch hop loop over the whole batch on the same graphs: its
    # recall, hops and distance computations must be the kernel's
    with _OnRef(eng):
        t0 = time.perf_counter()
        ref_d, ref_ids = eng.search_batched(qv, qls, k)
        ref_s = time.perf_counter() - t0
        ref_hops, ref_dcomps = _graph_walk_stats(eng, qv[:200], qls[:200],
                                                 k)
    ref_equal = bool(np.array_equal(ref_ids, ids) and np.array_equal(
        ref_d.view(np.int32), first_d.view(np.int32)))
    stats_equal = bool(np.array_equal(hops, ref_hops)
                       and np.array_equal(dcomps, ref_dcomps))
    launches_ok = (per_batch["gather_distance"] == 0
                   and per_batch["graph_walk"] == len(set(routed)))
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
               mean_hops=float(hops.mean()),
               mean_dist_comps=float(dcomps.mean()),
               max_hops=int(hops.max()),
               ref_loop=dict(recall_at_10=recall_at_k(ref_ids, truth, n),
                             batch_seconds=ref_s,
                             mean_hops=float(ref_hops.mean()),
                             mean_dist_comps=float(ref_dcomps.mean()),
                             batch_equal=ref_equal,
                             hops_and_dist_comps_equal=stats_equal),
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
    if not (ref_equal and stats_equal):
        raise AssertionError("graph: the walk kernel's batch, hops or "
                             "distance computations differ from the torch "
                             "hop loop's")
    if not launches_ok:
        raise AssertionError(f"graph: launches {per_batch} for "
                             f"{len(set(routed))} routed groups (want one "
                             f"walk a group and no gather_distance)")
    return res, eng


# ---------------------------------------------------------------------------
# phase 4f: streaming inserts, deletes and compaction at the paper's scale
# ---------------------------------------------------------------------------

# ten rounds, each: insert rows from the paper's generator (another seed),
# delete live base and inserted ids, search the 1,000-query batch
STREAM_ROUNDS = 10
STREAM_INSERT = 10_000
STREAM_DELETE_BASE = 4_000
STREAM_DELETE_NEW = 1_000
STREAM_SEED = 101
IVF_STREAM_DELETES = 50_000


def _stream_plan(n):
    """Each round's inserted rows and the ids it deletes (the same for
    every engine: no threshold fires, so inserted ids are n, n+1, …)."""
    from repro_torch.data import VectorLabelDataset

    ds = VectorLabelDataset(n=STREAM_ROUNDS * STREAM_INSERT, dim=PAPER["dim"],
                            n_labels=PAPER["n_labels"], zipf_a=PAPER["zipf_a"],
                            avg_size=PAPER["avg_label_size"], seed=STREAM_SEED)
    rows, ls = ds.generate()
    rng = np.random.default_rng(STREAM_SEED)
    base_alive = np.ones(n, bool)
    new_alive = np.zeros(len(ls), bool)
    rounds = []
    for r in range(STREAM_ROUNDS):
        sl = slice(r * STREAM_INSERT, (r + 1) * STREAM_INSERT)
        new_alive[sl] = True
        dead_base = rng.choice(np.flatnonzero(base_alive), STREAM_DELETE_BASE,
                               replace=False)
        dead_new = rng.choice(np.flatnonzero(new_alive), STREAM_DELETE_NEW,
                              replace=False)
        base_alive[dead_base] = False
        new_alive[dead_new] = False
        rounds.append((rows[sl], ls[sl], np.concatenate([dead_base,
                                                         n + dead_new])))
    return rows, ls, rounds, base_alive, new_alive


def _same_to_tier(got, want, *, bitwise, tag):
    """Two (dists, ids) host results of one batch: bitwise, or at phase
    3's tier for random data and int8 (values allclose at rtol 1e-5, ids
    equal up to boundary ties; ROADMAP C3).  Returns how many rows have
    equal ids and how many are bitwise equal."""
    import torch

    same = (got[1] == want[1]).all(1)
    bits = same & (got[0].view(np.int32) == want[0].view(np.int32)).all(1)
    out = dict(rows=len(bits), equal_id_rows=int(same.sum()),
               bitwise_rows=int(bits.sum()))
    if bitwise:
        if not bits.all():
            raise AssertionError(f"{tag}: not bitwise equal ({out})")
        return dict(out, tier="bitwise")
    _compare(torch.from_numpy(got[0]), torch.from_numpy(got[1]),
             torch.from_numpy(want[0]), torch.from_numpy(want[1]),
             integer=False, int8=True, tag=tag)
    return dict(out, tier=f"values rtol {RTOL} atol {ATOL}, ids up to ties")


def _stream_cuda_vs_ref(se, qv, qls, k, qsel):
    """The stream with everything pending, searched on ``"cuda"`` and on
    ``kernel_backend="ref"`` (the plain versions on the card), at phase
    3's tier: on random rows the plain versions' torch sums round
    otherwise than the kernels' in-order ones."""
    qs, ls = qv[qsel], [qls[i] for i in qsel]
    got = se.search_batched(qs, ls, k)
    se.base._seg_backend = "ref"
    try:
        want = se.search_batched(qs, ls, k)
    finally:
        se.base._seg_backend = "cuda"
    return dict(queries=len(qsel), **_same_to_tier(
        got, want, bitwise=False, tag="stream cuda vs ref"))


def stream_path(dev, *, data, ctx, static, ivf_eng, counts, clock):
    """Phase 4f: two streaming engines (f32 and int8+rerank, fused) built
    on phase 4's table and selection, ten rounds of 10,000 inserts, 5,000
    deletes (4,000 base, 1,000 inserted) and a 1,000-query search, then a
    flush; and phase 4b's ivf engine wrapped in a stream with 50,000 base
    deletes pending.  Gates: recall@10 ≥ 0.999 against the survivors'
    exact top-k and no dead id; pending ≡ flushed (ids through the
    ``id_map``: bitwise for f32, C3's tier for int8+rerank); ``"cuda"`` ≡
    ``"ref"`` on 82 queries at phase 3's tier for random rows (ivf up to
    ties as ``_ivf_cuda_vs_ref``)."""
    import torch

    from repro_torch.core import (EMPTY_KEY, LabelHybridEngine,
                                  StreamingEngine, encode_many,
                                  masks_to_int32_words, recall_at_k)
    from repro_torch.kernels import ops

    vectors, label_sets, qv, qls = data
    n, k = len(label_sets), PAPER["k"]
    t_phase = time.perf_counter()
    rows, new_ls, rounds, base_alive, new_alive = _stream_plan(n)
    plan_s = time.perf_counter() - t_phase
    # phase 4b's 82 queries: the first 64 and 32 of the top index's
    top = [i for i, key in enumerate(ivf_eng.route_many(qls))
           if key == EMPTY_KEY]
    qsel = sorted(set(range(64)) | set(top[:32]))
    # the survivors' exact top-k, in stream ids
    surv_ids = np.concatenate([np.flatnonzero(base_alive),
                               n + np.flatnonzero(new_alive)])
    surv_x = torch.from_numpy(np.concatenate(
        [vectors[base_alive], rows[new_alive]])).to(dev)
    surv_ls = ([s for s, a in zip(label_sets, base_alive) if a]
               + [s for s, a in zip(new_ls, new_alive) if a])
    surv_lx = torch.from_numpy(masks_to_int32_words(
        encode_many(surv_ls))).to(dev)
    pos = exact_topk(surv_x, surv_lx, qv, qls, k, dev)
    sentinel = n + len(new_ls)
    truth = np.where(pos < surv_ids.size,
                     surv_ids[np.clip(pos, 0, surv_ids.size - 1)], sentinel)
    dead = np.setdiff1d(np.arange(sentinel), surv_ids)
    del surv_x, surv_lx
    out = dict(rounds=STREAM_ROUNDS, inserts_a_round=STREAM_INSERT,
               deletes_a_round=dict(base=STREAM_DELETE_BASE,
                                    inserted=STREAM_DELETE_NEW),
               plan_and_truth_seconds=time.perf_counter() - t_phase,
               plan_seconds=plan_s, cuda_vs_ref_queries=len(qsel),
               engines={})
    for storage in STORAGES:
        int8 = storage != "f32"
        name = f"{storage}/fused=auto"
        eng = LabelHybridEngine(vectors, label_sets, ctx["table"],
                                ctx["selection"], None, "flat", "l2",
                                {"fused": "auto"}, ctx["select_seconds"],
                                storage=storage, device=dev)
        se = StreamingEngine(eng, build_kwargs=dict(
            mode="eis", c=PAPER["elastic_bound"], query_label_sets=qls,
            backend="flat", metric="l2", storage=storage, fused="auto",
            device=dev))
        warm = se.warmup_serving([k], 1, N_QUERIES,
                                 delta_rows_hint=STREAM_ROUNDS
                                 * STREAM_INSERT)
        ins_s, del_s, search_s = [], [], []
        for r, (x_r, ls_r, victims) in enumerate(rounds):
            clock.sync()
            t0 = time.perf_counter()
            ids = se.insert(x_r, ls_r)
            clock.sync()
            ins_s.append(time.perf_counter() - t0)
            if ids[0] != n + r * STREAM_INSERT:
                raise AssertionError(f"{name}: round {r} ids start at "
                                     f"{ids[0]}: a threshold fired")
            t0 = time.perf_counter()
            se.delete(victims)
            clock.sync()
            del_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            pend_d, pend_i = se.search_batched(qv, qls, k)
            search_s.append(time.perf_counter() - t0)
        st = se.stats()
        fired = len(se.compaction_log)
        recall = recall_at_k(pend_i, truth, sentinel)
        dead_returned = int(np.isin(pend_i[pend_i < sentinel], dead).sum())
        vs_ref = _stream_cuda_vs_ref(se, qv, qls, k, qsel)
        before = dict(counts())
        se.search_batched(qv, qls, k)
        per_batch = {key: counts()[key] - before[key] for key in before}
        qb = 1 << (len(qls) - 1).bit_length()
        qp = np.zeros((qb, qv.shape[1]), np.float32)
        qp[:len(qls)] = qv
        lp = np.zeros((qb, eng.label_words.shape[1]), np.int32)
        lp[:len(qls)] = masks_to_int32_words(encode_many(qls))
        before = dict(counts())
        d = se.delta
        ops.delta_topk(qp, lp, d.vectors, d.label_words, d.norms,
                       d.tombstones, d.count, k=k, backend="cuda",
                       fused="auto", device=dev, **d.tier_kwargs())
        delta_launches = {key: counts()[key] - before[key] for key in before}
        pending = _serve_numbers(se.search_batched, qv, qls, k)
        delta = dict(capacity=d.capacity, count=d.count,
                     bytes=d.nbytes, tier_bytes=d.tier_nbytes)
        clock.sync()
        t0 = time.perf_counter()
        rep = se.flush()
        clock.sync()
        flush_s = time.perf_counter() - t0
        id_map = np.append(rep["id_map"], len(se.base.label_sets))
        flushed = se.search_batched(qv, qls, k)
        vs_flushed = _same_to_tier(
            flushed, (pend_d, id_map[pend_i].astype(np.int32)),
            bitwise=not int8, tag=f"{name}: flushed vs pending")
        after = _serve_numbers(se.search_batched, qv, qls, k)
        res = dict(
            storage=storage, fused="auto", warmup_seconds=warm["seconds"],
            warmup_launches=warm["programs"],
            insert_rows_per_s=STREAM_INSERT / float(np.median(ins_s)),
            insert_seconds=ins_s,
            delete_ids_per_s=(STREAM_DELETE_BASE + STREAM_DELETE_NEW)
            / float(np.median(del_s)),
            delete_seconds=del_s, round_batch_seconds=search_s,
            thresholds_fired=fired, live_rows=st.live_rows,
            tombstoned_rows=st.tombstoned_rows, delta_rows=st.delta_rows,
            delta=delta, recall_at_10=recall, dead_ids_returned=dead_returned,
            cuda_vs_ref=vs_ref, launches_per_1000_query_batch=per_batch,
            delta_launches_per_batch={key: v for key, v
                                      in delta_launches.items() if v},
            pending=pending,
            static_f32_fused_warm_qps=static["f32/fused=auto"]["warm_qps"],
            static_warm_qps=static[name]["warm_qps"],
            flush_seconds=flush_s, flush_report_seconds=rep["seconds"],
            flushed_rows=len(se.base.label_sets),
            flushed_vs_pending=vs_flushed, after_flush=after)
        emit("stream_engine", **res)
        if fired:
            raise AssertionError(f"{name}: {fired} compaction(s) fired "
                                 f"before the flush")
        if recall < 0.999 or dead_returned:
            raise AssertionError(f"{name}: recall@10 {recall}, "
                                 f"{dead_returned} dead ids returned")
        out["engines"][name] = res
        del se, eng
        torch.cuda.empty_cache()

    # deletes pending on the ivf engine (an insert would fold: a full ivf
    # rebuild at 10^6 rows)
    se = StreamingEngine(ivf_eng)
    victims = np.random.default_rng(STREAM_SEED + 1).choice(
        n, IVF_STREAM_DELETES, replace=False)
    t0 = time.perf_counter()
    se.delete(victims)
    del_s = time.perf_counter() - t0
    before = dict(counts())
    t0 = time.perf_counter()
    _, ids = se.search_batched(qv, qls, k)
    first_s = time.perf_counter() - t0
    per_batch = {key: counts()[key] - before[key] for key in before}
    dead_returned = int(np.isin(ids[ids < n], victims).sum())
    vs_ref = _ivf_cuda_vs_ref(ivf_eng, qv, qls, k, qsel, dev,
                              search=se.search_batched)
    if se.base is not ivf_eng or se.compaction_log:
        raise AssertionError("ivf stream: a delete folded")
    out["ivf"] = dict(deletes=IVF_STREAM_DELETES, delete_seconds=del_s,
                      first_batch_seconds=first_s,
                      keys_with_tombstones=len(se._private_tombs()),
                      dead_ids_returned=dead_returned, cuda_vs_ref=vs_ref,
                      launches_per_1000_query_batch=per_batch,
                      **_serve_numbers(se.search_batched, qv, qls, k))
    emit("stream_ivf", **out["ivf"])
    if dead_returned:
        raise AssertionError(f"ivf stream: {dead_returned} dead ids returned")
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 4e: minitron_4b decoding at full width
# ---------------------------------------------------------------------------

DECODE = dict(arch="minitron_4b", slots=8, max_len=2048, requests=16,
              prompt_tokens=(64, 512), max_new=32, sequential=4, seed=11)
# step-1 logits, max |x − plain| over max |plain|: through 32 random layers
# rounding alone reads 0.016 (the kernel) and 0.019 (bf16 softmax weights),
# the token just written left out 0.145 (on an H100); the limit sits
# between them
STEP1_LOGITS_LIMIT = 0.05


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _timed(fn, sink, dev):
    """``fn`` with its device time (host clock between two synchronizes)
    appended to ``sink`` in ms at every call."""
    import torch

    def wrapped(*args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize(dev)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def decode_path(dev):
    """Phase 4e: ``minitron_4b`` at its published widths (32 layers,
    d_model 3,072, 24 heads over 8 KV heads, head_dim 128, vocab 256,000;
    4.19 B parameters, bf16), initialized on the card from a seeded
    ``torch.Generator``, served by a ``BatchedDecoder`` with 8 slots and
    ``max_len`` 2,048: 16 requests with prompts of 64–512 tokens and
    ``max_new`` 32.  Decode attention runs through the flash_decode
    kernel, once per layer per decode step.  Returns what the gates
    (:func:`decode_gates`) need."""
    import torch

    from repro_torch import arch as A
    from repro_torch.models import common
    from repro_torch.serve import BatchedDecoder, Request

    c = DECODE
    spec = A.get_arch(c["arch"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    params = common.init_params(gen, A.param_specs(spec))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(c["seed"])
    lo, hi = c["prompt_tokens"]
    prompts = [rng.integers(0, spec.cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, c["requests"])]
    dec = BatchedDecoder(spec, params, c["slots"], c["max_len"], device=dev)
    prefill_ms, step_ms = [], []
    dec._prefill1 = _timed(dec._prefill1, prefill_ms, dev)
    dec._decode = _timed(dec._decode, step_ms, dev)
    reqs = [Request(prompt=p, max_new=c["max_new"], rid=i)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = dec.run(reqs)
    run_s = time.perf_counter() - t0
    from repro_torch.kernels import flash_decode as fd
    launches = fd.flash_decode.launches
    generated = sum(len(r.generated) for r in done)
    if sorted(r.rid for r in done) != list(range(c["requests"])) or any(
            len(r.generated) != c["max_new"]
            or not all(0 <= t < spec.cfg.vocab for t in r.generated)
            for r in done):
        raise AssertionError("decode_path: a request came back incomplete")
    if launches != spec.cfg.n_layers * dec.steps:
        raise AssertionError(f"decode_path: flash_decode launched {launches} "
                             f"times for {dec.steps} steps of "
                             f"{spec.cfg.n_layers} layers")
    weight_bytes = _tree_bytes(params)
    kv_bytes = _tree_bytes(dec.cache)
    stats = dict(
        arch=c["arch"], params=A.count_total_params(spec),
        weight_bytes=weight_bytes, kv_cache_bytes=kv_bytes,
        slots=c["slots"], max_len=c["max_len"], requests=c["requests"],
        prompt_tokens=[int(p.shape[0]) for p in prompts],
        max_new=c["max_new"], init_seconds=init_s, run_seconds=run_s,
        decode_steps=dec.steps, flash_decode_launches=launches,
        generated_tokens=generated, tokens_per_s=generated / run_s,
        prefill_ms_p50=float(np.percentile(prefill_ms, 50)),
        prefill_ms_max=max(prefill_ms),
        prefill_tokens_per_s=sum(int(p.shape[0]) for p in prompts)
        / (sum(prefill_ms) / 1e3),
        decode_step_ms_p50=float(np.percentile(step_ms, 50)),
        decode_step_ms_p99=float(np.percentile(step_ms, 99)),
        # the least a step could take: every weight read once, over HBM
        decode_step_weights_bound_ms=weight_bytes / PEAK_BYTES_PER_S * 1e3)
    dec._prefill1 = A.make_prefill(spec, c["max_len"])
    dec._decode = A.make_decode(spec)
    return dict(spec=spec, params=params, dec=dec, prompts=prompts,
                done=sorted(done, key=lambda r: r.rid), stats=stats)


def _plain_bf16_weights(q, k, v, lengths):
    """The plain decode attention with the softmax weights rounded to the
    cache's dtype before the value product, as the JAX package's decoders
    round them: a control for how far rounding alone moves the logits."""
    import torch
    B, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs",
                     q.float().reshape(B, KH, H // KH, Dh), k.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s / Dh ** 0.5,
                    torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhgs,bshd->bhgd", w, v.float()).reshape(
        B, H, Dh).to(q.dtype)


def decode_gates(state):
    """Phase 4e's gates, after the launch counts were read: batched ≡
    sequential tokens for the first 4 requests (each served alone); then
    the first decode step of 8 admitted requests, from the same cache,
    four ways: through the plain attention (``backend="ref"``), the plain
    attention with bf16 softmax weights, a planted fault (the plain
    attention over ``lengths − 1``: the token just written left out) and
    the kernel.  Gate: in the kernel's step, each layer's kernel output
    against the plain version on that layer's inputs, within phase 3's
    tolerance, and the fault outside it in every layer; and the step's
    logits, kernel against plain, within ``STEP1_LOGITS_LIMIT`` × the
    largest plain logit, the fault's outside it.  The bf16-weights
    control is reported."""
    import torch

    from repro_torch import arch as A
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.serve import Request

    c = DECODE
    dec, spec = state["dec"], state["spec"]
    for r in state["done"][:c["sequential"]]:
        [solo] = dec.run([Request(prompt=state["prompts"][r.rid],
                                  max_new=c["max_new"])])
        if solo.generated != r.generated:
            raise AssertionError(f"decode_path: request {r.rid} batched "
                                 f"differs from sequential")
    for p in state["prompts"][:c["slots"]]:
        assert dec.admit(Request(prompt=p, max_new=c["max_new"]))
    decode = A.make_decode(spec)
    batch = dec.decode_batch()
    flash_decode, layers = ops.flash_decode, []

    def kernel(q, k, v, lengths, backend=None):
        out = flash_decode(q, k, v, lengths, backend="cuda")
        layers.append((q, k, v, lengths.to(torch.int32), out))
        return out

    attend = {
        "plain": lambda q, k, v, n, backend=None: flash_decode(
            q, k, v, n, backend="ref"),
        "plain_bf16_weights": lambda q, k, v, n, backend=None:
            _plain_bf16_weights(q, k, v, n.to(torch.int32)),
        "fault_token_left_out": lambda q, k, v, n, backend=None:
            flash_decode(q, k, v, n - 1, backend="ref"),
        # last: its step leaves the cache as a served step would (each step
        # writes its own K/V at ``position`` before reading them)
        "kernel": kernel,
    }
    logits = {}
    try:
        for name, fn in attend.items():
            ops.flash_decode = fn
            logits[name] = decode(state["params"], dec.cache,
                                  batch)[0].float()
    finally:
        ops.flash_decode = flash_decode
    dec.evict_all()
    if len(layers) != spec.cfg.n_layers:
        raise AssertionError(f"decode_path: {len(layers)} kernel calls in "
                             f"one step of {spec.cfg.n_layers} layers")
    sound, fault = [], []
    for q, k, v, n, out in layers:
        pv = fd.flash_decode_plain(q, k, v, n)
        sound.append(decode_tol_ratio(out, pv))
        fault.append(decode_tol_ratio(fd.flash_decode_plain(q, k, v, n - 1),
                                      pv))
    if max(sound) > 1.0 or min(fault) <= 1.0:
        raise AssertionError(f"decode_path: step-1 attention, kernel vs "
                             f"plain per layer: {max(sound)} x the "
                             f"tolerance (must be <= 1); the planted fault "
                             f"{min(fault)} x (must be > 1)")
    plain = logits["plain"]
    if not all(torch.isfinite(t).all() for t in logits.values()):
        raise AssertionError("decode_path: step-1 logits not finite")
    scale = float(plain.abs().max())
    rel = {name: float((t - plain).abs().max()) / scale
           for name, t in logits.items() if name != "plain"}
    if not rel["kernel"] <= STEP1_LOGITS_LIMIT < rel["fault_token_left_out"]:
        raise AssertionError(f"decode_path: step-1 logits against plain "
                             f"over the largest logit: {rel} (the kernel "
                             f"must read <= {STEP1_LOGITS_LIMIT}, the fault "
                             f"above it)")
    return dict(
        batched_equals_sequential=c["sequential"],
        step1_attention_tol_ratio_max=max(sound),
        step1_attention_fault_tol_ratio_min=min(fault),
        step1_logits_scale=scale,
        step1_logits_rel_err_vs_plain=rel,
        step1_logits_max_abs_err_vs_plain={
            name: float((t - plain).abs().max())
            for name, t in logits.items() if name != "plain"},
        step1_argmax_agreement_vs_plain={
            name: float((t.argmax(-1) == plain.argmax(-1)).float().mean())
            for name, t in logits.items() if name != "plain"},
        step1_tolerance="per layer, kernel vs plain on the same inputs: "
                        f"(rtol, atol) {DECODE_TOL['bfloat16']}; logits: "
                        f"{STEP1_LOGITS_LIMIT} x max |plain logit|")


# ---------------------------------------------------------------------------
# phase 5: kernel times at the main path's shapes, beside their bounds
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def arena_tiers(eng, qv, qls):
    """The workload batch's span tiers as the engine hands them to
    ``ops.segmented_topk`` (queries sorted by segment start), each with
    ``alone``: how many of its queries share their segment with no other
    query of the tier."""
    import torch

    from repro_torch.core import encode_many, masks_to_int32_words

    qw = masks_to_int32_words(encode_many(qls))
    routed = eng.route_many(qls)
    dev = eng.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = []
    for _, qp, lp, starts, lens, lmax, g in eng.arena_tier_batches(
            qv, qw, routed):
        seg = list(zip(starts[:g].tolist(), lens[:g].tolist()))
        alone = sum(seg.count(x) == 1 for x in seg)
        out.append(dict(q=t(qp), lq=t(lp), starts=t(starts), lens=t(lens),
                        lmax=lmax, queries=g, alone=alone))
    return out


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
    tiers = arena_tiers(eng, qv, qls)
    T = tiers[-1]
    Q, D = T["q"].shape
    W = T["lq"].shape[1]
    k = PAPER["k"]
    out = []

    def fused_at(T, plain_reps):
        """B1 on one tier: tiles from the Hopper tile model, held against
        its plain version, timed beside the one-query-per-block schedule
        (query tile 1) and its bound."""
        Q = T["q"].shape[0]
        n_pos, n_seen, n_pass, pairs = _segment_work(T, arena, rc)
        tc = roofline.fused_scan_tiles(D, T["lmax"], "f32", Q,
                                       backend="cuda", device=eng.device)
        one = roofline.fused_scan_tiles(D, T["lmax"], "f32", Q,
                                        backend="cuda", device=eng.device,
                                        max_qtile=1)
        args = (T["q"], T["lq"], arena.vectors, arena.label_words,
                arena.norms, rc, T["starts"], T["lens"], None, None, None)
        kw = dict(kp=k, lmax=T["lmax"], metric="l2", dtype="f32")
        plain_chunk = min(T["lmax"], 16384)
        plain_qtile = max(1, min(Q, (1 << 29) // (plain_chunk * D * 4)))

        def kernel(t=tc):
            return fs.fused_scan_cuda(*args, span=t.rows_per_chunk,
                                      qtile=t.queries_per_tile, **kw)
        kv, kp_ = kernel()
        pv, pp = fs.fused_scan_plain(*args, chunk=plain_chunk,
                                     qtile=plain_qtile, **kw)
        err = _compare(kv, kp_, pv, pp, integer=False, int8=False,
                       tag=f"fused_scan at lmax {T['lmax']}")
        ov, op = kernel(one)
        if not (torch.equal(ov, kv) and torch.equal(op, kp_)):
            raise AssertionError(f"fused_scan at lmax {T['lmax']}: query "
                                 f"tile {tc.queries_per_tile} differs from 1")
        ms = clock.ms(kernel)
        ms_one = clock.ms(lambda: kernel(one))
        plain_ms = clock.ms(lambda: fs.fused_scan_plain(
            *args, chunk=plain_chunk, qtile=plain_qtile, **kw),
            max_reps=plain_reps)
        nbytes = (Q * D * 4 + Q * W * 4 + 8 * Q + 4 * n_pos + 4 * W * n_seen
                  + (4 * D + 4) * n_pass + Q * k * 8)
        bound_ms, bound_by = _bound(nbytes, pairs * (2 * D + 3))
        shape = dict(queries=T["queries"], q_bucket=Q, lmax=T["lmax"],
                     queries_alone_in_their_run=T["alone"],
                     queries_per_tile=tc.queries_per_tile,
                     span_per_block=tc.rows_per_chunk, kp=k, dim=D,
                     pairs_passing=pairs, rows_touched=n_seen,
                     ms_query_tile_1=ms_one,
                     span_per_block_query_tile_1=one.rows_per_chunk)
        return err, ms, plain_ms, bound_ms, bound_by, shape

    # fused scan at the top tier and at the tier with the most queries
    # alone in their run (report only)
    err, ms, plain_ms, bound_ms, bound_by, shape = fused_at(T, 3)
    small = max(tiers[:-1] or tiers, key=lambda x: (x["alone"], x["lmax"]))
    s_err, s_ms, s_plain, s_bound, s_by, s_shape = fused_at(small, 5)
    s_shape.update(ms=s_ms, plain_ms=s_plain, bound_ms=s_bound,
                   bound_by=s_by, max_abs_err=s_err)
    emit("fused_scan_small_tier", **s_shape)
    shape["small_tier"] = s_shape
    out.append(dict(
        name="fused_scan", route="cuda",
        source="src/repro_torch/csrc/fused_scan.cu",
        replaces="src/repro/kernels/fused_scan.py:167",
        launches=counts_at_main["fused_scan"],
        max_abs_err=max(err, s_err, errs["fused_scan"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=shape))

    # gather distance: the unfused executor's first chunk at the top tier,
    # and the shape the unfused f32 engine launches most often in a batch,
    # each beside one thread per pair (max_qtile=1)
    chunk = min(ops.SEG_CHUNK_CUDA, T["lmax"])
    pos = torch.arange(chunk, dtype=torch.int32, device=eng.device)
    gid, valid = ref.segment_gids(rc, T["starts"], T["lens"], pos)
    gargs = (T["q"], T["lq"], arena.vectors, arena.label_words,
             gid.to(torch.int32).contiguous(),
             torch.sum(valid, dim=1).to(torch.int32))
    top = _time_gather(clock, gargs, {}, "gather at the top tier")
    top.update(queries=T["queries"], lmax=T["lmax"])
    with ShapeLog(ops, "segmented_gather_distance", _gather_key) as log:
        engines["f32/fused=False"].search_batched(qv, qls, k)
    key, n_key = log.most()
    args, kw = log.first[key]
    most = _time_gather(clock, args, kw, f"gather at {key}")
    most.pop("args")
    most.update(launches_in_one_batch=n_key, shapes_in_one_batch={
        str(k_): n for k_, n in sorted(log.counts.items())})
    emit("gather_most_launched_shape", **most)
    sweep = gather_run_sweep(clock, top.pop("args"))
    emit("gather_run_sweep", **sweep)
    batches = gather_batch_schedules(clock, engines, qv, qls, k)
    emit("gather_batch_schedules", **batches)
    err = max(top.pop("max_abs_err"), most.pop("max_abs_err"))
    out.append(dict(
        name="segmented_gather_distance", route="cuda",
        source="src/repro_torch/csrc/gather_distance.cu",
        replaces="src/repro/kernels/gather_distance.py:95",
        launches=counts_at_main["segmented_gather_distance"],
        max_abs_err=max(err, errs["segmented_gather_distance"]),
        ms=top.pop("ms"), plain_ms=top.pop("plain_ms"),
        bound_ms=top.pop("bound_ms"), bound_by=top.pop("bound_by"),
        library_ms=None,
        shape=dict(**top, most_launched=most, run_sweep=sweep,
                   batch_ms={name: {key: v for key, v in b.items()
                                    if key != "shapes"}
                             for name, b in batches["batches"].items()})))
    return out


def _gather_key(q, lq, x, lxw, g, ln, **kw):
    return q.shape[0], g.shape[1], kw.get("max_qtile")


def _longest_run(gids, lens) -> int:
    """The most consecutive queries of one launch that list the same
    non-empty row list (the tile schedule's runs, over all windows)."""
    g, n = gids.cpu().numpy(), lens.cpu().numpy()
    same = np.all(g[1:] == g[:-1], axis=1) & (n[1:] == n[:-1]) & (n[1:] > 0)
    best = run = 1
    for s in same:
        run = run + 1 if s else 1
        best = max(best, run)
    return best if len(g) else 0


def gather_batch_schedules(clock, engines, qv, qls, k):
    """B2 in every (Q, L, max_qtile) launch of one batch of each unfused
    engine, timed on its first launch's inputs as the executor calls it
    (the tile schedule; the +rerank shortlists at ``max_qtile=1``) and at
    ``max_qtile=1``, bitwise equal, beside the launch's longest run of
    queries listing one row list; each summed over the batch as launches
    × ms."""
    import torch

    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops
    out = {}
    for name in ("f32/fused=False", "int8+rerank/fused=False"):
        with ShapeLog(ops, "segmented_gather_distance", _gather_key) as log:
            engines[name].search_batched(qv, qls, k)
        shapes, as_called, per_pair = {}, 0.0, 0.0
        for key, n in sorted(log.counts.items(), key=str):
            args, kw = log.first[key]
            kw = dict(kw)
            mq = kw.pop("max_qtile", None)
            if not torch.equal(
                    gd.segmented_gather_distance(*args, **kw, max_qtile=mq),
                    gd.segmented_gather_distance(*args, **kw, max_qtile=1)):
                raise AssertionError(f"gather {name} {key}: the tile "
                                     f"schedule differs from max_qtile=1")
            ms_one = clock.ms(lambda: gd.segmented_gather_distance(
                *args, **kw, max_qtile=1))
            ms = ms_one if mq == 1 else clock.ms(
                lambda: gd.segmented_gather_distance(*args, **kw,
                                                     max_qtile=mq))
            Q, L = args[4].shape
            shapes[str(key)] = dict(
                launches=n, longest_run=_longest_run(args[4], args[5]),
                queries_per_block=gd.gather_qtile(
                    Q, L, storage=gd._STORAGE[args[2].dtype],
                    sms=gd._sms(args[0].device), max_qtile=mq),
                ms=ms, ms_max_qtile_1=ms_one)
            as_called += n * ms
            per_pair += n * ms_one
        out[name] = dict(launches=sum(log.counts.values()),
                         as_called_ms=as_called, max_qtile_1_ms=per_pair,
                         shapes=shapes)
    return dict(batches=out, card_state=nvidia_smi(CARD_STATE))


class ShapeLog:
    """Inside a ``with`` block, count the calls of ``module.<name>`` by
    ``key(*args, **kw)`` and keep the first call's arguments of each key.
    ``module`` is the caller's module (``ops``), never the kernel's own:
    a wrapper counts its launches on its module-level name."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key = module, name, key
        self.counts, self.first = {}, {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def record(*args, **kw):
            k = self.key(*args, **kw)
            self.counts[k] = self.counts.get(k, 0) + 1
            self.first.setdefault(k, (args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def most(self):
        """The key called most often (ties: the most work, key[0]·key[1])
        and its count."""
        key = max(self.counts, key=lambda k: (self.counts[k], k[0] * k[1]))
        return key, self.counts[key]


def _gather_bound(args, kw, out_numel):
    """B2's bound on these inputs: the queries, their labels and lens and
    the ids read once, each listed row's label words once, each row that
    passes some query's filter once (as stored), the output written once;
    3·D rounded operations a passing pair."""
    import torch
    q, lq, x, lxw, gids, lens = args
    Q, D = q.shape
    W = lq.shape[1]
    valid = (torch.arange(gids.shape[1], device=q.device)[None, :]
             < lens[:, None])
    g = gids.long()
    passing = torch.all((lq[:, None, :] & lxw[g]) == lq[:, None, :],
                        dim=-1) & valid
    rows_seen = int(torch.unique(g[valid]).numel())
    rows_pass = int(torch.unique(g[passing]).numel())
    pairs = int(passing.sum())
    row_bytes = D * x.element_size() + (8 if x.dtype == torch.uint8 else 0)
    nbytes = (Q * D * 4 + Q * W * 4 + 4 * Q + 4 * gids.numel()
              + 4 * W * rows_seen + row_bytes * rows_pass + 4 * out_numel)
    return _bound(nbytes, pairs * 3 * D) + (pairs, rows_seen)


def _time_gather(clock, args, kw, tag):
    """B2 on one launch's inputs: the schedule ``kw`` asks for beside one
    thread per pair (bitwise equal) and the plain version, with its
    bound, the card's state after."""
    import torch

    from repro_torch.kernels import gather_distance as gd
    kw = dict(kw)
    mq = kw.pop("max_qtile", None)
    kv = gd.segmented_gather_distance(*args, **kw, max_qtile=mq)
    one = gd.segmented_gather_distance(*args, **kw, max_qtile=1)
    if not torch.equal(kv, one):
        raise AssertionError(f"{tag}: the tile schedule differs from "
                             f"max_qtile=1")
    err = _compare(kv, None, gd.segmented_gather_distance_plain(*args, **kw),
                   None, integer=False, int8=args[2].dtype == torch.uint8,
                   tag=tag)
    ms = clock.ms(lambda: gd.segmented_gather_distance(*args, **kw,
                                                       max_qtile=mq))
    ms_one = clock.ms(lambda: gd.segmented_gather_distance(*args, **kw,
                                                           max_qtile=1))
    plain_ms = clock.ms(lambda: gd.segmented_gather_distance_plain(*args,
                                                                   **kw),
                        max_reps=5)
    bound_ms, bound_by, pairs, rows = _gather_bound(args, kw, kv.numel())
    Q, L = args[4].shape
    return dict(args=args, q_bucket=Q, columns=L, dim=args[0].shape[1],
                storage=str(args[2].dtype), max_qtile=mq,
                queries_per_block=gd.gather_qtile(
                    Q, L, storage=gd._STORAGE[args[2].dtype],
                    sms=gd._sms(args[0].device), max_qtile=mq),
                ms=ms, ms_max_qtile_1=ms_one, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                pairs_passing=pairs, rows_touched=rows,
                card_state=nvidia_smi(CARD_STATE))


# run lengths of B2's sweep: queries that list the same rows
GATHER_SWEEP_RUNS = (1, 2, 3, 4, 6, 8, 16, 64)


def gather_run_sweep(clock, args, seed=7):
    """B2 on the top tier's queries and shape with runs of r consecutive
    queries listing the same random rows (every column valid): one thread
    per pair against the tile schedule (runs of more than
    ``TILE_MIN_RUN`` tiled, shorter ones per pair inside the block),
    bitwise equal."""
    import torch

    from repro_torch.kernels import gather_distance as gd
    q, lq, x, lxw, gids, _ = args
    Q, L = gids.shape
    rng = np.random.default_rng(seed)
    lens = torch.full((Q,), L, dtype=torch.int32, device=q.device)
    out = {}
    for r in GATHER_SWEEP_RUNS:
        rows = rng.integers(0, x.shape[0], (-(-Q // r), L))
        a = (q, lq, x, lxw, torch.from_numpy(np.repeat(rows, r, axis=0)[:Q]
                                             .astype(np.int32)).to(q.device),
             lens)
        if not torch.equal(gd.segmented_gather_distance(*a),
                           gd.segmented_gather_distance(*a, max_qtile=1)):
            raise AssertionError(f"gather sweep run {r}: the tile schedule "
                                 f"differs from max_qtile=1")
        out[f"run_{r}"] = dict(
            per_pair_ms=clock.ms(lambda: gd.segmented_gather_distance(
                *a, max_qtile=1)),
            tile_ms=clock.ms(lambda: gd.segmented_gather_distance(*a)))
    return dict(q_bucket=Q, columns=L, tile_min_run=gd.TILE_MIN_RUN,
                runs=out, card_state=nvidia_smi(CARD_STATE))


def _dense_bound(q, x, lq, lx, out_bytes: int, chunk: int = 32):
    """Bound of a dense filtered pass on these inputs, counted as B1's and
    B2's are: the queries and their label words read once, each row's
    label words that some query sets once (the rest pass every row), each
    row that passes some query's filter once, the output written once;
    2D + 3 flops a passing pair for the norms-form distance (the others'
    values are +inf or never kept) and 2D for each norm read.  Returns
    (ms, by, passing pairs, rows passing some filter)."""
    import torch
    (Q, D), (N, W) = q.shape, lx.shape
    words = torch.nonzero((lq != 0).any(0)).flatten()
    lqw, lxw = lq[:, words], lx[:, words]
    pairs, rows_any = 0, torch.zeros(N, dtype=torch.bool, device=lx.device)
    for i in range(0, Q, chunk):
        c = lqw[i:i + chunk, None, :]
        keep = torch.all((c & lxw[None]) == c, dim=-1)
        pairs += int(keep.sum())
        rows_any |= keep.any(0)
    rows = int(rows_any.sum())
    nbytes = 4 * Q * (D + W) + 4 * N * len(words) + 4 * D * rows + out_bytes
    return _bound(nbytes, pairs * (2 * D + 3) + 2 * D * (Q + rows)) + (
        pairs, rows)


def time_dense_kernels(ivf_eng, flat, ctx, clock, launches, errs):
    """masked_distance at the ivf engine's top tier (the workload's
    queries routed to the largest index, on their power-of-two bucket) and
    at the (Q, N) one ivf batch launches most often, and filtered_topk at
    the whole-dataset scan's [1024-bucket, N] shape, each beside its plain
    version and its bound, the card's state after."""
    import torch

    from repro_torch.core import (EMPTY_KEY, encode_many,
                                  masks_to_int32_words)
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md
    from repro_torch.kernels import ops

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
    N = ix._lxw.shape[0]
    bound_ms, bound_by, pairs, _ = _dense_bound(*args, 4 * Q * N)
    top_state = nvidia_smi(CARD_STATE)
    del kd
    # the (Q, N) the ivf engine launches most often in one batch (its
    # calls of ops.masked_distance, which hands them to the kernel)
    with ShapeLog(ops, "masked_distance", lambda q, x, lq, lx, **kw: (
            q.shape[0], x.shape[0])) as log:
        ivf_eng.search_batched(qv, qls, PAPER["k"])
    key, n_key = log.most()
    margs = tuple(a.contiguous() for a in log.first[key][0])
    mkw = dict(metric=log.first[key][1].get("metric", "l2"))
    m_err = _compare(md.masked_distance(*margs, **mkw), None,
                     md.masked_distance_plain(*margs, **mkw), None,
                     integer=False, int8=False,
                     tag=f"masked_distance at {key}")
    m_bound, m_by, _, _ = _dense_bound(*margs, 4 * key[0] * key[1])
    most = dict(q_bucket=key[0], rows=key[1], launches_in_one_batch=n_key,
                distinct_shapes_in_one_batch=len(log.counts),
                ms=clock.ms(lambda: md.masked_distance(*margs, **mkw)),
                plain_ms=clock.ms(lambda: md.masked_distance_plain(
                    *margs, **mkw)),
                bound_ms=m_bound, bound_by=m_by, max_abs_err=m_err,
                card_state=nvidia_smi(CARD_STATE))
    emit("masked_distance_most_launched_shape", **most)
    out.append(dict(
        name="masked_distance", route="cuda",
        source="src/repro_torch/csrc/masked_distance.cu",
        replaces="src/repro/kernels/masked_distance.py:64",
        launches=launches["masked_distance"],
        max_abs_err=max(err, m_err, errs["masked_distance"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=len(top), q_bucket=Q, rows=N, dim=D,
                   pairs_passing=pairs, card_state=top_state,
                   most_launched=most)))

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
    N = flat.label_words.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    span, splits = _span_split(Q, N, sms, k)
    bound_ms, bound_by, pairs, rows = _dense_bound(*args, 8 * Q * k)
    ft_state = nvidia_smi(CARD_STATE)
    shapes = filtered_topk_shapes(clock, args, k, sms)
    out.append(dict(
        name="filtered_topk", route="cuda",
        source="src/repro_torch/csrc/filtered_topk.cu",
        replaces="src/repro/kernels/filtered_topk.py:69",
        launches=launches["filtered_topk"],
        max_abs_err=max(err, errs["filtered_topk"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        shape=dict(queries=len(qls), q_bucket=Q, rows=N, dim=D, k=k,
                   pairs_passing=pairs, pairs_passing_share=pairs / (Q * N),
                   rows_passing_some_filter=rows,
                   query_tile=ft.query_tile(Q, k), span_per_block=span,
                   splits=splits, card_state=ft_state, **shapes)))
    return out


def _blocks_per_sm(Q, k):
    """filtered_topk's blocks an SM at (Q, k), as its wrapper reads them
    from the library."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import filtered_topk as ft
    return ft.blocks_per_sm(cuda_build.load("filtered_topk", ft._SIGNATURES),
                            Q, k)


def _span_split(Q, N, sms, k):
    """filtered_topk's (span, splits) at (Q, k), as its wrapper picks
    them."""
    from repro_torch.kernels import filtered_topk as ft
    return ft.span_split(Q, N, sms, k, _blocks_per_sm(Q, k))


def filtered_topk_shapes(clock, args, k, sms):
    """filtered_topk's other shapes beside their bounds, each checked
    against the plain version first: the 32-query latency batch ([32, N],
    k 10) and k 100 and 256 at the whole batch ([1024, N]); and the
    yardstick, masked_distance at the same [1024, N] (the same tile, and a
    [Q, N] output B3 does not write)."""
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md

    q, x, lq, lx = args
    Q, N = q.shape[0], x.shape[0]
    out = {}
    pv, pi = ft.filtered_topk_plain(*args, k=256)
    for name, a, kk in (("q32", (q[:32], x, lq[:32], lx), k),
                        ("k100", args, 100), ("k256", args, 256)):
        kv, ki = ft.filtered_topk(*a, k=kk)
        if name == "q32":
            wv, wi = ft.filtered_topk_plain(*a, k=kk)
        else:
            wv, wi = pv[:, :kk], pi[:, :kk]
        err = _compare(kv, ki, wv, wi, integer=False, int8=False,
                       tag=f"filtered_topk {name}")
        del kv, ki
        nq = a[0].shape[0]
        bound_ms, bound_by, pairs, _ = _dense_bound(*a, 8 * nq * kk)
        span, splits = _span_split(nq, N, sms, kk)
        out[f"filtered_topk_{name}"] = dict(
            queries=nq, k=kk, ms=clock.ms(lambda a=a, kk=kk: ft.filtered_topk(
                *a, k=kk)), bound_ms=bound_ms, bound_by=bound_by,
            pairs_passing=pairs, max_abs_err=err,
            query_tile=ft.query_tile(nq, kk),
            blocks_per_sm=_blocks_per_sm(nq, kk), span_per_block=span,
            splits=splits, card_state=nvidia_smi(CARD_STATE))
    del pv, pi
    bound_ms, bound_by, _, _ = _dense_bound(*args, 4 * Q * N)
    out["masked_distance_same_shape"] = dict(
        queries=Q, ms=clock.ms(lambda: md.masked_distance(*args)),
        bound_ms=bound_ms, bound_by=bound_by,
        card_state=nvidia_smi(CARD_STATE))
    emit("filtered_topk_shapes", **out)
    return out


def time_graph_kernel(graph_eng, ctx, clock, launches, errs, seed=6):
    """gather_distance at one hop's shape: the ids [256, 16] of the
    neighbour lists of 256 nodes of the top graph index (the workload's
    top-index queries on their bucket), beside its plain version and its
    bound; then the walk kernel (:func:`time_graph_walk`)."""
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
                   dim=D, index_rows=ix.num_vectors, pairs=pairs)),
        time_graph_walk(graph_eng, ctx, clock, launches, errs)]


class _RecordedAdjacency:
    """An adjacency table that records the nodes a walk expands: the torch
    hop loop reads it only as ``adj.shape`` and ``adj[u]``, u [B] the
    node each lane expands at that hop."""

    def __init__(self, adj):
        self.adj, self.shape, self.expanded = adj, adj.shape, []

    def __getitem__(self, u):
        self.expanded.append(u)
        return self.adj[u]


def _walk_footprint(args, kw):
    """The torch hop loop on ``args`` (q, lq, entries, x, adj, lxw) with
    its expanded nodes recorded, and what the walk needed of memory: the
    nodes some lane expanded (``adjacency_rows``), the nodes some lane
    visited (``label_rows``: each visited node's labels are tested), the
    rows some lane needed a distance of (``rows``: every visited node on
    ``post``, the seeds and the passing ones on ``pre``), each counted
    once across lanes, and the distances the lanes needed, lane by lane
    (``lane_distances``).  A lane's nodes are its seeds and the
    neighbours of the nodes it expanded in its first ``hops`` hops (a
    finished lane freezes, its later hops expand nothing);
    ``lane_visited`` summed over lanes equals the walks' distance
    computations when no adjacency row repeats an id."""
    import torch

    from repro_torch.kernels import graph_walk as gw

    q, lq, entries, x, adj, lxw = args
    rec = _RecordedAdjacency(adj)
    want = gw.graph_walk_plain(q, lq, entries, x, rec, lxw, **kw)
    hops = want[2].long()
    N, (B, E) = x.shape[0], entries.shape
    u = torch.stack(rec.expanded)                       # [H, B]
    live = torch.arange(u.shape[0], device=u.device)[:, None] < hops
    lane = torch.arange(B, device=u.device)
    exp_lane = lane.expand_as(u)[live]
    exp_node = u[live]
    nbr = adj[exp_node]                                 # [hops, M]
    vis_lane = torch.cat([lane[:, None].expand(B, E).reshape(-1),
                          exp_lane[:, None].expand_as(nbr).reshape(-1)])
    vis_node = torch.cat([entries.reshape(-1), nbr.reshape(-1)])
    seed = torch.cat([torch.ones(B * E, dtype=torch.bool, device=u.device),
                      torch.zeros(nbr.numel(), dtype=torch.bool,
                                  device=u.device)])
    keep = (vis_node >= 0) & (vis_node < N)
    vis_lane, vis_node, seed = vis_lane[keep], vis_node[keep], seed[keep]
    pair = torch.unique(vis_lane * (N + 1) + vis_node)
    seed_pair = torch.unique(vis_lane[seed] * (N + 1) + vis_node[seed])
    p_lane, p_node = pair // (N + 1), pair % (N + 1)
    if kw["strategy"] == "pre":
        lw = lq[p_lane]
        need = ((lw & lxw[p_node]) == lw).all(1) | torch.isin(pair,
                                                              seed_pair)
    else:
        need = torch.ones_like(pair, dtype=torch.bool)
    return want, dict(
        adjacency_rows=int(torch.unique(exp_node).numel()),
        label_rows=int(torch.unique(p_node).numel()),
        rows=int(torch.unique(p_node[need]).numel()),
        lane_distances=int(need.sum()), lane_visited=int(pair.numel()),
        lane_hops=int(hops.sum()))


def time_graph_walk(graph_eng, ctx, clock, launches, errs):
    """The walk kernel at the top graph index's bucket, as the engine's
    ``search_padded`` calls it (the workload's top-index queries, zero
    pad lanes, every lane seeded at the medoid, k 10, ef 64, post),
    beside the torch hop loop on the same inputs and the bound of the
    work this run's walks did (:func:`_walk_footprint`): each row, label
    row and adjacency row that some lane needed, read once however many
    lanes touched it, the queries, labels and results read or written
    once, and 3·D operations (2·D for ip) a distance a lane needed."""
    import torch

    from repro_torch.core import EMPTY_KEY, encode_many, masks_to_int32_words
    from repro_torch.kernels import graph_walk as gw

    qv, qls = ctx["qv"], ctx["qls"]
    ix = graph_eng.indexes[EMPTY_KEY]
    dev = ix.device
    k = PAPER["k"]
    top = [i for i, key in enumerate(graph_eng.route_many(qls))
           if key == EMPTY_KEY]
    b = 1 << max(len(top) - 1, 0).bit_length()
    qw = masks_to_int32_words(encode_many([qls[i] for i in top]))
    qp = torch.zeros((b, qv.shape[1]), dtype=torch.float32, device=dev)
    qp[:len(top)] = torch.from_numpy(qv[top]).to(dev)
    lp = torch.zeros((b, qw.shape[1]), dtype=torch.int32, device=dev)
    lp[:len(top)] = torch.from_numpy(qw).to(dev)
    ent = torch.full((b, 1), ix.medoid, dtype=torch.int64, device=dev)
    args = (qp, lp, ent, ix._xb, ix._adj_ext, ix._lxw_ext)
    kw = dict(k=k, ef=max(ix.ef_search, k), metric=ix.metric,
              strategy=ix.strategy)
    got = gw.graph_walk(*args, **kw)
    want, foot = _walk_footprint(args, kw)
    bad, err = _walk_equal(got, want)
    if bad:
        raise AssertionError("graph_walk at the top index's bucket differs "
                             "from the torch hop loop")
    ms = clock.ms(lambda: gw.graph_walk(*args, **kw))
    plain_ms = clock.ms(lambda: gw.graph_walk_plain(*args, **kw),
                        max_reps=3)
    hops, dcs = got[2].long(), got[3].long()
    D, W, M = qp.shape[1], lp.shape[1], ix.M
    nbytes = (4 * D * foot["rows"] + 4 * W * foot["label_rows"]
              + 8 * M * foot["adjacency_rows"]
              + 4 * b * (D + W + 2) + 8 * b * (k + 1))
    bound_ms, bound_by = _bound(
        nbytes, (2 if ix.metric == "ip" else 3) * D * foot["lane_distances"])
    return dict(
        name="graph_walk", route="cuda",
        source="src/repro_torch/csrc/graph_walk.cu",
        replaces="src/repro/kernels/gather_distance.py:163",
        launches=launches["graph_walk"],
        max_abs_err=max(err, errs["graph_walk"]), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ms_per_hop_of_longest_lane=ms / max(int(hops.max()), 1),
        shape=dict(queries=len(top), lanes=b, ef=kw["ef"], M=M, dim=D,
                   index_rows=ix.num_vectors, hops=int(hops.sum()),
                   max_hops=int(hops.max()),
                   dist_comps=int(dcs.sum()), footprint=foot))


DECODE_32K = dict(batch=128, seq=32_768, kv_heads=8, group=3, head_dim=128,
                  fallback_batch=32)


def _fits_or_smaller(fn, batches):
    """``(batch, fn(batch))`` for the first batch of ``batches`` whose call
    fits in device memory."""
    import torch
    for b in batches:
        try:
            return b, fn(b)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
    raise AssertionError(f"no batch of {batches} fits")


def time_decode_kernel(dev, clock, launches, errs, seed=12):
    """flash_decode at the ``decode_32k`` cell's shape (B 128, S 32,768)
    with minitron_4b's heads (KH 8, G 3, Dh 128), bf16, lengths = S,
    beside its bound (K and V read once), its plain version and
    ``scaled_dot_product_attention`` (GQA, a length mask, the layout
    transposes included).  Where the plain version's f32 copies of the
    cache (34 GB) or the library call do not fit, they run at B 32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    c = DECODE_32K
    B, S, KH, G, Dh = (c["batch"], c["seq"], c["kv_heads"], c["group"],
                       c["head_dim"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, KH * G, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, KH, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, KH, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    ms = clock.ms(lambda: fd.flash_decode(q, k, v, lens), budget_s=1.0)
    kv = fd.flash_decode(q, k, v, lens)
    batches = (B, c["fallback_batch"])

    def plain(b):
        out = fd.flash_decode_plain(q[:b], k[:b], v[:b], lens[:b])
        return out, clock.ms(lambda: fd.flash_decode_plain(
            q[:b], k[:b], v[:b], lens[:b]), budget_s=1.0, max_reps=5)

    def library(b):
        def call():
            mask = (torch.arange(S, device=dev)[None, :]
                    < lens[:b, None])[:, None, None, :]
            return F.scaled_dot_product_attention(
                q[:b, :, None, :], k[:b].transpose(1, 2),
                v[:b].transpose(1, 2), attn_mask=mask,
                enable_gqa=True)[:, :, 0, :]
        return call(), clock.ms(call, budget_s=1.0, max_reps=10)

    plain_b, (pv, plain_ms) = _fits_or_smaller(plain, batches)
    err = float((kv[:plain_b].float() - pv.float()).abs().max())
    ratio = decode_tol_ratio(kv[:plain_b], pv)
    if ratio > 1.0:
        raise AssertionError(f"flash_decode at decode_32k: max abs err {err}"
                             f", {ratio} x the tolerance")
    b = plain_b
    fault = decode_tol_ratio(dropped_split(q[:b], k[:b], v[:b], lens[:b]),
                             pv)
    if fault <= 1.0:
        raise AssertionError(f"flash_decode at decode_32k: the check passed "
                             f"a split skipped ({fault} x the tolerance)")
    del pv
    torch.cuda.empty_cache()
    lib_b, (lv, lib_ms) = _fits_or_smaller(library, batches)
    lib_err = float((kv[:lib_b].float() - lv.float()).abs().max())
    del lv
    nbytes = (2 * B * S * KH * Dh * 2 + 2 * 2 * B * KH * G * Dh + 4 * B)
    bound_ms, bound_by = _bound(nbytes, 4 * B * KH * G * S * Dh)
    return [dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:106",
        launches=launches["flash_decode"],
        max_abs_err=max(err, errs["flash_decode"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms,
        shape=dict(batch=B, seq=S, kv_heads=KH, group=G, head_dim=Dh,
                   dtype="bfloat16", lengths="S", splits=-(-S // fd.split_len(S)),
                   plain_batch=plain_b, library_batch=lib_b,
                   tol_ratio=ratio, planted_fault_tol_ratio=fault,
                   library="scaled_dot_product_attention(enable_gqa=True, "
                           "length mask)",
                   library_max_abs_err=lib_err))]


# ---------------------------------------------------------------------------


# masked_distance's instances (queries × rows a block, blocks an SM)
MASKED_DISTANCE_INSTANCES = ((16, 128, 2), (64, 128, 2), (128, 64, 3))

# filtered_topk's partial-kernel instances (queries × rows a block, pool
# capacity), each compiled for three blocks an SM (ft.TILE_BLOCKS_PER_SM),
# and a (Q, k) that picks each
FILTERED_TOPK_INSTANCES = ((128, 64, 32), (32, 128, 32), (16, 128, 32),
                           (32, 128, 256), (16, 128, 256))
FILTERED_TOPK_PICKS = {(128, 32): (1024, 10), (32, 32): (32, 10),
                       (16, 32): (1, 10), (32, 256): (1024, 100),
                       (16, 256): (1, 256)}

# the kernel instances whose -Xptxas -v figures phase 2 reports by name:
# B6 as minitron_4b runs it (bf16, Dh 128, G 3 -> MAXG 4), B1's query-tile
# kernel and its one-query kernel for f32 / l2 without tombstones, B4's
# three instances, B3's five and its two merges (l2), B2's tile kernel by
# storage (f32, f16: gather_distance.TILE_STORAGES)
PTXAS_INSTANCES = {
    "flash_decode_partial<bf16, 128, 4>": (
        "flash_decode", "flash_decode_partialI13__nv_bfloat16Li128ELi4E"),
    "fused_scan_tile<f32, l2, no tomb, k' <= 32>": (
        "fused_scan", "fused_scan_tileILi0ELb1ELb0ELi1E"),
    "fused_scan_tile<f32, l2, no tomb, k' <= 64>": (
        "fused_scan", "fused_scan_tileILi0ELb1ELb0ELi2E"),
    "fused_scan_partial<f32, l2, no tomb>": (
        "fused_scan", "fused_scan_partialILi0ELb1ELb0E"),
    **{f"masked_distance_kernel<{bq} x {bn}, l2>": (
        "masked_distance",
        f"masked_distance_kernelILi{bq}ELi{bn}ELi{minb}ELb1E")
       for bq, bn, minb in MASKED_DISTANCE_INSTANCES},
    **{f"filtered_topk_partial<{bq} x {bn}, k <= {kcap}, l2>": (
        "filtered_topk",
        f"filtered_topk_partialILi{bq}ELi{bn}ELi3ELi{kcap}ELb1ELi0EE")
       for bq, bn, kcap in FILTERED_TOPK_INSTANCES},
    **{f"filtered_topk_merge<k <= {kcap}>": (
        "filtered_topk", f"filtered_topk_mergeILi{kcap}EE")
       for kcap in (32, 256)},
    **{f"seg_gather_tile_kernel<{name}, {metric}>": (
        "gather_distance", f"seg_gather_tile_kernelILi{dt}ELb{ip}E")
       for dt, name in enumerate(("f32", "fp16"))
       for ip, metric in ((0, "l2"), (1, "ip"))},
    **{f"graph_walk_kernel<{metric}, {copy}>": (
        "graph_walk", f"graph_walk_kernelILb{ip}ELb{vec}ELi0EE")
       for ip, metric in ((0, "l2"), (1, "ip"))
       for vec, copy in ((1, "16-byte copies"), (0, "4-byte copies"))},
}


def ptxas_figures(build_dir, sources=None) -> dict:
    """Registers, spills and shared memory of ``PTXAS_INSTANCES`` (of
    ``sources`` only, if given) from the compiler logs (``-Xptxas -v``)
    that the build keeps."""
    import re
    out = {}
    for label, (source, needle) in PTXAS_INSTANCES.items():
        if sources is not None and source not in sources:
            continue
        fn, fig = None, {}
        for line in (build_dir / f"{source}.log").read_text().splitlines():
            m = re.search(r"(?:entry function|Function properties for) "
                          r"'?([\w.$]+)", line)
            if m:
                fn = m.group(1)
                continue
            if fn is None or needle not in fn:
                continue
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    fig[key] = int(m.group(1))
        out[label] = fig or "not found in the log"
    return out


def dynamic_smem() -> dict:
    """Dynamic shared memory of the redesigned kernels' blocks, as the
    compiled libraries size them (and filtered_topk's blocks an SM); the
    Python copies of the fused scan's and the gather tile's layouts must
    agree."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import graph_walk as gw
    from repro_torch.kernels import masked_distance as md
    lib = cuda_build.load("fused_scan", fs._SIGNATURES)
    out = {}
    for dtype, code in fs._DTYPES.items():
        for kp, bq in ((10, 64), (40, 64), (10, 1)):
            got = lib.fused_scan_smem_bytes(code, 128, kp, bq)
            if got != fs.block_smem_bytes(128, kp, bq, dtype):
                raise AssertionError(
                    f"fused_scan.block_smem_bytes(128, {kp}, {bq}, {dtype}) "
                    f"is {fs.block_smem_bytes(128, kp, bq, dtype)}; the "
                    f"kernel's layout takes {got}")
            out[f"fused_scan {dtype} D 128 k' {kp} query tile {bq}"] = got
    out["flash_decode_partial<bf16, 128, 4>"] = cuda_build.load(
        "flash_decode", fd._SIGNATURES).flash_decode_smem_bytes(1, 128, 3)
    dist = cuda_build.load("masked_distance", md._SIGNATURES)
    for bq, bn, _ in MASKED_DISTANCE_INSTANCES:
        out[f"dense tile {bq} x {bn}"] = dist.masked_distance_smem_bytes(bq)
    topk = cuda_build.load("filtered_topk", ft._SIGNATURES)
    for (bq, bn, kcap) in FILTERED_TOPK_INSTANCES:
        Q, k0 = FILTERED_TOPK_PICKS[(bq, kcap)]
        if ft.query_tile(Q, k0) != bq:
            raise AssertionError(f"filtered_topk.query_tile({Q}, {k0}) is "
                                 f"{ft.query_tile(Q, k0)}, not {bq}")
        for k in sorted({k0, kcap, 1 if kcap == 32 else 33}):
            # the blocks an SM the span split aims at (the occupancy API)
            out[f"filtered_topk_partial {bq} x {bn} k {k}"] = dict(
                bytes=topk.filtered_topk_smem_bytes(Q, k),
                blocks_per_sm=ft.blocks_per_sm(topk, Q, k))
    gather = cuda_build.load("gather_distance", gd._SIGNATURES)
    for code, storage in enumerate(gd.TILE_STORAGES):
        got = gather.seg_gather_smem_bytes(code)
        if got != gd.tile_smem_bytes(storage):
            raise AssertionError(
                f"gather_distance.tile_smem_bytes({storage!r}) is "
                f"{gd.tile_smem_bytes(storage)}; the kernel's layout takes "
                f"{got}")
        out[f"seg_gather_tile_kernel {storage}"] = got
    walk = cuda_build.load("graph_walk", gw._SIGNATURES)
    for D, M, ef, W, vec in ((128, 16, 64, 1, True), (37, 8, 256, 2, False),
                             (1024, 32, 1024, 32, True)):
        got = walk.graph_walk_smem_bytes(D, M, ef, W, int(vec))
        if got != gw.walk_smem_bytes(D, M, ef, W, vec):
            raise AssertionError(
                f"graph_walk.walk_smem_bytes{(D, M, ef, W, vec)} is "
                f"{gw.walk_smem_bytes(D, M, ef, W, vec)}; the kernel's "
                f"layout takes {got}")
        out[f"graph_walk D {D} M {M} ef {ef} W {W} vec {vec}"] = got
    return out


def nvidia_smi(query: str = "name,power.limit") -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


# the card's state beside the kernel times (phase 5)
CARD_STATE = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


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
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import graph_walk as gw
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
                           .read_text().splitlines() if "Used" in line}),
             ptxas_by_kernel=ptxas_figures(cuda_build.BUILD_DIR),
             dynamic_smem_bytes=dynamic_smem())

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
    walk = graph_walk_checks(dev)
    checks["cases"] += walk["cases"]
    checks["max_abs_err"].update(walk["max_abs_err"])
    checks["graph_walk"] = {key: walk[key] for key in (
        "cases", "lanes", "hops", "max_hops",
        "planted_fault_lanes_differing", "tolerance")}
    dec = flash_decode_checks(dev)
    checks["cases"] += dec["cases"]
    checks["max_abs_err"].update(dec["max_abs_err"])
    checks["flash_decode_max_abs_err_by_dtype"] = dec["max_abs_err_by_dtype"]
    checks["flash_decode_tol_ratio_by_dtype"] = dec["tol_ratio_by_dtype"]
    checks["flash_decode_planted_fault_tol_ratio_by_dtype"] = dec[
        "planted_fault_tol_ratio_by_dtype"]
    checks["flash_decode_tolerance"] = dec["tolerance"]
    emit("kernels_vs_plain", seconds=time.perf_counter() - t0, **checks)
    t0 = time.perf_counter()
    emit("graph_build_vs_plain", **graph_build_checks(dev),
         seconds=time.perf_counter() - t0)

    wrappers = {"fused_scan": fs.fused_segmented_scan,
                "segmented_gather_distance": gd.segmented_gather_distance,
                "masked_distance": md.masked_distance,
                "filtered_topk": ft.filtered_topk,
                "gather_distance": gd.gather_distance,
                "graph_walk": gw.graph_walk,
                "flash_decode": fd.flash_decode}

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
    flat_index_k100(flat, data)
    (_, graph_eng), at_graph = drive(
        "graph_path", ("graph_walk", "masked_distance"),
        lambda: graph_path(dev, data=data, counts=counts, clock=clock))
    launches = dict(at_flat)
    for name in ("masked_distance", "filtered_topk"):
        launches[name] = at_ivf[name] + at_scan[name]
    launches["gather_distance"] = at_graph["gather_distance"]
    launches["graph_walk"] = at_graph["graph_walk"]
    drive("stream_path",
          ("fused_scan", "segmented_gather_distance", "masked_distance"),
          lambda: stream_path(dev, data=data, ctx=ctx, static=results,
                              ivf_eng=ivf_eng, counts=counts, clock=clock))
    torch.cuda.empty_cache()
    decode_state, at_decode = drive(
        "decode_path", ("flash_decode",), lambda: decode_path(dev))
    emit("decode_path_numbers", **decode_state["stats"],
         **decode_gates(decode_state))
    launches["flash_decode"] = at_decode["flash_decode"]
    del decode_state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    state_before = nvidia_smi(CARD_STATE)
    kernels = time_kernels(engines, (ctx["qv"], ctx["qls"]), clock, launches,
                           checks["max_abs_err"])
    kernels += time_dense_kernels(ivf_eng, flat, ctx, clock, launches,
                                  checks["max_abs_err"])
    kernels += time_graph_kernel(graph_eng, ctx, clock, launches,
                                 checks["max_abs_err"])
    del results, engines, ivf_eng, flat, graph_eng
    torch.cuda.empty_cache()
    kernels += time_decode_kernel(dev, clock, launches,
                                  checks["max_abs_err"])
    emit("kernel_times", seconds=time.perf_counter() - t0,
         card_state_query=CARD_STATE, card_state_before=state_before,
         card_state_after=nvidia_smi(CARD_STATE))
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(smi, flush=True)
    emit("total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
