#!/usr/bin/env python3
"""Where the time goes on the port's search paths, on one NVIDIA card.

    python3 scripts/profile_port_paths.py          # from the repository root
    python3 scripts/profile_port_paths.py decode   # the decoder only
    python3 scripts/profile_port_paths.py flat     # the flat engines only
    python3 scripts/profile_port_paths.py graph [ROWS]   # the graph engine
    python3 scripts/profile_port_paths.py flatindex      # the FlatIndex

Builds ``chip_smoke.py``'s paper-scale workload (1,000,000 × 128 vectors,
1,000 queries, one EIS selection at c = 0.2), then the searchers over
it: the flat engines (f32 with the fused scan, the main path; f32 and
int8+rerank unfused, through the segmented gather), the engine on the
``ivf`` backend and the private-copy ``FlatIndex`` over every row;
then the engine on the ``graph`` backend over the first 100,000 rows with
its own selection (``chip_smoke.py``'s phase 4d at its smallest N); then
``minitron_4b`` at full width (``chip_smoke.py``'s phase 4e): one
prefill of a 300-token prompt and one decode step of 8 live slots.
``flatindex`` traces the private-copy ``FlatIndex`` over every row alone
(one ``filtered_topk`` launch a batch, and its merge).
``graph`` traces the graph engine alone over the first ROWS rows
(default 200,000, the row count ``chip_smoke.py``'s phase 4d reaches on
an H100 host), each routed group one launch of the walk kernel.
Each is warmed with two calls (for a searcher, 1,000-query batches),
then one call is traced
with ``torch.profiler`` (CPU and CUDA activities).  One JSON line per
searcher: the batch's wall time, the device time the trace saw (the sum
of its kernels' device time: one stream, so they do not overlap), the
device's idle share of the wall time, the number of kernel launches, and
the five kernels with the most device time.  Then the card's name and
power limit as ``nvidia-smi`` reports them.  Without a card it exits 2.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile(search, dev):
    """Trace one call of ``search`` (after two warm calls)."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(2):
        search()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.self_device_time_total, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_us = sum(us for us, _, _ in kernels)
    return dict(wall_ms=wall_us / 1e3, device_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / wall_us,
                kernel_launches=sum(n for _, n, _ in kernels),
                top=[dict(name=name[:80], ms=us / 1e3, calls=n)
                     for us, n, name in kernels[:5]])


def decode_searchers(dev, chip_smoke):
    """Phase 4e's decoder with its 8 slots filled: one prefill and one
    decode step to trace (the step advances the slots; ``max_new`` 32
    leaves room for the warm calls)."""
    import numpy as np
    import torch

    from repro_torch import arch as A
    from repro_torch.models import common
    from repro_torch.serve import BatchedDecoder, Request

    c = chip_smoke.DECODE
    spec = A.get_arch(c["arch"])
    params = common.init_params(
        torch.Generator(device=dev).manual_seed(c["seed"]),
        A.param_specs(spec))
    dec = BatchedDecoder(spec, params, c["slots"], c["max_len"], device=dev)
    rng = np.random.default_rng(c["seed"])
    for _ in range(c["slots"]):
        dec.admit(Request(prompt=rng.integers(0, spec.cfg.vocab, 300)
                          .astype(np.int32), max_new=c["max_new"]))
    prefill = A.make_prefill(spec, c["max_len"])
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, spec.cfg.vocab, (1, 300))).to(dev),
             "positions": torch.arange(300, dtype=torch.int32,
                                       device=dev)[None]}
    return {"minitron_4b prefill, 300 tokens":
            lambda: prefill(params, batch),
            "minitron_4b decode step, 8 slots": dec.step}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_port_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.core import (GroupTable, LabelHybridEngine, encode_many,
                                  greedy_eis, masks_to_int32_words,
                                  observed_query_keys)
    from repro_torch.index import FlatIndex
    from repro_torch.kernels import cuda_build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build()
    if sys.argv[1:] == ["decode"]:
        for name, run in decode_searchers(dev, chip_smoke).items():
            print(json.dumps({"searcher": name, **profile(run, dev)},
                             default=float), flush=True)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    vectors, label_sets, qv, qls = chip_smoke.paper_data(
        chip_smoke.PAPER["n_vectors"])
    k = chip_smoke.PAPER["k"]
    if sys.argv[1:] == ["flatindex"]:
        flat = FlatIndex(vectors, masks_to_int32_words(
            encode_many(label_sets)), device=dev)
        qw = masks_to_int32_words(encode_many(qls))
        print(json.dumps({"searcher": "FlatIndex, all rows",
                          "queries": len(qls), **profile(
                              lambda: flat.search(qv, qw, k), dev)},
                         default=float), flush=True)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    if sys.argv[1:2] == ["graph"]:
        rows = int(sys.argv[2]) if len(sys.argv) > 2 else 200_000
        graph_eng, built = chip_smoke._graph_engine(
            dev, (vectors, label_sets, qv, qls), rows)
        print(json.dumps({"searcher": f"graph engine, {rows} rows",
                          "queries": len(qls), "indexes": len(
                              graph_eng.indexes), **built,
                          **profile(lambda: graph_eng.search_batched(
                              qv, qls, k), dev)}, default=float), flush=True)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    qkeys = observed_query_keys(qls)
    table = GroupTable.build(label_sets, qkeys)
    selection = greedy_eis(table.closure_sizes,
                           chip_smoke.PAPER["elastic_bound"], qkeys)
    searchers = {}
    flat_eng = LabelHybridEngine(vectors, label_sets, table, selection, None,
                                 "flat", "l2", {"fused": "auto"}, 0.0,
                                 device=dev)
    searchers["flat engine, f32, fused"] = \
        lambda: flat_eng.search_batched(qv, qls, k)
    for storage in ("f32", "int8+rerank"):
        eng = LabelHybridEngine(vectors, label_sets, table, selection, None,
                                "flat", "l2", {"fused": False}, 0.0,
                                storage=storage, device=dev)
        searchers[f"flat engine, {storage}, unfused"] = \
            lambda eng=eng: eng.search_batched(qv, qls, k)
    if sys.argv[1:] == ["flat"]:
        for name, search in searchers.items():
            print(json.dumps({"searcher": name, "queries": len(qls),
                              **profile(search, dev)}, default=float),
                  flush=True)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    ivf_eng = LabelHybridEngine(vectors, label_sets, table, selection, None,
                                "ivf", "l2", {}, 0.0, device=dev)
    searchers["ivf engine"] = lambda: ivf_eng.search_batched(qv, qls, k)
    flat = FlatIndex(vectors, masks_to_int32_words(encode_many(label_sets)),
                     device=dev)
    searchers["FlatIndex, all rows"] = lambda: flat.search(
        qv, masks_to_int32_words(encode_many(qls)), k)
    graph_eng, _ = chip_smoke._graph_engine(
        dev, (vectors, label_sets, qv, qls), chip_smoke.GRAPH_ROWS[0])
    searchers["graph engine, 100k rows"] = \
        lambda: graph_eng.search_batched(qv, qls, k)
    for name, search in searchers.items():
        print(json.dumps({"searcher": name, "queries": len(qls),
                          **profile(search, dev)}, default=float),
              flush=True)
    del searchers, flat_eng, eng, ivf_eng, flat, graph_eng
    torch.cuda.empty_cache()
    for name, run in decode_searchers(dev, chip_smoke).items():
        print(json.dumps({"searcher": name, **profile(run, dev)},
                         default=float), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
