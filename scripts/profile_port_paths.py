#!/usr/bin/env python3
"""Where the time goes on the port's search paths, on one NVIDIA card.

    python3 scripts/profile_port_paths.py      # from the repository root

Builds ``chip_smoke.py``'s paper-scale workload (1,000,000 × 128 vectors,
1,000 queries, one EIS selection at c = 0.2), then three searchers over
it: the f32 flat engine with the fused scan (the main path), the engine on
the ``ivf`` backend and the private-copy ``FlatIndex`` over every row;
then the engine on the ``graph`` backend over the first 100,000 rows with
its own selection (``chip_smoke.py``'s phase 4d at its smallest N).
Each is warmed with two 1,000-query batches, then one batch is traced
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
    vectors, label_sets, qv, qls = chip_smoke.paper_data(
        chip_smoke.PAPER["n_vectors"])
    qkeys = observed_query_keys(qls)
    table = GroupTable.build(label_sets, qkeys)
    selection = greedy_eis(table.closure_sizes,
                           chip_smoke.PAPER["elastic_bound"], qkeys)
    k = chip_smoke.PAPER["k"]
    searchers = {}
    flat_eng = LabelHybridEngine(vectors, label_sets, table, selection, None,
                                 "flat", "l2", {"fused": "auto"}, 0.0,
                                 device=dev)
    searchers["flat engine, f32, fused"] = \
        lambda: flat_eng.search_batched(qv, qls, k)
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
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
