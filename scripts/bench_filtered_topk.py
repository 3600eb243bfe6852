#!/usr/bin/env python3
"""B3 (filtered_topk) of several trees side by side on one NVIDIA card,
with B4 (masked_distance) at B3's shape as the yardstick.

    python3 scripts/bench_filtered_topk.py                  # this checkout
    python3 scripts/bench_filtered_topk.py PARENT . . PARENT

Draws ``chip_smoke.py``'s paper-scale data once (10^6 × 128 rows, 1,000
queries on a 1,024 bucket), then for each tree in the order given (a
directory holding ``src/repro_torch``; a tree named twice is timed
twice) builds its two kernels from its own sources into its own
``build/``, holds its B3 at [1024, 10^6] and [32, 10^6], k 10, against
the plain version, and times with CUDA events (``chip_smoke.Clock``) B3
at [1024, 10^6], k 10, 100 and 256, and at [32, 10^6], k 10, and B4 at
[1024, 10^6].  One JSON line, then the card's name and power limit as
``nvidia-smi`` reports them.  Without a card it exits 2.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = (("b3_q1024_k10", 1024, 10), ("b3_q32_k10", 32, 10),
          ("b3_q1024_k100", 1024, 100), ("b3_q1024_k256", 1024, 256))


def use_tree(root: Path):
    """Import ``repro_torch``'s kernels from ``root`` alone."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path[:] = [p for p in sys.path if not p.endswith("/src")]
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md
    return cuda_build, ft, md


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_filtered_topk: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in sys.argv[1:]] or [HERE]
    sys.path.insert(0, str(HERE))
    import chip_smoke

    dev = torch.device("cuda", 0)
    use_tree(trees[0])
    from repro_torch.core import encode_many, masks_to_int32_words
    vectors, label_sets, qv, qls = chip_smoke.paper_data(10**6)
    x = torch.from_numpy(vectors).to(dev)
    lx = torch.from_numpy(masks_to_int32_words(encode_many(label_sets))
                          ).to(dev)
    q = torch.zeros((1024, x.shape[1]), dtype=torch.float32, device=dev)
    lq = torch.zeros((1024, lx.shape[1]), dtype=torch.int32, device=dev)
    q[:len(qv)] = torch.from_numpy(qv).to(dev)
    lq[:len(qls)] = torch.from_numpy(masks_to_int32_words(encode_many(qls))
                                     ).to(dev)
    del vectors, label_sets
    clock = chip_smoke.Clock(dev)
    runs, plain = [], {}
    for root in trees:
        cuda_build, ft, md = use_tree(root)
        nvcc_s = cuda_build.build(("filtered_topk", "masked_distance"))
        ms = {}
        for name, nq, k in SHAPES:
            a = (q[:nq], x, lq[:nq], lx)
            if k == 10:
                if nq not in plain:
                    plain[nq] = ft.filtered_topk_plain(*a, k=k)
                chip_smoke._compare(*ft.filtered_topk(*a, k=k), *plain[nq],
                                    integer=False, int8=False,
                                    tag=f"{root} {name}")
            ms[name] = clock.ms(lambda a=a, k=k: ft.filtered_topk(*a, k=k))
        ms["b4_q1024"] = clock.ms(lambda: md.masked_distance(q, x, lq, lx))
        runs.append(dict(root=str(root), nvcc_seconds=nvcc_s, ms=ms,
                         card_state=chip_smoke.nvidia_smi(
                             chip_smoke.CARD_STATE)))
    print(json.dumps(dict(runs=runs), default=float), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
