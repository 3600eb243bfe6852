"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip without a card (a CUDA kernel has no CPU or
interpret mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jaxlib).  The same checks,
at the main path's shapes, run in ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    # torch is imported here, not at collection (see test_torch_engine.py)
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_port_on_the_card(dev):
    """Each kernel of the port against its plain version, then the engine
    or decoder that runs it, on the card: the four checks below, each run
    whatever the ones before it did, their failures reported together.
    They are one test and not four because the suite's collected count
    decides how pytest-xdist's load scheduler splits the reference
    suite's heaviest pair of tests across workers (ROADMAP C1)."""
    import traceback

    failed = []
    for check in (_segmented_kernels_and_flat_engine,
                  _dense_kernels_and_ivf_engine, _graph_kernels_and_engine,
                  _flash_decode_and_batched_decoder):
        try:
            check(dev)
        except Exception:
            failed.append(f"{check.__name__}:\n{traceback.format_exc()}")
    assert not failed, "\n".join(failed)


def _segmented_kernels_and_flat_engine(dev):
    """Every segmented kernel against its plain version (chip_smoke's
    phase-3 checks at a small size: B1 on runs of queries sharing a
    segment beside singletons, a run past the end of the row table,
    tombstones, f32 / fp16 / int8, l2 / ip, k' 10 and 40, at query tiles
    1, 8 and 64, bitwise equal to each other; B2 on runs of queries
    listing one window beside singletons, ragged lens, its tile schedule
    at 64, 16 and 12 queries a block bitwise its per-pair schedule), then
    the flat engine on the card: batched ≡ looped, fused and unfused."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.kernel_checks(dev, N=8192, Q=16, lmax=1024)
    # integer and random data × 3 storages × 2 metrics × the schedules
    assert out["cases"] > out["gather_run_cases"] == 2 * 3 * 2 * len(
        chip_smoke.GATHER_QTILES)

    from repro_torch.core import (LabelHybridEngine, LabelWorkloadConfig,
                                  generate_label_sets,
                                  generate_query_label_sets)
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import gather_distance as gd

    rng = np.random.default_rng(11)
    x = rng.standard_normal((5000, 64)).astype(np.float32)
    ls = generate_label_sets(5000, LabelWorkloadConfig(num_labels=10,
                                                       seed=3))
    qv = rng.standard_normal((120, 64)).astype(np.float32)
    qls = generate_query_label_sets(ls, 120, seed=4, from_base_fraction=0.75)
    for spec in ("f32", "int8+rerank"):
        for fused in (False, "auto"):
            eng = LabelHybridEngine.build(x, ls, storage=spec, fused=fused,
                                          device=dev)
            before = (fs.fused_segmented_scan.launches,
                      gd.segmented_gather_distance.launches)
            bd, bi = eng.search_batched(qv, qls, 7)
            ld, li = eng.search_looped(qv, qls, 7)
            np.testing.assert_array_equal(bi, li)
            np.testing.assert_array_equal(bd, ld)
            launched = (fs.fused_segmented_scan.launches - before[0],
                        gd.segmented_gather_distance.launches - before[1])
            assert launched[0 if fused else 1] > 0


def _dense_kernels_and_ivf_engine(dev):
    """The dense kernels against their plain versions (chip_smoke's phase-3
    checks at a small size: masked_distance at Q 1, 16, 17, 64, 65, 128 and
    256, one to each side of its three instances' edges, at D 127 and on
    unaligned operands, filtered_topk bitwise its values at k up to 256,
    on rows that all beat its thresholds, its planted faults caught), then
    the ivf engine and the private-copy FlatIndex on the card: batched ≡
    looped, launches counted, and the FlatIndex at k 10 and 100 equal to
    its plain version up to boundary ties."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import torch

    assert chip_smoke.dense_kernel_checks(dev, N=4099, D=64)["cases"] > 0

    from repro_torch.core import (LabelHybridEngine, LabelWorkloadConfig,
                                  encode_many, generate_label_sets,
                                  generate_query_label_sets,
                                  masks_to_int32_words)
    from repro_torch.index import FlatIndex
    from repro_torch.kernels import filtered_topk as ft
    from repro_torch.kernels import masked_distance as md

    rng = np.random.default_rng(11)
    x = rng.standard_normal((5000, 64)).astype(np.float32)
    ls = generate_label_sets(5000, LabelWorkloadConfig(num_labels=10,
                                                       seed=3))
    qv = rng.standard_normal((120, 64)).astype(np.float32)
    qls = generate_query_label_sets(ls, 120, seed=4, from_base_fraction=0.75)
    eng = LabelHybridEngine.build(x, ls, backend="ivf", nprobe=4, device=dev)
    before = md.masked_distance.launches
    bd, bi = eng.search_batched(qv, qls, 7, min_bucket=8)
    ld, li = eng.search_looped(qv, qls, 7)
    np.testing.assert_array_equal(bi, li)
    np.testing.assert_array_equal(bd, ld)
    assert md.masked_distance.launches > before

    lx = masks_to_int32_words(encode_many(ls))
    qw = masks_to_int32_words(encode_many(qls))
    for k in (10, 100):   # both pool capacities
        before = ft.filtered_topk.launches
        kd, ki = FlatIndex(x, lx, device=dev).search(qv, qw, k)
        pd, pi = FlatIndex(x, lx, kernel_backend="ref", device=dev).search(
            qv, qw, k)
        assert ft.filtered_topk.launches > before
        chip_smoke._compare(torch.from_numpy(kd), torch.from_numpy(ki),
                            torch.from_numpy(pd), torch.from_numpy(pi),
                            integer=False, int8=False,
                            tag=f"FlatIndex k={k} on the card")


def _graph_kernels_and_engine(dev):
    """B5, the walk kernel and the compiled reverse pass against their
    plain versions (chip_smoke's phase-3 checks at a small size: the walk
    bitwise the torch hop loop in every lane, both planted faults
    caught), then the graph engine on the card: batched ≡ looped, one
    ``graph_walk`` launch a routed group and no ``gather_distance``, and
    the ``"cuda"`` walks equal to the ``"ref"`` walks bit for bit, with
    their hops and distance computations."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.graph_kernel_checks(dev, N=4099)["cases"] > 0
    walk = chip_smoke.graph_walk_checks(dev, graphs=((4099, 37, 8),), Q=16)
    assert walk["cases"] == 2 * 2 * 2 * 2 * 2 + 2 * len(chip_smoke.WALK_WIDE)
    assert all(walk["planted_fault_lanes_differing"].values())
    built = chip_smoke.graph_build_checks(dev, n=600, n_random=400, D=64,
                                          M=8, n_cand=16)
    assert built["integer"]["identical_rows"] == 1.0
    assert built["random"]["compiled_reverse_equals_plain"]

    from repro_torch.core import (LabelHybridEngine, LabelWorkloadConfig,
                                  generate_label_sets,
                                  generate_query_label_sets)
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import graph_walk as gw

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    ls = generate_label_sets(3000, LabelWorkloadConfig(num_labels=10,
                                                       seed=3))
    qv = rng.standard_normal((120, 64)).astype(np.float32)
    qls = generate_query_label_sets(ls, 120, seed=4, from_base_fraction=0.75)
    eng = LabelHybridEngine.build(x, ls, backend="graph", M=8, n_cand=16,
                                  ef_search=32, device=dev)
    before = (gd.gather_distance.launches, gw.graph_walk.launches)
    bd, bi = eng.search_batched(qv, qls, 7, min_bucket=8)
    assert gd.gather_distance.launches == before[0]
    assert gw.graph_walk.launches - before[1] == len(set(eng.route_many(qls)))
    ld, li = eng.search_looped(qv, qls, 7)
    np.testing.assert_array_equal(bi, li)
    np.testing.assert_array_equal(bd, ld)
    out = chip_smoke._graph_cuda_vs_ref(eng, qv, [tuple(s) for s in qls], 7,
                                        list(range(120)))
    assert out["equal"] == out["hops_equal"] == out["dist_comps_equal"] \
        == 120


def _flash_decode_and_batched_decoder(dev):
    """B6 against its plain version (chip_smoke's phase-3 checks at a
    smaller S: rows bitwise equal at B 1, 7 and 128, a split left out
    rejected), then reduced minitron_4b served by a BatchedDecoder on the
    card: batched ≡ sequential bitwise, the kernel launched once per layer
    per decode step."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import torch

    out = chip_smoke.flash_decode_checks(dev, long_s=8192, mid_s=1024,
                                         batch=128)
    assert out["cases"] > 0

    from repro_torch import arch as A
    from repro_torch.configs import reduced_arch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.common import init_params
    from repro_torch.serve import BatchedDecoder, Request

    spec = reduced_arch("minitron_4b")
    params = init_params(torch.Generator(device=dev).manual_seed(0),
                         A.param_specs(spec))
    dec = BatchedDecoder(spec, params, 3, 64, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 7, 6)]
    solo = [dec.run([Request(prompt=p, max_new=8)])[0].generated
            for p in prompts]
    before, steps = fd.flash_decode.launches, dec.steps
    done = sorted(dec.run([Request(prompt=p, max_new=8, rid=i)
                           for i, p in enumerate(prompts)]),
                  key=lambda r: r.rid)
    assert [r.generated for r in done] == solo
    assert fd.flash_decode.launches - before \
        == spec.cfg.n_layers * (dec.steps - steps)
