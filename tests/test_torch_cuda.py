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


def test_kernels_and_engine_on_the_card(dev):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.kernel_checks(dev, N=8192, Q=16, lmax=1024)
    assert out["cases"] > 0

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


def test_private_kernels_and_ivf_on_the_card(dev):
    """The dense kernels against their plain versions (chip_smoke's phase-3
    checks at a small size), then the ivf engine and the private-copy
    FlatIndex on the card: batched ≡ looped, launches counted, and the
    FlatIndex equal to its plain version up to boundary ties."""
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
    before = ft.filtered_topk.launches
    kd, ki = FlatIndex(x, lx, device=dev).search(qv, qw, 10)
    pd, pi = FlatIndex(x, lx, kernel_backend="ref", device=dev).search(
        qv, qw, 10)
    assert ft.filtered_topk.launches > before
    chip_smoke._compare(torch.from_numpy(kd), torch.from_numpy(ki),
                        torch.from_numpy(pd), torch.from_numpy(pi),
                        integer=False, int8=False, tag="FlatIndex on the card")


def test_graph_kernel_and_build_on_the_card(dev):
    """B5 and the compiled reverse pass against their plain versions
    (chip_smoke's phase-3 checks at a small size), then the graph engine
    on the card: batched ≡ looped, ``gather_distance`` launched, and the
    ``"cuda"`` walks equal to the ``"ref"`` walks."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.graph_kernel_checks(dev, N=4099)["cases"] > 0
    built = chip_smoke.graph_build_checks(dev, n=600, n_random=400, D=64,
                                          M=8, n_cand=16)
    assert built["integer"]["identical_rows"] == 1.0
    assert built["random"]["compiled_reverse_equals_plain"]

    from repro_torch.core import (LabelHybridEngine, LabelWorkloadConfig,
                                  generate_label_sets,
                                  generate_query_label_sets)
    from repro_torch.kernels import gather_distance as gd

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    ls = generate_label_sets(3000, LabelWorkloadConfig(num_labels=10,
                                                       seed=3))
    qv = rng.standard_normal((120, 64)).astype(np.float32)
    qls = generate_query_label_sets(ls, 120, seed=4, from_base_fraction=0.75)
    eng = LabelHybridEngine.build(x, ls, backend="graph", M=8, n_cand=16,
                                  ef_search=32, device=dev)
    before = gd.gather_distance.launches
    bd, bi = eng.search_batched(qv, qls, 7, min_bucket=8)
    ld, li = eng.search_looped(qv, qls, 7)
    np.testing.assert_array_equal(bi, li)
    np.testing.assert_array_equal(bd, ld)
    assert gd.gather_distance.launches > before
    out = chip_smoke._graph_cuda_vs_ref(eng, qv, [tuple(s) for s in qls], 7,
                                        list(range(120)))
    assert out["equal"] + out["value_ties"] == 120
