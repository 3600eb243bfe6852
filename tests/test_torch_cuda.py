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
