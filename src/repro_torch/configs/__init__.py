"""One module per ported architecture (exact published configs, copied
from the JAX package's ``repro.configs``).

``reduced_arch(arch_id)`` shrinks a config to a CPU-runnable size (same
topology, tiny dims), exactly as the JAX package's does for transformers.
"""
from __future__ import annotations

import dataclasses

from ..arch import ArchSpec, get_arch


def reduced_arch(arch_id: str) -> ArchSpec:
    arch = get_arch(arch_id)
    small = dataclasses.replace(
        arch.cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(arch.cfg.n_kv_heads, 2), head_dim=16, d_ff=128,
        vocab=512)
    return dataclasses.replace(arch, cfg=small)
