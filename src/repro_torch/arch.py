"""Architecture registry, transformer family only (port of the serving
subset of ``repro/arch.py``): one :class:`ArchSpec` per ported config
(``repro_torch.configs``), and the prefill / decode step functions and
caches a server drives.  Training, sharding rules and the dry-run
cells stay in the JAX package (ROADMAP queue A item 9)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from .models import transformer as tf
from .models.common import count_params


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # transformer (the only one ported)
    cfg: Any


ARCH_IDS = ["starcoder2_7b", "minitron_4b"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"{arch_id!r} is not ported; the port has "
                       f"{ARCH_IDS}")
    return importlib.import_module(f".configs.{arch_id}", __package__).ARCH


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def _transformer(arch: ArchSpec) -> None:
    if arch.family != "transformer":
        raise NotImplementedError(f"family {arch.family!r} is not ported")


def param_specs(arch: ArchSpec):
    _transformer(arch)
    return tf.transformer_specs(arch.cfg)


def count_total_params(arch: ArchSpec) -> int:
    return count_params(param_specs(arch))


def init_caches(arch: ArchSpec, batch: int, max_len: int, device):
    """Zeroed KV caches for ``batch`` rows of ``max_len`` slots (one
    {"k", "v"} per layer)."""
    _transformer(arch)
    return tf.init_caches(arch.cfg, batch, max_len, device)


def make_prefill(arch: ArchSpec, max_len: int) -> Callable:
    _transformer(arch)
    cfg = arch.cfg
    return lambda p, b: tf.prefill(p, b["tokens"], b["positions"], cfg,
                                   max_len)


def make_decode(arch: ArchSpec) -> Callable:
    """``decode(params, caches, {"token", "position"}, backend=None)``."""
    _transformer(arch)
    cfg = arch.cfg
    return lambda p, c, b, backend=None: tf.decode_step(
        p, c, b["token"], b["position"], cfg, backend=backend)
