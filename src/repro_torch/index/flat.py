"""The arena-native flat backend (port of ``repro/index/flat.py``).

Only the arena-native half is ported: :class:`FlatArenaView`, the
zero-copy view the engine builds per selected index, and the registry
entry whose ``build_view`` capability makes the engine arena-native.  The
private-copy ``FlatIndex`` (the dense ``filtered_topk`` kernel) is ROADMAP
queue B3; its ``build`` raises until then.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .base import Arena, bucket_cache, pad_to_bucket, pow2_bucket, register_index


@register_index("flat")
class FlatIndex:
    """Registry entry of the flat backend."""

    supports_tombstones = True

    @classmethod
    def build(cls, vectors, label_words, metric: str = "l2", **params):
        raise NotImplementedError(
            "the private-copy FlatIndex (dense filtered_topk kernel) is not "
            "ported yet (ROADMAP queue B3); the engine uses build_view")

    @classmethod
    def build_view(cls, arena: Arena, rows_concat, start: int, length: int, *,
                   metric: str = "l2", **params) -> "FlatArenaView":
        """Arena-native capability: materialize a selected index as a
        zero-copy view over the engine's shared arena."""
        return FlatArenaView(arena, rows_concat, start, length,
                             metric=metric, **params)


class FlatArenaView:
    """Zero-copy flat index over a segment of the engine's shared arena.

    The selected index is the ``[start, start+length)`` span of the
    engine's CSR row-id table; search runs the same ``ops.segmented_topk``
    as the batched executor, with this view's segment broadcast over the
    bucket, so the looped and batched executors run the same arithmetic.
    ``search``/``search_padded`` return LOCAL ids (segment positions; id
    == ``num_vectors`` ⇒ empty slot); ``nbytes`` is 0 — the arena and the
    segment table are counted once at the engine.
    """

    backend_name = "flat"
    arena_native = True
    supports_tombstones = True   # bitmap in ARENA row space

    def __init__(self, arena: Arena, rows_concat, start: int, length: int, *,
                 metric: str = "l2", kernel_backend: str = "ref",
                 fused=False):
        self.arena = arena
        self._rows = rows_concat           # device int32 [R] (engine-shared)
        self.start = int(start)
        self.length = int(length)
        self.metric = metric
        self.kernel_backend = kernel_backend
        self.num_vectors = self.length
        self.fused = fused
        self.dim = arena.dim

    def search(self, queries: np.ndarray, query_label_words: np.ndarray,
               k: int, tomb=None) -> tuple[np.ndarray, np.ndarray]:
        return pad_to_bucket(self.search_padded, queries, query_label_words,
                             k, self.length, tomb=tomb)

    def search_padded(self, queries: np.ndarray,
                      query_label_words: np.ndarray,
                      k: int, tomb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket-shaped search over the view's segment; returns device
        tensors [bucket, k].  ``tomb`` is indexed by the shared arena's
        global rows."""
        cache = bucket_cache(self)
        bucket = queries.shape[0]
        fn = cache.get((k, bucket))
        if fn is None:
            lmax = pow2_bucket(self.length)

            def fn(q, lq, tomb=None, _k=k, _lmax=lmax):
                shape = (q.shape[0],)
                starts = np.full(shape, self.start, np.int32)
                lens = np.full(shape, self.length, np.int32)
                vals, pos, _ = ops.segmented_topk(
                    q, lq, self.arena.vectors, self.arena.label_words,
                    self.arena.norms, self._rows, starts, lens, k=_k,
                    lmax=_lmax, metric=self.metric,
                    backend=self.kernel_backend, tomb=tomb,
                    fused=self.fused, device=self.arena.device,
                    **self.arena.tier_kwargs())
                ids = torch.where(pos >= self.length, self.length, pos)
                return vals, ids.to(torch.int32)
            cache[(k, bucket)] = fn
        return fn(queries, query_label_words, tomb)

    @property
    def nbytes(self) -> int:
        return 0
