"""The flat backend (port of ``repro/index/flat.py``).

Two forms of one index family:

  * :class:`FlatArenaView` — the zero-copy view the engine builds per
    selected index over its shared arena (the registry entry's
    ``build_view`` capability makes the engine arena-native);
  * :class:`FlatIndex` — a private copy of its rows on the device,
    searched by the dense ``filtered_topk`` kernel: the whole-dataset
    PostFiltering scan, and the building block of a private-storage
    selection.  The engine never builds it: the ``flat`` backend always
    takes ``build_view``, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .base import (Arena, bucket_cache, pad_to_bucket, pow2_bucket,
                   register_index, resolve_device)


@register_index("flat")
class FlatIndex:
    """Brute-force filtered scan over a private copy of the rows."""

    supports_tombstones = True   # bitmap over LOCAL rows

    def __init__(self, vectors: np.ndarray, label_words: np.ndarray,
                 metric: str = "l2", kernel_backend: str | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.vectors = torch.as_tensor(
            np.ascontiguousarray(vectors, dtype=np.float32), device=self.device)
        self.label_words = torch.as_tensor(
            np.ascontiguousarray(label_words, dtype=np.int32),
            device=self.device)
        self.metric = metric
        self.kernel_backend = kernel_backend or ops.default_backend(
            self.device)
        self.num_vectors, self.dim = self.vectors.shape

    @classmethod
    def build(cls, vectors, label_words, metric: str = "l2", **params):
        return cls(vectors, label_words, metric, **params)

    @classmethod
    def build_view(cls, arena: Arena, rows_concat, start: int, length: int, *,
                   metric: str = "l2", **params) -> "FlatArenaView":
        """Arena-native capability: materialize a selected index as a
        zero-copy view over the engine's shared arena."""
        return FlatArenaView(arena, rows_concat, start, length,
                             metric=metric, **params)

    def _topk(self, q, lq, k: int, tomb=None):
        return ops.filtered_topk(q, self.vectors, lq, self.label_words, k=k,
                                 metric=self.metric,
                                 backend=self.kernel_backend, tomb=tomb,
                                 device=self.device)

    def search(self, queries: np.ndarray, query_label_words: np.ndarray,
               k: int, tomb=None) -> tuple[np.ndarray, np.ndarray]:
        """Un-bucketed search: (dists [Q, k], local ids [Q, k]) on the
        host; id == ``num_vectors`` ⇒ empty slot."""
        vals, idxs = self._topk(queries, query_label_words, k, tomb)
        return vals.cpu().numpy(), idxs.cpu().numpy()

    def search_padded(self, queries: np.ndarray,
                      query_label_words: np.ndarray,
                      k: int, tomb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket-shaped search for the batched executor: device tensors
        [bucket, k] through the per-``(k, bucket)`` dispatch table; the
        caller slices the pad rows off.  ``tomb`` is a packed bitmap over
        local rows."""
        cache = bucket_cache(self)
        bucket = queries.shape[0]
        fn = cache.get((k, bucket))
        if fn is None:
            def fn(q, lq, tomb=None, _k=k):
                return self._topk(q, lq, _k, tomb)
            cache[(k, bucket)] = fn
        return fn(queries, query_label_words, tomb)

    @property
    def nbytes(self) -> int:
        return (self.vectors.numel() * self.vectors.element_size()
                + self.label_words.numel() * self.label_words.element_size())


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
