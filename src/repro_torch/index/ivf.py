"""IVFIndex — inverted-file backend (port of ``repro/index/ivf.py``).

A k-means coarse quantizer with the rows stored cluster-major, searched
with the paper's incremental PostFiltering semantics: probe the ``nprobe``
nearest clusters and, while fewer than k rows pass the label filter,
double the probe set (the k+1 expansion of Lemma 3.2 at cluster
granularity).

The search is the JAX package's de-sequentialized program, op for op:
static wave boundaries (``nprobe, 3·nprobe, 7·nprobe, …``), one dense
masked-distance pass over every row, exact per-cluster passing counts,
the stopping boundary by argmax, and the rows scattered into probe order
so the final (value, position) top-k reproduces the sequential probe
loop's (probe-order, storage-order) tie-break.  Both distance passes —
queries against centroids (all-zero query words, which pass every row)
and queries against rows — run through ``ops.masked_distance``: the
hand-written kernel on ``"cuda"``, its plain version on ``"ref"``.  Its
sums do not depend on the batch, so batched ≡ looped holds here, where
the reference's matmul drifts with the Q-bucket (ROADMAP C1).

Build: Lloyd iterations in plain torch (``torch.matmul`` for the
assignment distances, a one-hot product for the cluster sums — no float
atomics), with the initial centroids drawn by an explicit
``torch.Generator``.  ``torch`` cannot reproduce ``jax.random``, so
:meth:`IVFIndex.from_reference_state` installs a JAX index's clusters
as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops, ref
from .base import bucket_cache, pad_to_bucket, register_index, resolve_device

ROWS_PER_CHUNK = 1 << 16    # k-means rows per assignment / one-hot product


def _assign(x, xn, cents):
    """Nearest centroid of every row (the first on ties), in row chunks."""
    cn = torch.sum(cents * cents, dim=1)[None, :]
    return torch.cat([
        torch.argmin(xn[i:i + ROWS_PER_CHUNK] - 2 * x[i:i + ROWS_PER_CHUNK]
                     @ cents.T + cn, dim=1)
        for i in range(0, x.shape[0], ROWS_PER_CHUNK)])


def kmeans(x: torch.Tensor, n_clusters: int, iters: int, seed: int = 0):
    """Lloyd's k-means on ``x`` [n, d] f32: (centroids [c, d], assignment
    [n] int64).  Empty clusters keep their centroid.  Deterministic on
    every device: the cluster sums are one-hot products summed over row
    chunks in order, the counts integer."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(seed)
    init = torch.randperm(n, generator=gen)[:n_clusters].to(x.device)
    cents = x[init]
    xn = torch.sum(x * x, dim=1, keepdim=True)
    for _ in range(iters):
        assign = _assign(x, xn, cents)
        sums = torch.zeros_like(cents)
        for i in range(0, n, ROWS_PER_CHUNK):
            onehot = torch.nn.functional.one_hot(
                assign[i:i + ROWS_PER_CHUNK], n_clusters).to(x.dtype)
            sums += onehot.T @ x[i:i + ROWS_PER_CHUNK]
        counts = torch.bincount(assign, minlength=n_clusters)[:, None]
        cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                            cents)
    return cents, _assign(x, xn, cents)


def wave_boundaries(n_clusters: int, nprobe: int) -> tuple[int, ...]:
    """Cumulative probed-cluster counts after each doubling wave, clamped at
    the cluster count: ``nprobe, 3·nprobe, 7·nprobe, …, n_clusters``."""
    bounds: list[int] = []
    probed, wave = 0, max(nprobe, 1)
    while probed < n_clusters:
        probed = min(probed + wave, n_clusters)
        bounds.append(probed)
        wave *= 2
    return tuple(bounds)


def ivf_padded_topk(ix: "IVFIndex", q, lq, tomb=None, *, k: int,
                    backend: str):
    """Batched incremental-probe IVF search over ``ix``'s device tensors.
    ``q`` [Q, D] f32, ``lq`` [Q, W] i32 on ``ix.device``; ``tomb`` an
    optional packed bitmap over ORIGINAL local ids, AND-ed into the pass
    mask before the wave counts (deleted rows widen the probe set exactly
    as filtered-out ones do).  Returns (vals [Q, k] asc, ids [Q, k] int32
    original-local; id == N ⇒ empty slot)."""
    N, C = ix.num_vectors, ix.n_clusters
    Q = q.shape[0]
    dev = q.device

    # 1. probe order: stable sort of the centroid distances (ties toward
    #    the lower centroid id), inverted to a per-cluster probe rank
    cd = ops.masked_distance(q, ix._cents, torch.zeros_like(lq), ix._cwords,
                             metric=ix.metric, backend=backend, device=dev)
    order_c = torch.argsort(cd, dim=1, stable=True)
    rank_c = torch.empty_like(order_c).scatter_(
        1, order_c, torch.arange(C, device=dev).expand(Q, C))

    # 2. distance + label filter over ALL rows; tombstones AND into the mask
    d = ops.masked_distance(q, ix._xb, lq, ix._lxw, metric=ix.metric,
                            backend=backend, device=dev)
    passing = torch.isfinite(d)
    if tomb is not None:
        passing &= ref.tombstone_mask(tomb, ix._row_map_dev)[None, :]

    # 3. Lemma 3.2 continuation: exact per-cluster passing counts (rows are
    #    cluster-major, so a prefix-sum difference), summed over the
    #    probe-order prefix at each wave boundary; the probed prefix P is
    #    the first boundary holding >= k passing rows, else every cluster
    csum = torch.nn.functional.pad(
        torch.cumsum(passing, dim=1, dtype=torch.int32), (1, 0))
    cnt = csum[:, ix._offsets_dev[1:]] - csum[:, ix._offsets_dev[:-1]]
    cum = torch.cumsum(torch.gather(cnt, 1, order_c), dim=1)
    totals = cum[:, ix._bounds_dev - 1]
    met = totals >= k
    first = torch.argmax(met.to(torch.int32), dim=1)
    P = torch.where(met.any(dim=1), ix._bounds_dev[first],
                    ix._bounds_dev[-1])

    # 4. keep passing rows whose cluster lies in the probed prefix
    row_rank = torch.gather(rank_c, 1, ix._row_cluster.expand(Q, N))
    d = torch.where(passing & (row_rank < P[:, None]), d,
                    torch.full_like(d, ref.INF))

    # 5. scatter rows into probe order (probe-prefix start of the row's
    #    cluster + its offset within it), so the (value, position) top-k
    #    breaks ties as the sequential scan does
    sz_sorted = ix._cluster_sizes[order_c]
    start_sorted = torch.cumsum(sz_sorted, dim=1) - sz_sorted
    pos = torch.gather(start_sorted, 1, row_rank) + ix._row_in_cluster
    dp = torch.empty_like(d).scatter_(1, pos, d)
    perm = torch.empty_like(pos).scatter_(
        1, pos, torch.arange(N, device=dev).expand(Q, N))
    if k > N:
        dp = torch.nn.functional.pad(dp, (0, k - N), value=ref.INF)
        perm = torch.nn.functional.pad(perm, (0, k - N))
    vals, pos_k = ref.lex_topk(dp, k)
    stored = torch.gather(perm, 1, pos_k)
    empty = torch.isinf(vals)
    ids = torch.where(empty, N,
                      ix._row_map_dev[torch.clamp(stored, 0, max(N - 1, 0))])
    vals = torch.where(empty, ref.INF, vals)
    return vals, ids.to(torch.int32)


@register_index("ivf")
class IVFIndex:
    supports_tombstones = True   # bitmap over ORIGINAL local rows

    def __init__(self, vectors: np.ndarray, label_words: np.ndarray,
                 metric: str = "l2", n_clusters: int | None = None,
                 nprobe: int = 8, kmeans_iters: int = 8, seed: int = 0,
                 kernel_backend: str | None = None, device="cuda"):
        dev = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        # a tiny selected sub-index cannot host more clusters than rows
        c = n_clusters or max(1, min(int(np.sqrt(n)), n))
        c = max(1, min(c, n))
        x = torch.from_numpy(vectors).to(dev)
        cents, assign = kmeans(x, c, kmeans_iters, seed)
        assign = assign.cpu().numpy()
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=c)
        self._install(
            centroids=cents.cpu().numpy(), vectors=vectors[order],
            label_words=np.asarray(label_words)[order], row_map=order,
            offsets=np.concatenate([[0], np.cumsum(counts)]), nprobe=nprobe,
            metric=metric, kernel_backend=kernel_backend, device=dev)

    @classmethod
    def build(cls, vectors, label_words, metric: str = "l2", **params):
        return cls(vectors, label_words, metric, **params)

    @classmethod
    def from_reference_state(cls, state, *, metric: str = "l2",
                             kernel_backend: str | None = None,
                             device="cuda") -> "IVFIndex":
        """The index whose clusters another build made — a JAX
        ``IVFIndex``'s ``centroids``, ``vectors`` and ``label_words``
        (cluster-major), ``row_map``, ``offsets`` and ``nprobe`` as numpy
        arrays (``n_clusters`` optional, checked)."""
        ix = cls.__new__(cls)
        ix._install(centroids=state["centroids"], vectors=state["vectors"],
                    label_words=state["label_words"],
                    row_map=state["row_map"], offsets=state["offsets"],
                    nprobe=int(state["nprobe"]), metric=metric,
                    kernel_backend=kernel_backend,
                    device=resolve_device(device))
        if ix.n_clusters != int(state.get("n_clusters", ix.n_clusters)):
            raise ValueError("state's n_clusters disagrees with its "
                             "centroids")
        return ix

    def _install(self, *, centroids, vectors, label_words, row_map, offsets,
                 nprobe, metric, kernel_backend, device) -> None:
        """Host attributes (what the sequential-probe oracle reads) and
        their device copies."""
        self.device = device
        self.metric = metric
        self.kernel_backend = kernel_backend or ops.default_backend(device)
        self.nprobe = nprobe
        # writable host copies ("W": arrays exported by JAX are read-only)
        self.centroids = np.require(centroids, np.float32, ("C", "W"))
        self.vectors = np.require(vectors, np.float32, ("C", "W"))
        self.label_words = np.require(label_words, np.int32, ("C", "W"))
        self.row_map = np.asarray(row_map).astype(np.int32)  # stored -> local
        self.offsets = np.asarray(offsets).astype(np.int64)
        self.num_vectors, self.dim = self.vectors.shape
        self.n_clusters = c = self.centroids.shape[0]
        self._boundaries = wave_boundaries(c, nprobe)
        counts = np.diff(self.offsets)
        row_cluster = np.repeat(np.arange(c), counts)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self._xb = t(self.vectors)
        self._lxw = t(self.label_words)
        self._cents = t(self.centroids)
        self._cwords = torch.zeros((c, self.label_words.shape[1]),
                                   dtype=torch.int32, device=device)
        self._row_cluster = t(row_cluster)
        self._row_in_cluster = t(np.arange(self.num_vectors)
                                 - self.offsets[row_cluster])
        self._cluster_sizes = t(counts)
        self._offsets_dev = t(self.offsets)
        self._bounds_dev = t(np.asarray(self._boundaries, dtype=np.int64))
        self._row_map_dev = t(self.row_map)

    def search(self, queries: np.ndarray, query_label_words: np.ndarray,
               k: int, tomb=None) -> tuple[np.ndarray, np.ndarray]:
        """Un-bucketed search: padded to the executor's power-of-two
        bucket, searched, sliced and copied to the host."""
        return pad_to_bucket(self.search_padded, queries,
                             query_label_words, k, self.num_vectors,
                             tomb=tomb)

    def search_padded(self, queries: np.ndarray,
                      query_label_words: np.ndarray,
                      k: int, tomb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket-shaped incremental-probe search (``index.base``
        contract) through the per-``(k, bucket)`` dispatch table; returns
        device tensors [bucket, k].  ``tomb`` is a packed bitmap over
        local rows."""
        cache = bucket_cache(self)
        bucket = queries.shape[0]
        fn = cache.get((k, bucket))
        if fn is None:
            def fn(q, lq, tomb=None, _k=k):
                return ivf_padded_topk(self, q, lq, tomb, k=_k,
                                       backend=self.kernel_backend)
            cache[(k, bucket)] = fn
        dev = self.device
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        lq = torch.as_tensor(query_label_words, dtype=torch.int32,
                             device=dev)
        if tomb is not None:
            tomb = torch.as_tensor(tomb, dtype=torch.uint8, device=dev)
        return fn(q, lq, tomb)

    @property
    def nbytes(self) -> int:
        return (self.vectors.nbytes + self.centroids.nbytes
                + self.label_words.nbytes + self.offsets.nbytes)
