"""GraphIndex — degree-bounded proximity graph (port of
``repro/index/graph.py``).

The paper's experiments use HNSW; the selection only needs a top-k index
with incremental (k+1) search.  As in the JAX package, adjacency is a
dense ``[N, M]`` int32 array (-1 pads a row), built Vamana-style (exact
top-``n_cand`` candidate lists, α-robust prune, reverse edges, a medoid
fix-up for nodes nobody points to), and searched by a filtered beam search
with PostFiltering or PreFiltering (paper §2.2) that reports hops and
distance computations per query.

Build.  :func:`build_vamana_plain` is the reference's host numpy code,
copied; it runs for ``device="cpu"``.  On a card, :func:`build_vamana`
keeps the algorithm and its order and moves its three stages:

  1. candidate lists — blockwise [rows, n] norms-form distances through
     ``ops.masked_distance`` with empty label masks, the diagonal at
     +inf, then the ``n_cand`` smallest in (value, index) order;
  2. forward α-prune — every node's greedy over its sorted candidates
     at once, as tensor ops on the card, in chunks of nodes;
  3. reverse edges — sequential by nature (node i reads its list after
     every earlier node edited it), compiled host code
     (``csrc/vamana_host.cu``, through ctypes).

Every prune distance, in the plain build, stages 2 and 3, is numpy's
float32 pairwise sum of ``(a - b)²`` (:func:`pairwise_sq`), so stages 2
and 3 reproduce the plain prunes bit for bit.  Stage 1's product sums in
another order than numpy's matmul; the two builds agree wherever the
candidate distances are exact (integer data) and free of ties — the
reference orders equal distances of a row arbitrarily (``argpartition``),
ROADMAP C5.  :meth:`GraphIndex.from_reference_state` installs a JAX
index's adjacency and medoid instead.

Search.  The reference's ``lax.while_loop`` vmapped over the batch
becomes a torch loop over hops on [bucket, ·] state: per hop the first
unexpanded candidate of least distance is expanded, its neighbours'
distances come from ``ops.gather_distance_batched`` (the
``gather_distance`` kernel on ``"cuda"``, the plain version on
``"ref"``), and a stable sort keeps the best ``ef`` of the candidate and
result pools.  Finished lanes freeze (updates are selected per lane, as
vmap's select does), so a lane's result does not depend on its batch
neighbours or on how often the host asks whether any lane is still
running (``sync_every``).  The hop's distances are the Pallas kernel's
direct form, where the reference's jnp loop uses the norms form
(ROADMAP C5): the two agree bitwise on integer data.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from ..kernels import cuda_build, ops, ref
from .base import bucket_cache, register_index, resolve_device

INF = float("inf")
SYNC_EVERY = 32            # hops between the host's "any lane running?" reads
CAND_SLACK = 8             # extra candidates taken before the exact ordering
CAND_BLOCK_ELEMS = 1 << 28   # [rows, n] distances per candidate block
PRUNE_DIST_ELEMS = 1 << 25   # [nodes, C, C, 8] partial sums per piece
PRUNE_CHUNK_ELEMS = 1 << 26  # [nodes, C, C] pair distances per greedy chunk
_SIGNATURES = {"vamana_reverse": [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_float]}


# ---------------------------------------------------------------------------
# Construction: the plain (host numpy) build, the reference's code
# ---------------------------------------------------------------------------

def _pairwise_block_topk(x: np.ndarray, n_cand: int,
                         block: int = 2048) -> np.ndarray:
    """Exact top-``n_cand`` neighbor ids per row (excluding self), blockwise."""
    n = x.shape[0]
    sq = np.sum(x * x, axis=1)
    out = np.empty((n, min(n_cand, n - 1)), dtype=np.int32)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        d = sq[lo:hi, None] - 2.0 * (x[lo:hi] @ x.T) + sq[None, :]
        rows = np.arange(lo, hi)
        d[np.arange(hi - lo), rows] = INF           # exclude self
        k = out.shape[1]
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        out[lo:hi] = np.take_along_axis(part, order, axis=1).astype(np.int32)
    return out


def _robust_prune(x: np.ndarray, i: int, cand: np.ndarray, alpha: float,
                  M: int) -> np.ndarray:
    """Vamana α-RNG prune: keep candidates not α-dominated by a kept one."""
    cand = cand[cand != i]
    if cand.size == 0:
        return cand.astype(np.int32)
    _, first = np.unique(cand, return_index=True)
    cand = cand[np.sort(first)]
    d_i = np.sum((x[cand] - x[i]) ** 2, axis=1)
    order = np.argsort(d_i, kind="stable")
    cand, d_i = cand[order], d_i[order]
    kept: list[int] = []
    alive = np.ones(cand.size, dtype=bool)
    for j in range(cand.size):
        if not alive[j]:
            continue
        kept.append(j)
        if len(kept) == M:
            break
        # occlude: drop c with α·d(kept_j, c) ≤ d(i, c)
        d_jc = np.sum((x[cand] - x[cand[j]]) ** 2, axis=1)
        alive &= ~(alpha * d_jc <= d_i)
        alive[j] = False
    return cand[kept].astype(np.int32)


def _forward_plain(x, cands, alpha, M):
    n = x.shape[0]
    adj = np.full((n, M), -1, dtype=np.int32)
    deg = np.zeros(n, dtype=np.int32)
    for i in range(n):
        kept = _robust_prune(x, i, cands[i], alpha, M)
        adj[i, : kept.size] = kept
        deg[i] = kept.size
    return adj, deg


def reverse_edges_plain(x, adj, deg, alpha, M) -> None:
    """Reverse edges (keeps the graph navigable from sparse regions), in
    place: the reference's Python loop."""
    n = x.shape[0]
    for i in range(n):
        for j in adj[i, : deg[i]]:
            if i in adj[j, : deg[j]]:
                continue
            if deg[j] < M:
                adj[j, deg[j]] = i
                deg[j] += 1
            else:
                kept = _robust_prune(x, j, np.append(adj[j, : deg[j]], i),
                                     alpha, M)
                adj[j, :] = -1
                adj[j, : kept.size] = kept
                deg[j] = kept.size


def fix_orphans(adj, deg, medoid, M) -> None:
    """Connectivity fix-up, in place: any node with zero in-degree gets an
    edge from the medoid (overwriting slot ``deg % M`` once it is full)."""
    n = adj.shape[0]
    indeg = np.zeros(n, dtype=np.int64)
    np.add.at(indeg, adj[adj >= 0], 1)
    orphans = np.where((indeg == 0) & (np.arange(n) != medoid))[0]
    for o in orphans:
        slot = deg[medoid] % M
        adj[medoid, slot] = o
        deg[medoid] = min(deg[medoid] + 1, M)


def medoid_of(x: np.ndarray) -> int:
    return int(np.argmin(np.sum((x - x.mean(0)) ** 2, axis=1)))


def build_vamana_plain(x: np.ndarray, M: int = 16, n_cand: int = 64,
                       alpha: float = 1.2, seed: int = 0
                       ) -> tuple[np.ndarray, int]:
    """The reference's build on the host: (adj [N, M] int32, medoid)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    if n == 1:
        return np.full((1, M), -1, dtype=np.int32), 0
    medoid = medoid_of(x)
    adj, deg = _forward_plain(x, _pairwise_block_topk(x, n_cand), alpha, M)
    reverse_edges_plain(x, adj, deg, alpha, M)
    fix_orphans(adj, deg, medoid, M)
    return adj, medoid


# ---------------------------------------------------------------------------
# Construction on the card
# ---------------------------------------------------------------------------

def pairwise_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b)²)`` over the last axis (broadcast), summed in numpy's
    float32 pairwise order — eight running lanes up to 128 features,
    halves above — so a prune distance equals ``np.sum(..., axis=1)``'s
    on every device and at every chunking."""
    def sq(lo, hi):
        t = a[..., lo:hi] - b[..., lo:hi]
        return t * t

    def pw(lo, n):
        if n < 8:
            r = None
            for e in range(lo, lo + n):
                r = sq(e, e + 1) if r is None else r + sq(e, e + 1)
            return r[..., 0]
        if n <= 128:
            r = sq(lo, lo + 8)
            i = 8
            while i < n - n % 8:
                r = r + sq(lo + i, lo + i + 8)
                i += 8
            res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
                ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
            for e in range(lo + i, lo + n):
                res = res + sq(e, e + 1)[..., 0]
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pw(lo, n2) + pw(lo + n2, n - n2)
    return pw(0, a.shape[-1])


def _lex_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Column ids of the ``k`` smallest entries of each row of ``d`` in
    (value, index) order: ``topk`` of ``k + CAND_SLACK``, ordered exactly;
    a row whose k-th value ties the last one taken may have left an equal
    value at a lower index out, and takes the full sort instead."""
    kk = k + CAND_SLACK
    if kk >= d.shape[1]:
        return ref.lex_topk(d, k)[1]
    v, i = torch.topk(d, kk, dim=1, largest=False, sorted=False)
    i, o = torch.sort(i, dim=1)
    v = torch.gather(v, 1, o)
    _, o = torch.sort(ref.total_order_key(v), dim=1, stable=True)
    i, v = torch.gather(i, 1, o), torch.gather(v, 1, o)
    tie = v[:, k - 1] == v[:, kk - 1]
    if bool(tie.any()):
        rows = tie.nonzero()[:, 0]
        i[rows] = ref.lex_topk(d[rows], kk)[1]
    return i[:, :k]


def candidate_lists(xd: torch.Tensor, n_cand: int, *, backend: str
                    ) -> torch.Tensor:
    """[n, min(n_cand, n-1)] int64: each row's nearest other rows by the
    norms-form distance (``ops.masked_distance``, empty label masks), in
    (value, index) order."""
    n = xd.shape[0]
    k = min(n_cand, n - 1)
    rows = max(1, min(n, CAND_BLOCK_ELEMS // n))
    dev = xd.device
    zq = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    zx = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        d = ops.masked_distance(xd[lo:hi], xd, zq[:hi - lo], zx,
                                backend=backend, device=dev)
        r = torch.arange(hi - lo, device=dev)
        d[r, lo + r] = INF                          # exclude self
        out[lo:hi] = _lex_smallest(d, k)
    return out


def forward_prune(xd: torch.Tensor, cands: torch.Tensor, alpha: float,
                  M: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every node's α-robust prune over its candidate list at once: the
    candidates re-sorted (stably) by their direct distance to the node,
    then the greedy — step j keeps candidate j if it is alive and fewer
    than M are kept, and occludes every c with α·d(j, c) ≤ d(node, c) —
    vectorised across the nodes of a chunk.  α is rounded to float32, as
    numpy rounds a Python float against a float32 array.  Returns (adj
    [n, M] int32, -1 pad; deg [n] int32) on ``xd``'s device."""
    n = xd.shape[0]
    C = cands.shape[1]
    dev = xd.device
    a32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    adj = torch.full((n, M), -1, dtype=torch.int32, device=dev)
    deg = torch.zeros(n, dtype=torch.int32, device=dev)
    piece = max(1, PRUNE_DIST_ELEMS // (C * C * 8))
    chunk = max(piece, PRUNE_CHUNK_ELEMS // (C * C))
    pos = torch.arange(C, device=dev)
    width = min(M, C)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        c = cands[lo:hi]
        d_i = pairwise_sq(xd[c], xd[lo:hi, None, :])
        d_i, o = torch.sort(d_i, dim=1, stable=True)
        c = torch.gather(c, 1, o)
        occl = torch.empty((hi - lo, C, C), dtype=torch.bool, device=dev)
        for s in range(0, hi - lo, piece):
            xc = xd[c[s:s + piece]]
            dcc = pairwise_sq(xc[:, :, None, :], xc[:, None, :, :])
            occl[s:s + piece] = a32 * dcc <= d_i[s:s + piece, None, :]
        alive = torch.ones((hi - lo, C), dtype=torch.bool, device=dev)
        kept = torch.zeros_like(alive)
        cnt = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
        for j in range(C):
            take = alive[:, j] & (cnt < M)
            kept[:, j] = take
            cnt += take
            alive &= ~(occl[:, j, :] & take[:, None])
            alive[:, j] = False
        order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
        nb = torch.gather(c, 1, order)[:, :width]
        adj[lo:hi, :width] = torch.where(pos[None, :width] < cnt[:, None], nb,
                                         -1).to(torch.int32)
        deg[lo:hi] = cnt
    return adj, deg


def reverse_edges_compiled(x: np.ndarray, adj: np.ndarray, deg: np.ndarray,
                           alpha: float, M: int) -> None:
    """:func:`reverse_edges_plain` as compiled host code
    (``csrc/vamana_host.cu``), in place on the host arrays."""
    for a, dt in ((x, np.float32), (adj, np.int32), (deg, np.int32)):
        if a.dtype != dt or not a.flags.c_contiguous or not a.flags.writeable:
            raise ValueError("reverse_edges_compiled: x f32, adj and deg "
                             "int32, contiguous and writable")
    lib = cuda_build.load("vamana_host", _SIGNATURES)
    code = lib.vamana_reverse(x.ctypes.data, x.shape[0], x.shape[1],
                              adj.ctypes.data, deg.ctypes.data, M,
                              float(np.float32(alpha)))
    if code:
        raise ValueError(f"vamana_reverse: M={M} out of range (1..63)")


def build_vamana(x: np.ndarray, M: int = 16, n_cand: int = 64,
                 alpha: float = 1.2, seed: int = 0, *, device="cuda",
                 kernel_backend: str | None = None,
                 timings: dict | None = None) -> tuple[np.ndarray, int]:
    """Build a degree-≤M navigable graph: (adj [N, M] int32, medoid).
    A CUDA device (the default: without a card this raises) runs the card
    build (module docstring), whose reverse pass is compiled host code;
    ``device="cpu"`` runs :func:`build_vamana_plain`.  ``timings``
    (optional) receives seconds per stage."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    if dev.type == "cpu":
        t0 = time.perf_counter()
        out = build_vamana_plain(x, M, n_cand, alpha, seed)
        if timings is not None:
            timings["plain"] = time.perf_counter() - t0
        return out
    return build_vamana_card(x, M, n_cand, alpha, device=dev,
                             kernel_backend=kernel_backend, timings=timings)


def build_vamana_card(x: np.ndarray, M: int, n_cand: int, alpha: float, *,
                      device, kernel_backend: str | None = None,
                      timings: dict | None = None) -> tuple[np.ndarray, int]:
    """The card build of :func:`build_vamana` on ``device``; its torch
    stages run on CPU tensors too."""
    dev = torch.device(device)
    n = x.shape[0]
    if n == 1:
        return np.full((1, M), -1, dtype=np.int32), 0
    stages = {}
    t0 = time.perf_counter()
    medoid = medoid_of(x)
    xd = torch.from_numpy(x).to(dev)
    stages["medoid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cands = candidate_lists(xd, n_cand,
                            backend=kernel_backend or ops.default_backend(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages["candidates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj, deg = (t.cpu().numpy() for t in forward_prune(xd, cands, alpha, M))
    stages["forward_prune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reverse_edges_compiled(x, adj, deg, alpha, M)
    stages["reverse_edges"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fix_orphans(adj, deg, medoid, M)
    stages["orphans"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(stages)
    return adj, medoid


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchStats:
    hops: np.ndarray        # [Q] int32 — nodes expanded
    dist_comps: np.ndarray  # [Q] int32 — distance computations


def _keep_best(d, i, x, ef):
    """The first ``ef`` of a stable sort of each row of ``d`` (``i`` and
    ``x`` follow), -0.0 and +0.0 equal, as ``jnp.argsort(stable=True)``
    orders them."""
    _, order = torch.sort(d + 0.0, dim=-1, stable=True)
    order = order[..., :ef]
    return (torch.gather(d, -1, order), torch.gather(i, -1, order),
            torch.gather(x, -1, order))


def beam_search(ix: "GraphIndex", q, lq, entries, tomb=None, *, k: int,
                ef: int, strategy: str, backend: str,
                sync_every: int = SYNC_EVERY):
    """Batched filtered beam search over ``ix``'s device tensors.

    ``q`` [B, D] f32, ``lq`` [B, W] i32, ``entries`` [B, E] int64 (-1:
    no seed) on ``ix.device``; ``tomb`` an optional packed bitmap over
    node ids, which drops nodes from the result pool only: they stay
    navigable (walk but don't return).  Returns (dists [B, k], ids [B, k]
    int32 — id N ⇒ empty, hops [B], dist_comps [B]).

    Node N is a sink: padded adjacency slots hold it and it is visited
    from the start, so a pad is never a new neighbour.  Both pools are
    always ef wide and sorted, so a candidate at +inf never displaces an
    entry; a lane that has finished therefore keeps its pools through any
    further hop with its candidates at +inf (marking one more slot
    expanded cannot restart it), which is how it freezes."""
    N, M = ix.num_vectors, ix.M
    B = q.shape[0]
    dev = q.device
    adj, lxw = ix._adj_ext, ix._lxw_ext
    inf = torch.tensor(INF, device=dev)
    max_steps = 4 * N // max(M, 1) + 64

    def dist(ids):                      # ids < 0 -> +inf
        return ops.gather_distance_batched(q, ix._xb, ids, metric=ix.metric,
                                           backend=backend, device=dev)

    def passes(ids):                    # ids in [0, N]
        return torch.all((lq[:, None, :] & lxw[ids]) == lq[:, None, :],
                         dim=-1)

    valid_e = entries >= 0
    seeds = torch.where(valid_e, entries, N)
    e_d = dist(torch.where(valid_e, entries, -1))
    e_pass = passes(seeds) & valid_e
    if tomb is not None:
        e_pass &= ref.tombstone_mask(tomb, seeds)
    visited = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    visited[:, N] = True
    visited.scatter_(1, seeds, True)
    full_d = torch.full((B, ef), INF, device=dev)
    full_i = torch.full((B, ef), N, dtype=torch.int64, device=dev)
    # candidate pool (navigation; seeds always navigable) and result pool
    # (passing live nodes), both ef wide, sorted in one call
    seed_x = torch.cat([~valid_e, torch.ones((B, ef), dtype=torch.bool,
                                             device=dev)], 1)
    d, i, x = _keep_best(
        torch.stack([torch.cat([e_d, full_d], 1),
                     torch.cat([full_d, torch.where(e_pass, e_d, inf)], 1)],
                    1),
        torch.stack([torch.cat([seeds, full_i], 1),
                     torch.cat([full_i, torch.where(e_pass, seeds, N)], 1)],
                    1),
        seed_x[:, None, :].expand(-1, 2, -1), ef)
    pool_d, pool_i, pool_x = d[:, 0], i[:, 0], x[:, 0]
    res_d, res_i = d[:, 1], i[:, 1]
    hops = torch.zeros(B, dtype=torch.int32, device=dev)
    dc = valid_e.sum(1, dtype=torch.int32)
    no_x = torch.zeros((B, 2, M), dtype=torch.bool, device=dev)

    def running():
        best, slot = torch.where(pool_x, inf, pool_d).min(dim=1)
        # an unexpanded candidate could still improve the ef-th result
        return (hops < max_steps) & torch.isfinite(best) & \
            (best <= res_d[:, -1]), slot

    while True:
        for _ in range(sync_every):
            active, slot = running()
            u = torch.gather(pool_i, 1, slot[:, None])[:, 0]
            pool_x.scatter_(1, slot[:, None], True)
            nbrs = adj[u]                                   # [B, M]
            nv = ~torch.gather(visited, 1, nbrs)
            visited.scatter_(1, nbrs, True)
            fresh = nv & active[:, None]
            nd = dist(torch.where(fresh, nbrs, -1))
            npass = passes(nbrs) & nv
            nres = npass if tomb is None else \
                npass & ref.tombstone_mask(tomb, nbrs)
            nav = npass if strategy == "pre" else nv
            d, i, x = _keep_best(
                torch.cat([torch.stack([pool_d, res_d], 1),
                           torch.stack([torch.where(nav, nd, inf),
                                        torch.where(nres, nd, inf)], 1)], 2),
                torch.cat([torch.stack([pool_i, res_i], 1),
                           nbrs[:, None, :].expand(-1, 2, -1)], 2),
                torch.cat([pool_x[:, None, :].expand(-1, 2, -1), no_x], 2),
                ef)
            pool_d, pool_i, pool_x = d[:, 0], i[:, 0], x[:, 0]
            res_d, res_i = d[:, 1], i[:, 1]
            hops += active
            dc += fresh.sum(1, dtype=torch.int32)
        if not bool(running()[0].any()):
            break
    return res_d[:, :k], res_i[:, :k].to(torch.int32), hops, dc


@register_index("graph")
class GraphIndex:
    """Degree-bounded proximity graph with filtered beam search."""

    supports_tombstones = True   # walk-but-don't-return bitmap over nodes

    def __init__(self, vectors: np.ndarray, label_words: np.ndarray,
                 metric: str = "l2", M: int = 16, n_cand: int = 64,
                 alpha: float = 1.2, ef_search: int = 64,
                 strategy: str = "post", seed: int = 0,
                 adjacency: np.ndarray | None = None,
                 medoid: int | None = None,
                 kernel_backend: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.metric = metric
        self.M = M
        self.ef_search = ef_search
        self.strategy = strategy
        self.kernel_backend = kernel_backend or ops.default_backend(
            self.device)
        self.sync_every = SYNC_EVERY
        self.vectors = np.require(vectors, np.float32, ("C", "W"))
        self.label_words = np.require(label_words, np.int32, ("C", "W"))
        self.num_vectors, self.dim = self.vectors.shape
        self.build_seconds: dict[str, float] = {}
        if adjacency is None:
            adjacency, medoid = build_vamana(
                self.vectors, M=M, n_cand=n_cand, alpha=alpha, seed=seed,
                device=self.device, kernel_backend=self.kernel_backend,
                timings=self.build_seconds)
        self.adjacency = np.require(adjacency, np.int32, ("C", "W"))
        if self.adjacency.shape != (self.num_vectors, M):
            raise ValueError(f"adjacency {self.adjacency.shape} is not "
                             f"[{self.num_vectors}, {M}]")
        self.medoid = int(medoid if medoid is not None else 0)
        self.last_stats: SearchStats | None = None

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._xb = t(self.vectors)
        # node N is the search's sink: pads point at it, its row is pads
        n = self.num_vectors
        adj = np.full((n + 1, M), n, dtype=np.int64)
        adj[:n] = np.where(self.adjacency >= 0, self.adjacency, n)
        self._adj_ext = t(adj)
        self._lxw_ext = t(np.concatenate(
            [self.label_words, np.zeros((1, self.label_words.shape[1]),
                                        np.int32)]))

    @classmethod
    def build(cls, vectors, label_words, metric: str = "l2", **params):
        return cls(vectors, label_words, metric, **params)

    @classmethod
    def from_reference_state(cls, vectors, label_words, state, *,
                             metric: str = "l2",
                             kernel_backend: str | None = None,
                             device="cuda") -> "GraphIndex":
        """The graph another build made over these rows — a JAX
        ``GraphIndex``'s ``adjacency`` and ``medoid`` (``M``, ``ef_search``
        and ``strategy`` optional)."""
        adj = np.asarray(state["adjacency"])
        return cls(vectors, label_words, metric,
                   M=int(state.get("M", adj.shape[1])),
                   ef_search=int(state.get("ef_search", 64)),
                   strategy=state.get("strategy", "post"), adjacency=adj,
                   medoid=int(state["medoid"]),
                   kernel_backend=kernel_backend, device=device)

    def default_entries(self, n_queries: int) -> np.ndarray:
        return np.full((n_queries, 1), self.medoid, dtype=np.int32)

    def _run(self, q, lq, entries, tomb, k, ef, strategy):
        dev = self.device
        q = torch.as_tensor(q, dtype=torch.float32, device=dev).contiguous()
        lq = torch.as_tensor(lq, dtype=torch.int32, device=dev)
        entries = torch.as_tensor(entries, device=dev).to(torch.int64)
        if tomb is not None:
            tomb = torch.as_tensor(tomb, dtype=torch.uint8, device=dev)
        return beam_search(self, q, lq, entries, tomb, k=k,
                           ef=max(ef or self.ef_search, k),
                           strategy=strategy or self.strategy,
                           backend=self.kernel_backend,
                           sync_every=self.sync_every)

    def search(self, queries: np.ndarray, query_label_words: np.ndarray,
               k: int, ef: int | None = None, entries: np.ndarray | None = None,
               strategy: str | None = None,
               tomb=None) -> tuple[np.ndarray, np.ndarray]:
        """Un-bucketed search: the batch padded to its power-of-two bucket
        with pad lanes seeded at -1 (no hop), searched, sliced, copied to
        the host; ``last_stats`` holds hops and distance computations."""
        q = np.asarray(queries, dtype=np.float32)
        lw = np.asarray(query_label_words, dtype=np.int32)
        g = q.shape[0]
        if g == 0:
            empty = np.zeros(0, np.int32)
            self.last_stats = SearchStats(hops=empty, dist_comps=empty)
            return (np.full((0, k), np.inf, np.float32),
                    np.full((0, k), self.num_vectors, np.int32))
        bucket = 1 << (g - 1).bit_length()
        qp = np.zeros((bucket, q.shape[1]), np.float32)
        qp[:g] = q
        lp = np.zeros((bucket, lw.shape[1]), np.int32)
        lp[:g] = lw
        if entries is None:
            entries = self.default_entries(g)
        ent = np.full((bucket, entries.shape[1]), -1, np.int64)
        ent[:g] = entries
        d, i, hops, dc = self._run(qp, lp, ent, tomb, k, ef, strategy)
        self.last_stats = SearchStats(hops=hops[:g].cpu().numpy(),
                                      dist_comps=dc[:g].cpu().numpy())
        return d[:g].cpu().numpy(), i[:g].cpu().numpy()

    def search_padded(self, queries: np.ndarray,
                      query_label_words: np.ndarray,
                      k: int, ef: int | None = None,
                      strategy: str | None = None,
                      tomb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket-shaped beam search (``index.base`` contract), every lane
        seeded at the medoid as in the reference, through the per-(k,
        bucket, ef, strategy) dispatch table; returns device tensors
        [bucket, k].  ``tomb`` is a packed bitmap over node ids."""
        cache = bucket_cache(self)
        bucket = queries.shape[0]
        ef = max(ef or self.ef_search, k)
        strategy = strategy or self.strategy
        fn = cache.get((k, bucket, ef, strategy))
        if fn is None:
            def fn(q, lq, tomb=None, _k=k, _ef=ef, _s=strategy):
                entries = np.full((q.shape[0], 1), self.medoid, np.int64)
                return self._run(q, lq, entries, tomb, _k, _ef, _s)[:2]
            cache[(k, bucket, ef, strategy)] = fn
        return fn(queries, query_label_words, tomb)

    @property
    def nbytes(self) -> int:
        return (self.vectors.nbytes + self.label_words.nbytes
                + self.adjacency.nbytes)
