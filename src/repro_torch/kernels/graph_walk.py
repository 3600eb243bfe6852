"""The graph backend's filtered beam search: one walk a query lane.

:func:`graph_walk` is the wrapper of the hand-written kernel in
``csrc/graph_walk.cu`` (its head states the function, the bound on the
card and the design): one warp walks one lane from its seeds to its stop,
pools in shared memory, the visited set a bitmap, each hop's neighbour
distances computed inside the walk in ``gather_distance_pallas``'s direct
form.  On a CUDA tensor it launches the kernel or raises; on a CPU tensor
it runs :func:`graph_walk_plain`.  It checks its arguments on either
device, so the kernel's bounds hold on both: ``M``, the entries a lane
``E`` and the label words ``W`` at most 32, ``ef`` at most 1,024 and ``D``
at most 1,024 — a block's shared memory then stays under 160 KB of the
H100's 227 KB (:func:`walk_smem_bytes`; ef 64, M 16, D 128, W 1 take
10,704 bytes).

:func:`graph_walk_plain` is the plain version: the reference's per-lane
``lax.while_loop`` vmapped over the batch, as a torch loop over hops on
[bucket, ·] state.  Per hop the first unexpanded candidate of least
distance is expanded, its neighbours' distances come from
``gather_distance_plain``, and a stable sort keeps the best ``ef`` of the
candidate and result pools.  Finished lanes freeze (updates are selected
per lane, as vmap's select does), so a lane's result does not depend on
its batch neighbours or on how often the host asks whether any lane is
still running (``sync_every``); the kernel, which stops each lane at its
first stop, therefore equals it lane by lane.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref
from .gather_distance import gather_distance_plain

INF = float("inf")
SYNC_EVERY = 32            # hops between the host's "any lane running?" reads
MAX_M = 32                 # one thread a neighbour
MAX_ENTRIES = 32           # one thread a seed
MAX_EF = 1024
MAX_DIM = 1024
MAX_LABEL_WORDS = 32
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"graph_walk": [_P] * 7 + [_L, _P, _L] + [_P] * 4 + [_I] * 12
               + [_P],
               "graph_walk_planted": [_P] * 7 + [_L, _P, _L] + [_P] * 4
               + [_I] * 13 + [_P],
               "graph_walk_smem_bytes": [_I] * 5}
PLANTED_FAULTS = {1: "new entries merged ahead of equal pool entries",
                  2: "each lane stopped one hop early"}


def walk_smem_bytes(D: int, M: int, ef: int, W: int, vec: bool) -> int:
    """Dynamic shared memory of one lane's block: the query row, M staged
    rows (pitch D + 4 floats with 16-byte copies, else D + 1), both pools
    with the expanded flags, the new-entry lists and the label words
    (``Layout`` in ``csrc/graph_walk.cu``)."""
    def a16(n):
        return (n + 15) & ~15
    sd = D + 4 if vec else D + 1
    return (a16(4 * D) + a16(4 * M * sd) + 4 * a16(4 * ef) + a16(ef)
            + 5 * 4 * 32 + a16(4 * W))


def _keep_best(d, i, x, ef):
    """The first ``ef`` of a stable sort of each row of ``d`` (``i`` and
    ``x`` follow), -0.0 and +0.0 equal, as ``jnp.argsort(stable=True)``
    orders them."""
    _, order = torch.sort(d + 0.0, dim=-1, stable=True)
    order = order[..., :ef]
    return (torch.gather(d, -1, order), torch.gather(i, -1, order),
            torch.gather(x, -1, order))


def graph_walk_plain(q, lq, entries, x, adj, lxw, tomb=None, *, k: int,
                     ef: int, metric: str = "l2", strategy: str = "post",
                     sync_every: int = SYNC_EVERY):
    """Plain torch version, on any device: the arguments and results of
    :func:`graph_walk`.

    Node N is a sink: padded adjacency slots hold it and it is visited
    from the start, so a pad is never a new neighbour.  Both pools are
    always ef wide and sorted, so a candidate at +inf never displaces an
    entry; a lane that has finished therefore keeps its pools through any
    further hop with its candidates at +inf (marking one more slot
    expanded cannot restart it), which is how it freezes."""
    N, M = x.shape[0], adj.shape[1]
    B = q.shape[0]
    dev = q.device
    inf = torch.tensor(INF, device=dev)
    max_steps = 4 * N // max(M, 1) + 64

    def dist(ids):                      # ids < 0 -> +inf
        return gather_distance_plain(q, x, ids, metric=metric)

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
    d, i, x_ = _keep_best(
        torch.stack([torch.cat([e_d, full_d], 1),
                     torch.cat([full_d, torch.where(e_pass, e_d, inf)], 1)],
                    1),
        torch.stack([torch.cat([seeds, full_i], 1),
                     torch.cat([full_i, torch.where(e_pass, seeds, N)], 1)],
                    1),
        seed_x[:, None, :].expand(-1, 2, -1), ef)
    pool_d, pool_i, pool_x = d[:, 0], i[:, 0], x_[:, 0]
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
            d, i, x_ = _keep_best(
                torch.cat([torch.stack([pool_d, res_d], 1),
                           torch.stack([torch.where(nav, nd, inf),
                                        torch.where(nres, nd, inf)], 1)], 2),
                torch.cat([torch.stack([pool_i, res_i], 1),
                           nbrs[:, None, :].expand(-1, 2, -1)], 2),
                torch.cat([pool_x[:, None, :].expand(-1, 2, -1), no_x], 2),
                ef)
            pool_d, pool_i, pool_x = d[:, 0], i[:, 0], x_[:, 0]
            res_d, res_i = d[:, 1], i[:, 1]
            hops += active
            dc += fresh.sum(1, dtype=torch.int32)
        if not bool(running()[0].any()):
            break
    return res_d[:, :k], res_i[:, :k].to(torch.int32), hops, dc


def check_walk_args(q, lq, entries, x, adj, lxw, tomb, *, k, ef, metric,
                    strategy) -> None:
    """Raise on what the kernel does not take: dtypes, layouts, shapes and
    the bounds of the module docstring."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if strategy not in ("pre", "post"):
        raise ValueError(f"unknown strategy {strategy!r}")
    operands = dict(q=(q, torch.float32), lq=(lq, torch.int32),
                    entries=(entries, torch.int64), x=(x, torch.float32),
                    adj=(adj, torch.int64), lxw=(lxw, torch.int32))
    for name, (t, dt) in operands.items():
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 2:
            raise ValueError(f"graph_walk: {name} must be a contiguous 2-d "
                             f"{dt} tensor on {q.device}")
    if tomb is not None and (tomb.device != q.device
                             or tomb.dtype != torch.uint8 or tomb.dim() != 1
                             or not tomb.is_contiguous()
                             or tomb.numel() == 0):
        raise ValueError(f"graph_walk: tomb must be a non-empty contiguous "
                         f"1-d uint8 bitmap on {q.device}")
    B, D = q.shape
    N, W, M = x.shape[0], lq.shape[1], adj.shape[1]
    E = entries.shape[1]
    if lq.shape[0] != B or entries.shape[0] != B or x.shape[1] != D \
            or adj.shape[0] != N + 1 or lxw.shape != (N + 1, W):
        raise ValueError("graph_walk: shape mismatch")
    if not (1 <= k <= ef <= MAX_EF and 1 <= M <= MAX_M
            and E <= MAX_ENTRIES and D <= MAX_DIM
            and W <= MAX_LABEL_WORDS and N + 1 < 2 ** 31):
        raise ValueError(
            f"graph_walk: k={k}, ef={ef} (1 <= k <= ef <= {MAX_EF}), "
            f"M={M} (max {MAX_M}), E={E} (max {MAX_ENTRIES}), D={D} (max "
            f"{MAX_DIM}), W={W} (max {MAX_LABEL_WORDS}), N={N}")


def graph_walk(q, lq, entries, x, adj, lxw, tomb=None, *, k: int, ef: int,
               metric: str = "l2", strategy: str = "post"):
    """Filtered beam search of ``B`` lanes over one graph.

    ``q`` [B, D] f32, ``lq`` [B, W] i32, ``entries`` [B, E] int64 (-1: no
    seed; else < N), ``x`` [N, D] f32 rows, ``adj`` [N + 1, M] int64 (pads
    and row N hold N), ``lxw`` [N + 1, W] i32 (row N zeros), ``tomb`` an
    optional packed bitmap over node ids (bit set: deleted), which drops
    nodes from the result pool only: they stay navigable.  Returns (dists
    [B, k] f32, ids [B, k] int32 — id N ⇒ empty, hops [B] int32,
    distance computations [B] int32)."""
    check_walk_args(q, lq, entries, x, adj, lxw, tomb, k=k, ef=ef,
                    metric=metric, strategy=strategy)
    if q.device.type == "cpu":
        return graph_walk_plain(q, lq, entries, x, adj, lxw, tomb, k=k,
                                ef=ef, metric=metric, strategy=strategy)
    return _launch("graph_walk", q, lq, entries, x, adj, lxw, tomb, k=k,
                   ef=ef, metric=metric, strategy=strategy)


graph_walk.launches = 0


def graph_walk_planted(q, lq, entries, x, adj, lxw, tomb=None, *, k: int,
                       ef: int, metric: str = "l2", strategy: str = "post",
                       fault: int):
    """:func:`graph_walk` made wrong on purpose by planted fault ``fault``
    (:data:`PLANTED_FAULTS`), for the checks that must reject it: the
    kernel's own instances with the fault compiled in, behind an entry of
    their own.  CUDA tensors only; not counted in ``graph_walk.launches``."""
    if fault not in PLANTED_FAULTS or q.device.type != "cuda":
        raise ValueError(f"graph_walk_planted: fault {fault} on "
                         f"{q.device.type}; faults are "
                         f"{list(PLANTED_FAULTS)}, on the card")
    check_walk_args(q, lq, entries, x, adj, lxw, tomb, k=k, ef=ef,
                    metric=metric, strategy=strategy)
    return _launch("graph_walk_planted", q, lq, entries, x, adj, lxw, tomb,
                   k=k, ef=ef, metric=metric, strategy=strategy,
                   fault=(fault,))


def _launch(entry, q, lq, entries, x, adj, lxw, tomb, *, k, ef, metric,
            strategy, fault=()):
    B, D = q.shape
    N, M, W, E = x.shape[0], adj.shape[1], lq.shape[1], entries.shape[1]
    dev = q.device
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    hops = torch.empty(B, dtype=torch.int32, device=dev)
    dc = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i, hops, dc
    words = (N + 1 + 31) // 32         # the visited bitmap of a lane,
    vwords = (words + 3) // 4 * 4      # zeroed with 16-byte stores
    visited = torch.empty((B, vwords), dtype=torch.int32, device=dev)
    vec = D % 4 == 0 and x.data_ptr() % 16 == 0
    lib = cuda_build.load("graph_walk", _SIGNATURES)
    p = cuda_build.ptr
    code = getattr(lib, entry)(
        p(q), p(lq), p(entries), p(x), p(adj), p(lxw), p(tomb),
        0 if tomb is None else tomb.numel(), p(visited), vwords, p(out_d),
        p(out_i), p(hops), p(dc), B, E, N, M, D, W, k, ef,
        4 * N // M + 64, int(metric == "ip"), int(strategy == "pre"),
        int(vec), *fault, torch.cuda.current_stream(dev).cuda_stream)
    if not fault:
        graph_walk.launches += 1
    cuda_build.check(code, entry)
    return out_d, out_i, hops, dc
