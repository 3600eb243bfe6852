"""Plain torch oracles for the port's kernels (port of ``kernels/ref.py``).

Semantics, as in the JAX package:

  * distances are **squared L2** (metric="l2") or **negative inner product**
    (metric="ip") — both "smaller is closer", so top-k = k smallest;
  * the label filter keeps row i iff ``lq ⊆ lx[i]`` word-wise
    ((lq & lx[i]) == lq for every 32-bit word); filtered-out rows get +inf;
  * every top-k is the (value, index) lexicographic one, values in IEEE
    total order (-0.0 before +0.0) as ``lax.top_k`` orders them.
    ``torch.topk`` does not break ties that way, so selection here is a
    stable sort (:func:`lex_topk`).
"""
from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def total_order_key(d: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values whose integer order is IEEE total
    order: -0.0 sorts before +0.0, which a float comparison calls equal."""
    i = d.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def lex_topk(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of ``d`` [Q, M] f32 in (value,
    index) order, values in total order — ``lax.top_k(-d, k)``'s order.
    Needs ``k <= M``."""
    _, idx = torch.sort(total_order_key(d), dim=1, stable=True)
    idx = idx[:, :k]
    return torch.gather(d, 1, idx), idx


def distances(q: torch.Tensor, x: torch.Tensor, metric: str = "l2"):
    """[Q, D] x [N, D] -> [Q, N] distance matrix (f32 accumulate)."""
    q = q.float()
    x = x.float()
    ip = q @ x.T
    if metric == "ip":
        return -ip
    if metric == "l2":
        qn = torch.sum(q * q, dim=1, keepdim=True)
        xn = torch.sum(x * x, dim=1, keepdim=True)
        return qn - 2.0 * ip + xn.T
    raise ValueError(f"unknown metric {metric!r}")


def containment_mask(lq_words: torch.Tensor, lx_words: torch.Tensor):
    """[Q, W] query masks vs [N, W] db masks -> [Q, N] bool (query ⊆ db)."""
    lq = lq_words[:, None, :]
    lx = lx_words[None, :, :]
    return torch.all((lq & lx) == lq, dim=-1)


def masked_distance(q, x, lq_words, lx_words, metric: str = "l2"):
    """Fused distance + label-containment filter oracle: [Q, N] f32."""
    d = distances(q, x, metric)
    keep = containment_mask(lq_words, lx_words)
    return torch.where(keep, d, torch.full_like(d, INF))


def gather_distance(q_row, x, ids, metric: str = "l2") -> torch.Tensor:
    """Graph-search hot loop oracle: distances from one query ``q_row`` [D]
    to ``x[ids]`` ([B] ids); ids < 0 (padding) -> +inf."""
    valid = ids >= 0
    rows = x[torch.clamp(ids, 0, x.shape[0] - 1).long()]
    d = distances(q_row[None, :], rows, metric)[0]
    return torch.where(valid, d, torch.full_like(d, INF))


def tombstone_mask(tomb: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Gathered per-row liveness from a packed tombstone bitmap
    (``tomb`` [⌈N/8⌉] u8, bit set ⇒ row deleted, little bit order).
    Returns bool, True ⇒ row alive."""
    byte = tomb.to(torch.int32)[torch.clamp(gid >> 3, 0, tomb.shape[0] - 1)]
    return ((byte >> (gid & 7)) & 1) == 0


def filtered_topk(q, x, lq_words, lx_words, k: int, metric: str = "l2",
                  tomb=None):
    """Exact filtered top-k oracle: (vals [Q, k], idxs [Q, k]); ties
    toward the lower index; rows short of k pass pad with (+inf, N)."""
    d = masked_distance(q, x, lq_words, lx_words, metric)
    n = x.shape[0]
    if tomb is not None:
        alive = tombstone_mask(
            tomb, torch.arange(n, dtype=torch.int32, device=d.device))
        d = torch.where(alive[None, :], d, torch.full_like(d, INF))
    if k > n:
        d = torch.nn.functional.pad(d, (0, k - n), value=INF)
    vals, order = lex_topk(d, k)
    empty = torch.isinf(vals)
    idxs = torch.where(empty, n, order)
    vals = torch.where(empty, INF, vals)
    return vals, idxs.to(torch.int32)


def dequantize_rows(xg, dtype: str, scales_g=None, zeros_g=None):
    """Gathered scan-tier rows -> the f32 values the distance math uses:
    f32 as is, fp16 widened, int8 ``zero + scale·code`` (one multiply,
    then one add)."""
    if dtype == "f32":
        return xg
    if dtype == "fp16":
        return xg.float()
    if dtype == "int8":
        return zeros_g[..., None] + scales_g[..., None] * xg.float()
    raise ValueError(f"unknown storage dtype {dtype!r}")


def np_quantized_distances(q, codes, scale, zero, lq_words, lx_words,
                           metric: str = "l2") -> np.ndarray:
    """Numpy quantized-scan oracle: float64 distances of every query to
    every DEQUANTIZED int8 row, +inf where the label filter fails."""
    xd = (zero[:, None].astype(np.float32)
          + scale[:, None].astype(np.float32)
          * codes.astype(np.float32)).astype(np.float64)
    qd = np.asarray(q, np.float64)
    ip = qd @ xd.T
    if metric == "ip":
        d = -ip
    else:
        d = (np.sum(qd * qd, axis=1)[:, None] - 2.0 * ip
             + np.sum(xd * xd, axis=1)[None, :])
    lq = np.asarray(lq_words)[:, None, :]
    lx = np.asarray(lx_words)[None, :, :]
    keep = np.all((lq & lx) == lq, axis=-1)
    return np.where(keep, d, np.inf)


def segment_gids(rows_concat, starts, lens, pos):
    """Arena row ids of segment positions ``pos`` ([C] or [Q, C]):
    ``rows_concat[clip(start + pos, 0, R-1)]`` where ``pos < len``, row
    ``rows_concat[0]`` elsewhere.  Returns (gid [Q, C] int64, valid)."""
    R = rows_concat.shape[0]
    pos = pos if pos.dim() == 2 else pos[None, :]
    valid = pos < lens[:, None]
    p = torch.clamp(starts[:, None] + pos, 0, max(R - 1, 0))
    gid = rows_concat[torch.where(valid, p, 0).long()].long()
    return gid, valid


def scan_distances(q, lq, ax, alw, axn, gid, valid, *, metric: str,
                   dtype: str, scales=None, zeros=None, tomb=None):
    """[Q, C] masked scan distances of the gathered candidates ``gid``:
    multiply + minor-axis reduce (never a matmul, whose accumulation order
    changes with the batch), the norms form ``‖q‖² − 2ip + ‖x‖²`` for l2,
    label containment, tombstones and the ``valid`` mask."""
    xg = dequantize_rows(ax[gid], dtype,
                         None if scales is None else scales[gid],
                         None if zeros is None else zeros[gid])
    ip = torch.sum(xg * q[:, None, :], dim=-1)
    if metric == "ip":
        d = -ip
    else:
        qn = torch.sum(q * q, dim=1)
        d = qn[:, None] - 2.0 * ip + axn[gid]
    keep = torch.all((lq[:, None, :] & alw[gid]) == lq[:, None, :], dim=-1)
    if tomb is not None:
        keep = keep & tombstone_mask(tomb, gid)
    return torch.where(keep & valid, d, torch.full_like(d, INF))


def chunked_scan(q, lq, rows_concat, starts, lens, distance, *, kp: int,
                 lmax: int, chunk: int):
    """Chunked segmented scan with a running (distance, position) top-k'
    — the executor both scan stages share.  ``distance(q, lq, gid, valid)``
    returns one chunk's [Q, C] masked distances.  Each merge stable-sorts
    [running | chunk]: running entries hold strictly earlier positions, so
    value ties resolve toward them and the pool stays in (distance,
    position) order chunk by chunk — ``lax.top_k``'s order in the JAX
    executor, and surviving +inf slots keep the pool's ``pos == lmax``.
    Chunks wholly past every segment's end are skipped: they hold only
    +inf lanes, which the stable merge would rank after the pool anyway.
    Returns (vals [Q, kp], pos [Q, kp] int32)."""
    Q = q.shape[0]
    run_v = torch.full((Q, kp), INF, dtype=torch.float32, device=q.device)
    run_p = torch.full((Q, kp), lmax, dtype=torch.int32, device=q.device)
    if Q == 0:
        return run_v, run_p
    span = min(lmax, int(lens.max()))
    for c0 in range(0, span, chunk):
        pos = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                           device=q.device)
        gid, valid = segment_gids(rows_concat, starts, lens, pos)
        d = distance(q, lq, gid, valid)
        cat_v = torch.cat([run_v, d], dim=1)
        cat_p = torch.cat([run_p, pos[None, :].expand(Q, chunk)], dim=1)
        run_v, sel = lex_topk(cat_v, kp)
        run_p = torch.gather(cat_p, 1, sel)
    return run_v, run_p


def rerank_shortlist(q, lq, rr, rrn, rows_concat, starts, pos, *, k: int,
                     lmax: int, metric: str, distance_fn=None):
    """Stage 2 of a ``+rerank`` storage spec: re-sort the shortlist
    positions ``pos`` [Q, kp], recompute exact f32 distances against the
    rerank tier, and keep the (exact distance, position) top-k.
    ``distance_fn(q, lq, rr, sgid, n_listed)`` replaces the norms-form
    recompute (the ``"cuda"`` backend passes the direct-form gather
    kernel).  Returns (vals [Q, k], pos [Q, k])."""
    R = rows_concat.shape[0]
    spos, _ = torch.sort(pos, dim=1, stable=True)
    listed = spos < lmax
    sp = torch.clamp(starts[:, None] + spos, 0, max(R - 1, 0))
    sgid = rows_concat[torch.where(listed, sp, 0).long()].long()
    if distance_fn is None:
        ip = torch.sum(rr[sgid] * q[:, None, :], dim=-1)
        if metric == "ip":
            d = -ip
        else:
            qn = torch.sum(q * q, dim=1)
            d = qn[:, None] - 2.0 * ip + rrn[sgid]
        d = torch.where(listed, d, torch.full_like(d, INF))
    else:
        d = distance_fn(q, lq, rr, sgid,
                        torch.sum(listed, dim=1).to(torch.int32))
    kp = pos.shape[1]
    if kp < k:
        d = torch.nn.functional.pad(d, (0, k - kp), value=INF)
        spos = torch.nn.functional.pad(spos, (0, k - kp), value=lmax)
    vals, sel = lex_topk(d, k)
    return vals, torch.gather(spos, 1, sel)


def segmented_filtered_topk(q, lq, ax, alw, axn, rows_concat, starts, lens,
                            k: int, lmax: int, metric: str = "l2",
                            tomb=None, dtype: str = "f32", scales=None,
                            zeros=None, rerank=None, rerank_norms=None,
                            kprime: int | None = None):
    """Unchunked segmented arena top-k oracle (DESIGN.md §3): every query
    scans its ``(start, len)`` segment of ``rows_concat`` in one piece.
    Returns (vals [Q, k] asc, pos [Q, k] int32 segment positions; pos ==
    ``lmax`` ⇒ empty slot).  Ties break toward the lower position."""
    kp = k if rerank is None else max(k, min(kprime or 4 * k, lmax))
    pos = torch.arange(lmax, dtype=torch.int32, device=q.device)
    gid, valid = segment_gids(rows_concat, starts, lens, pos)
    d = scan_distances(q, lq, ax, alw, axn, gid, valid, metric=metric,
                       dtype=dtype, scales=scales, zeros=zeros, tomb=tomb)
    if kp > lmax:
        d = torch.nn.functional.pad(d, (0, kp - lmax), value=INF)
    vals, sel = lex_topk(d, kp)
    empty = torch.isinf(vals)
    sel = torch.where(empty, lmax, sel)
    vals = torch.where(empty, INF, vals)
    if rerank is not None:
        vals, sel = rerank_shortlist(q, lq, rerank, rerank_norms,
                                     rows_concat, starts, sel, k=k,
                                     lmax=lmax, metric=metric)
        empty = torch.isinf(vals)
        sel = torch.where(empty, lmax, sel)
        vals = torch.where(empty, INF, vals)
    return vals, sel.to(torch.int32)
