"""Dense label-filtered top-k (DESIGN.md §3).

The port of ``repro/kernels/filtered_topk.py::filtered_topk_pallas``: the
k nearest rows of a private index that pass each query's label filter, in
(distance, row) order; rows short of k pass pad with (+inf, N).  The
private-copy ``FlatIndex`` runs it.

:func:`filtered_topk` is the wrapper.  On a CPU tensor it runs
:func:`filtered_topk_plain` — ``masked_distance_plain`` followed by
:func:`masked_topk_tail`; on a CUDA tensor it launches the hand-written
kernel in ``csrc/filtered_topk.cu`` (bound, design and the TPU kernel it
replaces are in that file's head) or raises.  The kernel's distances come
from the same tile code as ``csrc/masked_distance.cu``, bit for bit.

:func:`masked_topk_tail` is the one home of the flat top-k epilogue (the
tombstone AND, the k > n pad, the (value, index) top-k and the (+inf, n)
empty slot); ``ops`` re-exports it.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref
from .masked_distance import ROW_TILE, check_operands, masked_distance_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"filtered_topk": [_P] * 8 + [_I] * 8 + [_P]}
MAX_K = 32                 # csrc/filtered_topk.cu: one pool slot per lane
BLOCKS_PER_SM = 4          # span split target: blocks in flight per SM
PLAIN_TILE_ELEMS = 1 << 28  # [Q, N] distances per plain query tile


def masked_topk_tail(d, tomb, n: int, *, k: int):
    """Epilogue of a flat masked-distance top-k: the optional tombstone
    AND over the row ids, the k > n inf-pad, the (distance, index) top-k
    and the (+inf, n) empty-slot normalization."""
    if tomb is not None:
        alive = ref.tombstone_mask(
            tomb, torch.arange(n, dtype=torch.int32, device=d.device))
        d = torch.where(alive[None, :], d, torch.full_like(d, ref.INF))
    if k > n:
        d = torch.nn.functional.pad(d, (0, k - n), value=ref.INF)
    vals, idxs = ref.lex_topk(d, k)
    empty = torch.isinf(vals)
    idxs = torch.where(empty, n, idxs)
    vals = torch.where(empty, ref.INF, vals)
    return vals, idxs.to(torch.int32)


def filtered_topk_plain(q, x, lq, lx, *, k: int, metric: str = "l2"):
    """Plain torch version on any device, tiled over the queries so it
    never holds more than ``PLAIN_TILE_ELEMS`` distances at once (each
    query's top-k is independent of the others)."""
    Q, n = q.shape[0], x.shape[0]
    if Q == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    tile = max(1, PLAIN_TILE_ELEMS // max(n, 1))
    parts = [masked_topk_tail(masked_distance_plain(
        q[t:t + tile], x, lq[t:t + tile], lx, metric=metric), None, n, k=k)
        for t in range(0, Q, tile)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def span_split(Q: int, N: int, sms: int) -> tuple[int, int]:
    """(span, splits): rows per block, a multiple of ``ROW_TILE``, and
    the number of spans, so that the grid holds about ``BLOCKS_PER_SM``
    blocks per SM."""
    qtiles = -(-Q // (16 if Q <= 16 else 64))   # the kernel's BQ
    tiles = -(-N // ROW_TILE)
    splits = min(tiles, 65_535, max(1, -(-BLOCKS_PER_SM * sms // qtiles)))
    span = -(-tiles // splits) * ROW_TILE
    return span, -(-N // span)


def filtered_topk(q, x, lq, lx, *, k: int, metric: str = "l2"):
    """``q`` [Q, D] f32, ``x`` [N, D] f32, ``lq`` [Q, W] i32, ``lx``
    [N, W] i32 -> (vals [Q, k] f32 ascending, idxs [Q, k] i32; idx == N ⇒
    empty slot).  The kernel keeps at most ``MAX_K`` per query."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if q.device.type == "cpu":
        return filtered_topk_plain(q, x, lq, lx, k=k, metric=metric)
    check_operands("filtered_topk", q, x, lq, lx)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"filtered_topk: k={k} outside the kernel's pool "
                         f"capacity [1, {MAX_K}]")
    Q, D = q.shape
    N, W = lx.shape
    out_v = torch.full((Q, k), ref.INF, dtype=torch.float32, device=q.device)
    out_p = torch.full((Q, k), N, dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return out_v, out_p
    span, splits = span_split(
        Q, N, torch.cuda.get_device_properties(q.device).multi_processor_count)
    part_v = part_p = None
    if splits > 1:
        part_v = torch.empty((Q, splits, k), dtype=torch.float32,
                             device=q.device)
        part_p = torch.empty((Q, splits, k), dtype=torch.int32,
                             device=q.device)
    lib = cuda_build.load("filtered_topk", _SIGNATURES)
    p = cuda_build.ptr
    code = lib.filtered_topk(
        p(q), p(x), p(lq), p(lx), p(part_v), p(part_p), p(out_v), p(out_p),
        Q, N, D, W, k, span, splits, int(metric == "ip"),
        torch.cuda.current_stream(q.device).cuda_stream)
    filtered_topk.launches += 1
    cuda_build.check(code, "filtered_topk")
    return out_v, out_p


filtered_topk.launches = 0
