"""Dense label-filtered top-k (DESIGN.md §3).

The port of ``repro/kernels/filtered_topk.py::filtered_topk_pallas``: the
k nearest rows of a private index that pass each query's label filter, in
(distance, row) order; rows short of k pass pad with (+inf, N).  The
private-copy ``FlatIndex`` runs it.

:func:`filtered_topk` is the wrapper.  On a CPU tensor it runs
:func:`filtered_topk_plain` — ``masked_distance_plain`` followed by
:func:`masked_topk_tail`; on a CUDA tensor it launches the hand-written
kernel in ``csrc/filtered_topk.cu`` (bound, design and the TPU kernel it
replaces are in that file's head) or raises.  k runs from 1 to
``MAX_K`` = 256 on every device.  The kernel's distances come
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
_SIGNATURES = {"filtered_topk": [_P] * 8 + [_I] * 8 + [_P],
               "filtered_topk_planted": [_P] * 8 + [_I] * 8 + [_P, _I],
               "filtered_topk_smem_bytes": [_I, _I],
               "filtered_topk_blocks_per_sm": [_I, _I]}
# csrc/filtered_topk.cu keeps each query's pool of k keys in shared memory
# (KCAP 32 or 256 by instance): k above 256 raises, on every device
MAX_K = 256
# the partial kernel's __launch_bounds__ minimum, the same for every
# instance: the blocks an SM it is compiled for.  The span split aims at
# what the card reports for the instance (the library's occupancy entry),
# which is fewer where the pools' shared memory does not fit three
TILE_BLOCKS_PER_SM = 3
PLANTED_FAULTS = {1: "only the first survivor of each ballot enters the "
                     "pool",
                  2: "the threshold read one pool slot early"}
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


def query_tile(Q: int, k: int) -> int:
    """Queries a block of the partial kernel takes (its instance), as
    ``csrc/filtered_topk.cu``'s ``query_tile`` picks it: 16 × 128 for
    Q ≤ 16; 32 × 128 for Q ≤ 64 or k > 32; 128 × 64 otherwise."""
    if Q <= 16:
        return 16
    return 32 if k > 32 or Q <= 64 else 128


def span_split(Q: int, N: int, sms: int, k: int,
               blocks_per_sm: int) -> tuple[int, int]:
    """(span, splits): rows per block, a multiple of ``ROW_TILE``, and
    the number of spans, so that the grid of query tiles × spans fills
    whole waves of the ``blocks_per_sm`` · ``sms`` blocks the card holds
    at once, and no more."""
    qtiles = -(-Q // query_tile(Q, k))
    slots = blocks_per_sm * sms
    waves = -(-qtiles // slots)
    tiles = -(-N // ROW_TILE)
    splits = min(tiles, 65_535, max(1, waves * slots // qtiles))
    span = -(-tiles // splits) * ROW_TILE
    return span, -(-N // span)


def blocks_per_sm(lib, Q: int, k: int) -> int:
    """Blocks of (Q, k)'s instance an SM of the card holds, from the
    library's occupancy entry, once per (query tile, k)."""
    key = (query_tile(Q, k), k)
    if key not in _BLOCKS_PER_SM:
        held = lib.filtered_topk_blocks_per_sm(Q, k)
        if held < 1:
            raise RuntimeError(f"filtered_topk: no block of the Q={Q}, k={k} "
                               f"instance fits an SM ({held})")
        _BLOCKS_PER_SM[key] = held
    return _BLOCKS_PER_SM[key]


_BLOCKS_PER_SM: dict[tuple[int, int], int] = {}


def filtered_topk(q, x, lq, lx, *, k: int, metric: str = "l2"):
    """``q`` [Q, D] f32, ``x`` [N, D] f32, ``lq`` [Q, W] i32, ``lx``
    [N, W] i32 -> (vals [Q, k] f32 ascending, idxs [Q, k] i32; idx == N ⇒
    empty slot).  1 ≤ k ≤ ``MAX_K`` on every device."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if not 1 <= k <= MAX_K:   # the kernel's pool capacity, on every device
        raise ValueError(f"filtered_topk: k={k} outside the kernel's pool "
                         f"capacity [1, {MAX_K}]")
    if q.device.type == "cpu":
        return filtered_topk_plain(q, x, lq, lx, k=k, metric=metric)
    out = _launch("filtered_topk", q, x, lq, lx, k=k, metric=metric)
    filtered_topk.launches += 1
    return out


filtered_topk.launches = 0


def filtered_topk_planted(q, x, lq, lx, *, k: int, metric: str = "l2",
                          fault: int):
    """:func:`filtered_topk` made wrong on purpose by planted fault
    ``fault`` (:data:`PLANTED_FAULTS`), for the checks that must reject
    it: the 128 × 64 instance (Q > 64, k ≤ 32) with the fault compiled in,
    behind an entry of its own.  CUDA tensors only; not counted in
    ``filtered_topk.launches``."""
    if fault not in PLANTED_FAULTS or q.device.type != "cuda" \
            or query_tile(q.shape[0], k) != 128:
        raise ValueError(f"filtered_topk_planted: fault {fault} on "
                         f"{q.device.type} at Q={q.shape[0]}, k={k}; faults "
                         f"are {list(PLANTED_FAULTS)}, on the card, at the "
                         f"128-query instance")
    return _launch("filtered_topk_planted", q, x, lq, lx, k=k, metric=metric,
                   fault=(fault,))


def _launch(entry, q, x, lq, lx, *, k, metric, fault=()):
    check_operands("filtered_topk", q, x, lq, lx)
    Q, D = q.shape
    N, W = lx.shape
    out_v = torch.full((Q, k), ref.INF, dtype=torch.float32, device=q.device)
    out_p = torch.full((Q, k), N, dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return out_v, out_p
    lib = cuda_build.load("filtered_topk", _SIGNATURES)
    span, splits = span_split(
        Q, N, torch.cuda.get_device_properties(q.device).multi_processor_count,
        k, blocks_per_sm(lib, Q, k))
    part_v = part_p = None
    if splits > 1:
        part_v = torch.empty((Q, splits, k), dtype=torch.float32,
                             device=q.device)
        part_p = torch.empty((Q, splits, k), dtype=torch.int32,
                             device=q.device)
    p = cuda_build.ptr
    code = getattr(lib, entry)(
        p(q), p(x), p(lq), p(lx), p(part_v), p(part_p), p(out_v), p(out_p),
        Q, N, D, W, k, span, splits, int(metric == "ip"),
        torch.cuda.current_stream(q.device).cuda_stream, *fault)
    cuda_build.check(code, entry)
    return out_v, out_p
