"""Gathered distances: the segmented arena gather (DESIGN.md §3) and the
graph backend's per-hop neighbour distances.

The port of ``repro/kernels/gather_distance.py::
segmented_gather_distance_pallas``: [Q, L] masked distances of each query
to its own list of arena rows.  Two roles on the main path: the scan stage
of the unfused executor (the engine default) and the exact f32 recompute
of the ``+rerank`` storage specs.

:func:`segmented_gather_distance` is the wrapper.  On a CPU tensor it runs
:func:`segmented_gather_distance_plain`; on a CUDA tensor it launches the
hand-written kernel in ``csrc/gather_distance.cu`` (bound, design and the
TPU kernel it replaces are in that file's head) or raises.  Both compute
the TPU kernel's DIRECT form ``sum((q - x)²)`` for l2 — not the norms form
of the scan oracle — so the port's ``"cuda"`` backend matches the JAX
package's ``"pallas"`` backend; the two forms differ in value, not in
position (DESIGN.md §3.9).

The kernel has two schedules that agree bitwise on every input (each
value a chain of rounded operations in order over D, never an FMA): one
thread per (query, candidate) pair (``max_qtile=1``), and, for f32 and
f16 rows, the tile schedule, whose block takes up to ``TILE_QUERIES``
consecutive queries and ``TILE_COLUMNS`` columns and reads each row once
for a run of more than ``TILE_MIN_RUN`` queries that list the same rows
(the unfused executor's queries of one segment).  :func:`gather_qtile`
picks between them from the launch's shape and storage, with no read of
the device: the tile where its grid fills the card, else one thread a
pair (int8 rows always).  The +rerank shortlists, whose lists differ per
query, pass ``max_qtile=1``.  :func:`tile_smem_bytes` mirrors the tile
block's shared-memory layout.  Bound: each row read once for the
queries that list it, ~3·D rounded operations a live pair.

:func:`gather_distance` is the port of ``gather_distance_pallas``: the
distances of each query to its own list of scattered rows, ids < 0 ->
+inf, in the same direct form.  The graph's beam search calls it once per
hop with the [bucket, M] neighbour ids of the nodes it expands.  Its
wrapper follows the same rule: :func:`gather_distance_plain` on a CPU
tensor, the kernel in ``csrc/gather_distance.cu`` on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.uint8: 2}
_STORAGE = {torch.float32: "f32", torch.float16: "fp16", torch.uint8: "int8"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"seg_gather_distance": [_P] * 9 + [_I] * 8 + [_P],
               "gather_distance": [_P] * 4 + [_I] * 5 + [_P],
               "seg_gather_smem_bytes": [_I]}
MAX_LABEL_WORDS = 8
MAX_DIM = 12_288          # the query row is staged in 48 KB of shared memory
TILE_QUERIES = 64         # csrc/gather_distance.cu gtile::kTQ
TILE_COLUMNS = 128        # gtile::kBN: gids columns a block
TILE_STEP = 32            # gtile::kKC: features a copy step
MAX_WINDOWS = 65_535      # column windows on gridDim.y
# gtile::kMinRun: runs of more than this many queries read each row
# once; shorter runs take the per-pair code inside the tile block, which
# skips the pairs whose labels fail
TILE_MIN_RUN = 8
TILE_BLOCKS_PER_SM = 2    # the tile kernel's launch bound
TILE_STORAGES = {"f32": 4, "fp16": 2}    # rows the tile takes: bytes each
H100_SMS = 132            # gather_qtile's card when none is named


def tile_smem_bytes(storage: str) -> int:
    """Dynamic shared memory of a tile-schedule block for ``storage``
    rows ("f32" or "fp16"): gtile::Layout<DT>::BYTES."""
    rp = TILE_STEP * TILE_STORAGES[storage] + 16      # staged row pitch
    ld = TILE_STEP + 4                                # staged f32 pitch
    wp = MAX_LABEL_WORDS + 1
    nbytes = (2 * TILE_COLUMNS * rp + 2 * TILE_QUERIES * ld * 4
              + (0 if storage == "f32" else TILE_COLUMNS * ld * 4))
    nbytes += TILE_COLUMNS * (4 + 4 * wp)             # ids, labels
    nbytes += TILE_QUERIES * (4 + 4 * wp + 4 + 4)     # lens, labels, flags
    return nbytes + (3 * TILE_QUERIES + 1) * 4        # the run table


def check_max_qtile(max_qtile) -> None:
    if max_qtile is not None and (
            isinstance(max_qtile, bool) or not isinstance(max_qtile, int)
            or not 1 <= max_qtile <= TILE_QUERIES):
        raise ValueError(f"max_qtile must be None or an int in [1, "
                         f"{TILE_QUERIES}], not {max_qtile!r}")


def gather_qtile(Q: int, L: int, *, storage: str = "f32",
                 sms: int = H100_SMS, max_qtile=None) -> int:
    """Queries per block of a [Q, L] launch over ``storage`` rows ("f32",
    "fp16" or "int8") on a card of ``sms`` SMs: 1 is the per-pair kernel,
    else qt = min(Q, ``max_qtile``, ``TILE_QUERIES``) — the tile schedule,
    taken for f32 and f16 rows where a block can hold a run of more than
    ``TILE_MIN_RUN`` queries and its ceil(Q / qt) × ceil(L / 128) grid
    holds at least the ``TILE_BLOCKS_PER_SM`` · ``sms`` blocks the card
    runs at once (fewer leave SMs idle where the per-pair kernel fills
    them; PERF.md §6)."""
    check_max_qtile(max_qtile)
    qt = min(Q, TILE_QUERIES if max_qtile is None else max_qtile)
    windows = -(-L // TILE_COLUMNS)
    if storage not in TILE_STORAGES or qt <= TILE_MIN_RUN \
            or windows > MAX_WINDOWS \
            or -(-Q // qt) * windows < TILE_BLOCKS_PER_SM * sms:
        return 1
    return qt


def _sms(device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


_SMS: dict = {}


def segmented_gather_distance_plain(q, lq, x, lxw, gids, lens, *,
                                    metric: str = "l2", scales=None,
                                    zeros=None):
    """Plain torch version: the same function on any device."""
    g = gids.long()
    xr = ref.dequantize_rows(x[g], _STORAGE[x.dtype],
                             None if scales is None else scales[g],
                             None if zeros is None else zeros[g])
    if metric == "ip":
        d = -torch.sum(q[:, None, :] * xr, dim=-1)
    else:
        t = q[:, None, :] - xr
        d = torch.sum(t * t, dim=-1)
    ok = torch.all((lq[:, None, :] & lxw[g]) == lq[:, None, :], dim=-1)
    li = torch.arange(gids.shape[1], device=gids.device)
    valid = li[None, :] < lens[:, None]
    return torch.where(ok & valid, d, torch.full_like(d, ref.INF))


def segmented_gather_distance(q, lq, x, lxw, gids, lens, *,
                              metric: str = "l2", scales=None, zeros=None,
                              max_qtile=None):
    """``q`` [Q, D] f32, ``lq`` [Q, W] i32, ``x`` [N, D] f32|f16|u8 arena
    rows, ``lxw`` [N, W] i32, ``gids`` [Q, L] i32 arena row ids (in range
    below ``lens``), ``lens`` [Q] i32 (positions >= len are +inf),
    ``scales``/``zeros`` [N] f32 for u8 codes.  ``max_qtile`` bounds the
    queries of a tile-schedule block (None: up to ``TILE_QUERIES``; 1: the
    per-pair kernel); it changes no bit, and the plain version ignores it.
    Returns [Q, L] f32 masked distances."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    check_max_qtile(max_qtile)
    if q.device.type == "cpu":
        return segmented_gather_distance_plain(
            q, lq, x, lxw, gids, lens, metric=metric, scales=scales,
            zeros=zeros)
    Q, D = q.shape
    L = gids.shape[1]
    W = lq.shape[1]
    int8 = x.dtype == torch.uint8
    operands = dict(q=(q, torch.float32), lq=(lq, torch.int32),
                    x=(x, x.dtype), lxw=(lxw, torch.int32),
                    gids=(gids, torch.int32), lens=(lens, torch.int32))
    if int8:
        operands.update(scales=(scales, torch.float32),
                        zeros=(zeros, torch.float32))
    for name, (t, dt) in operands.items():
        if t is None or t.device != q.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"segmented_gather_distance: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported arena dtype {x.dtype}")
    if x.shape[1] != D or lxw.shape[1] != W or gids.shape[0] != Q \
            or lens.shape != (Q,) or lq.shape[0] != Q:
        raise ValueError("segmented_gather_distance: shape mismatch")
    if W > MAX_LABEL_WORDS or D > MAX_DIM or Q > 65_535:
        raise ValueError(f"segmented_gather_distance: W={W} (max "
                         f"{MAX_LABEL_WORDS}), D={D} (max {MAX_DIM}), "
                         f"Q={Q} (max 65535)")
    out = torch.empty((Q, L), dtype=torch.float32, device=q.device)
    if Q == 0 or L == 0:
        return out
    lib = cuda_build.load("gather_distance", _SIGNATURES)
    vec = D % 16 == 0 and x.data_ptr() % 16 == 0
    qtile = 1
    if vec and q.data_ptr() % 16 == 0:
        qtile = gather_qtile(Q, L, storage=_STORAGE[x.dtype],
                             sms=_sms(q.device), max_qtile=max_qtile)
    p = cuda_build.ptr
    code = lib.seg_gather_distance(
        p(q), p(lq), p(x), p(lxw), p(gids), p(lens),
        p(scales) if int8 else None, p(zeros) if int8 else None, p(out),
        Q, L, D, W, _DTYPES[x.dtype], int(metric == "ip"), int(vec), qtile,
        torch.cuda.current_stream(q.device).cuda_stream)
    segmented_gather_distance.launches += 1
    cuda_build.check(code, "seg_gather_distance")
    return out


segmented_gather_distance.launches = 0


def gather_distance_plain(q, x, ids, *, metric: str = "l2"):
    """Plain torch version on any device: ``q`` [Q, D], ``x`` [N, D],
    ``ids`` [Q, B] -> [Q, B] direct-form distances, ids < 0 -> +inf.
    Each sum runs in order over D, one rounded multiply and one rounded
    add per feature, as the kernel sums: the two agree bitwise on any data,
    so a graph walk on ``"ref"`` takes the kernel's path.  The rounded
    per-feature terms are taken in one pass, then added in order."""
    rows = x[torch.clamp(ids, 0, max(x.shape[0] - 1, 0)).long()]
    if metric == "ip":
        terms = rows * q[:, None, :]
    else:
        t = q[:, None, :] - rows
        terms = t * t
    d = torch.zeros(ids.shape, dtype=torch.float32, device=q.device)
    for e in range(q.shape[1]):
        d = d + terms[..., e]
    if metric == "ip":
        d = -d
    return torch.where(ids >= 0, d, torch.full_like(d, ref.INF))


def gather_distance(q, x, ids, *, metric: str = "l2"):
    """``q`` [Q, D] f32, ``x`` [N, D] f32, ``ids`` [Q, B] i32 (< N; < 0 is
    padding) -> [Q, B] f32 distances of each query to its own rows."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if q.device.type == "cpu":
        return gather_distance_plain(q, x, ids, metric=metric)
    for name, t, dt in (("q", q, torch.float32), ("x", x, torch.float32),
                        ("ids", ids, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 2:
            raise ValueError(f"gather_distance: {name} must be a contiguous "
                             f"2-d {dt} tensor on {q.device}")
    Q, D = q.shape
    B = ids.shape[1]
    if x.shape[1] != D or ids.shape[0] != Q:
        raise ValueError("gather_distance: shape mismatch")
    out = torch.empty((Q, B), dtype=torch.float32, device=q.device)
    if Q == 0 or B == 0:
        return out
    lib = cuda_build.load("gather_distance", _SIGNATURES)
    vec = D % 16 == 0 and x.data_ptr() % 16 == 0
    p = cuda_build.ptr
    code = lib.gather_distance(
        p(q), p(x), p(ids), p(out), Q, B, D, int(metric == "ip"), int(vec),
        torch.cuda.current_stream(q.device).cuda_stream)
    gather_distance.launches += 1
    cuda_build.check(code, "gather_distance")
    return out


gather_distance.launches = 0
