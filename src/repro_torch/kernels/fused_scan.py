"""Fused segmented arena scan (DESIGN.md §3.9).

The port of ``repro/kernels/fused_scan.py``: gather each query's candidate
rows through the CSR segment table, dequantize, compute distances, apply
the label / tombstone / segment-length filter and keep a running
(distance, position) top-k' — without a [Q, span] distance matrix.

:func:`fused_segmented_scan` is the wrapper.  On a CPU tensor (or on the
``"ref"`` backend) it runs :func:`fused_scan_plain`, the chunked torch
scan that is arithmetically the unfused ``"ref"`` executor tiled by query;
on a CUDA tensor with the ``"cuda"`` backend it launches the hand-written
kernel in ``csrc/fused_scan.cu`` (bound, design and the TPU kernel it
replaces are in that file's head) or raises.

Both follow the oracle (``ref.segmented_filtered_topk``): lane ``pos``
reads ``rows_concat[clip(start + pos, 0, R-1)]``.  The Pallas kernel of
the JAX package clamps its id-window copy instead, which mislabels the
lanes of a tail segment (ROADMAP C); the port does not copy that.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref

_DTYPES = {"f32": 0, "fp16": 1, "int8": 2}
_TORCH_DTYPES = {"f32": torch.float32, "fp16": torch.float16,
                 "int8": torch.uint8}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_scan": [_P] * 6 + [_I] + [_P] * 9 + [_I] * 10 + [_P]}
SCAN_THREADS = 256        # csrc/fused_scan.cu kThreads
MAX_LABEL_WORDS = 8       # csrc/fused_scan.cu kMaxWords
SMEM_BYTES = 48 * 1024    # static launch limit (no opt-in attribute set)


def block_smem_bytes(d: int, kp: int) -> int:
    """Dynamic shared memory of one ``csrc/fused_scan.cu`` block: the
    query row, two sorted k'-pools and one tile of candidates."""
    return 4 * d + 4 * (4 * kp + 2 * SCAN_THREADS)


def resolve_fused(fused, *, backend: str) -> bool:
    """Resolve the public ``fused=True|False|"auto"`` flag: ``"auto"``
    enables the fused kernel on the ``"cuda"`` backend and keeps the
    ``"ref"`` executor unfused — the JAX package's rule with ``"cuda"`` in
    place of ``"pallas"``."""
    if fused == "auto":
        return backend == "cuda"
    if fused in (True, False):
        return bool(fused)
    raise ValueError(f"fused must be True, False or 'auto'; got {fused!r}")


def clamp_qtile(qtile: int, q: int) -> int:
    """Largest power-of-two ≤ ``qtile`` that divides ``q``."""
    qtile = max(1, min(qtile, q))
    while q % qtile:
        qtile //= 2
    return max(1, qtile)


def fused_scan_plain(q, lq, ax, alw, axn, rows_concat, starts, lens, tomb,
                     scales, zeros, *, kp: int, lmax: int, chunk: int,
                     qtile: int, metric: str, dtype: str):
    """Plain torch version: query tiles of ``qtile``, each a chunked scan
    with a running (distance, position) top-k' (``ref.chunked_scan``).
    The tiling never changes a result bit (per-query rows are
    independent)."""
    Q = q.shape[0]
    qtile = clamp_qtile(qtile, Q)

    def distance(qt, lqt, gid, valid):
        return ref.scan_distances(qt, lqt, ax, alw, axn, gid, valid,
                                  metric=metric, dtype=dtype, scales=scales,
                                  zeros=zeros, tomb=tomb)

    parts = [ref.chunked_scan(q[t:t + qtile], lq[t:t + qtile], rows_concat,
                              starts[t:t + qtile], lens[t:t + qtile],
                              distance, kp=kp, lmax=lmax, chunk=chunk)
             for t in range(0, Q, qtile)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([p for _, p in parts]))


def fused_segmented_scan(q, lq, ax, alw, axn, rows_concat, starts, lens,
                         tomb, scales, zeros, *, kp: int, lmax: int,
                         chunk: int, qtile: int, metric: str, dtype: str,
                         backend: str):
    """Scan stage of the fused path: (vals [Q, kp] asc, pos [Q, kp] i32,
    pos == lmax ⇒ empty).  ``chunk`` is the plain version's chunk and the
    kernel's span per block (its split); ``qtile`` tiles the plain version
    only.  The caller (``ops.segmented_topk``) owns the rerank stage and
    the empty-slot/gid epilogue."""
    if lmax % chunk:
        raise ValueError(f"chunk {chunk} must divide lmax {lmax}")
    if backend == "ref" or q.device.type == "cpu":
        return fused_scan_plain(q, lq, ax, alw, axn, rows_concat, starts,
                                lens, tomb, scales, zeros, kp=kp, lmax=lmax,
                                chunk=chunk, qtile=qtile, metric=metric,
                                dtype=dtype)
    return fused_scan_cuda(q, lq, ax, alw, axn, rows_concat, starts, lens,
                           tomb, scales, zeros, kp=kp, lmax=lmax, span=chunk,
                           metric=metric, dtype=dtype)


def fused_scan_cuda(q, lq, ax, alw, axn, rows_concat, starts, lens, tomb,
                    scales, zeros, *, kp: int, lmax: int, span: int,
                    metric: str, dtype: str):
    """Launch ``csrc/fused_scan.cu`` with one block per (query, span
    split of ``span`` positions)."""
    Q, D = q.shape
    W = lq.shape[1]
    int8 = dtype == "int8"
    l2 = metric == "l2"
    operands = dict(q=(q, torch.float32), lq=(lq, torch.int32),
                    ax=(ax, _TORCH_DTYPES[dtype]), alw=(alw, torch.int32),
                    rows_concat=(rows_concat, torch.int32),
                    starts=(starts, torch.int32), lens=(lens, torch.int32))
    if l2:
        operands["axn"] = (axn, torch.float32)
    if int8:
        operands.update(scales=(scales, torch.float32),
                        zeros=(zeros, torch.float32))
    if tomb is not None:
        operands["tomb"] = (tomb, torch.uint8)
    for name, (t, dt) in operands.items():
        if t is None or t.device != q.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"fused_segmented_scan: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    if ax.shape[1] != D or alw.shape[1] != W or lq.shape[0] != Q \
            or starts.shape != (Q,) or lens.shape != (Q,):
        raise ValueError("fused_segmented_scan: shape mismatch")
    smem = block_smem_bytes(D, kp)
    if W > MAX_LABEL_WORDS or smem > SMEM_BYTES or Q > 65_535 \
            or rows_concat.shape[0] == 0:
        raise ValueError(f"fused_segmented_scan: W={W} (max "
                         f"{MAX_LABEL_WORDS}), D={D}, kp={kp} need {smem} "
                         f"B of shared memory (max {SMEM_BYTES}), Q={Q} "
                         f"(max 65535), R={rows_concat.shape[0]} (min 1)")
    out_v = torch.empty((Q, kp), dtype=torch.float32, device=q.device)
    out_p = torch.empty((Q, kp), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_v, out_p
    splits = -(-lmax // span)
    part_v = part_p = None
    if splits > 1:
        part_v = torch.empty((Q, splits, kp), dtype=torch.float32,
                             device=q.device)
        part_p = torch.empty((Q, splits, kp), dtype=torch.int32,
                             device=q.device)
    lib = cuda_build.load("fused_scan", _SIGNATURES)
    vec = D % 16 == 0 and ax.data_ptr() % 16 == 0
    p = cuda_build.ptr
    code = lib.fused_scan(
        p(q), p(lq), p(ax), p(alw), p(axn) if l2 else None, p(rows_concat),
        rows_concat.shape[0], p(starts), p(lens), p(tomb),
        p(scales) if int8 else None, p(zeros) if int8 else None,
        p(part_v), p(part_p), p(out_v), p(out_p),
        Q, D, W, lmax, kp, span, splits, _DTYPES[dtype], int(not l2),
        int(vec), torch.cuda.current_stream(q.device).cuda_stream)
    fused_segmented_scan.launches += 1
    cuda_build.check(code, "fused_scan")
    return out_v, out_p


fused_segmented_scan.launches = 0
