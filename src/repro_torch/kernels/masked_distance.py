"""Dense label-masked distances (DESIGN.md §3).

The port of ``repro/kernels/masked_distance.py::masked_distance_pallas``:
the [Q, N] distance matrix of a query batch against every row of a
private index, +inf where the label containment fails.  The IVF backend
runs it twice per search: against its centroids and against its rows.

:func:`masked_distance` is the wrapper.  On a CPU tensor it runs
:func:`masked_distance_plain`; on a CUDA tensor it launches the
hand-written kernel in ``csrc/masked_distance.cu`` (bound, design and the
TPU kernel it replaces are in that file's head) or raises.  Both compute
the Pallas kernel's norms form ``(‖q‖² − 2·ip) + ‖x‖²`` for l2 and ``−ip``
for ip, never ``q @ x.T``, whose accumulation order changes with the batch
size (ROADMAP C0), so a row's distances do not depend on its batch
neighbours: the plain version sums with a multiply and a reduce over the
feature axis, the kernel each inner product and norm as one chain of FMAs
in order over D (``csrc/dense_tile.cuh``).  The two agree bitwise on
integer data and within rtol 1e-5 on random data.  Bound on the card:
2·Q·N·D flops at 67 TFLOP/s for Q ≥ 16 (about 0.99 ms at [256, 10^6],
D 128), the [Q, N] output's bytes below that.  ``ref.masked_distance``
(the matmul form) stays the oracle.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"masked_distance": [_P] * 5 + [_I] * 5 + [_P],
               "masked_distance_smem_bytes": [_I]}
MAX_LABEL_WORDS = 8        # csrc/dense_tile.cuh kMaxWords
ROW_TILE = 128             # csrc/filtered_topk.cu BN: rows per tile
MAX_ROWS = 65_535 * ROW_TILE   # the dense kernels' operand contract
PLAIN_CHUNK_ELEMS = 1 << 24    # [Q, rows, D] products per plain chunk


def masked_distance_plain(q, x, lq, lx, *, metric: str = "l2"):
    """Plain torch version on any device, chunked over the rows so it
    never builds more than ``PLAIN_CHUNK_ELEMS`` products at once."""
    Q, D = q.shape
    N = x.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    if Q == 0 or N == 0:
        return out
    qn = torch.sum(q * q, dim=1)
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(Q * D, 1))
    for c0 in range(0, N, chunk):
        xc = x[c0:c0 + chunk]
        ip = torch.sum(q[:, None, :] * xc[None, :, :], dim=-1)
        if metric == "ip":
            d = -ip
        else:
            d = (qn[:, None] - 2.0 * ip) + torch.sum(xc * xc, dim=1)[None, :]
        keep = ref.containment_mask(lq, lx[c0:c0 + chunk])
        out[:, c0:c0 + chunk] = torch.where(keep, d, torch.full_like(d, ref.INF))
    return out


def check_operands(fn: str, q, x, lq, lx) -> None:
    """The dense kernels' operand contract (shared with filtered_topk)."""
    for name, t, dt in (("q", q, torch.float32), ("x", x, torch.float32),
                        ("lq", lq, torch.int32), ("lx", lx, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 2:
            raise ValueError(f"{fn}: {name} must be a contiguous 2-d {dt} "
                             f"tensor on {q.device}")
    Q, D = q.shape
    N, W = lx.shape
    if x.shape != (N, D) or lq.shape != (Q, W):
        raise ValueError(f"{fn}: shape mismatch q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}, lq {tuple(lq.shape)}, lx "
                         f"{tuple(lx.shape)}")
    if W > MAX_LABEL_WORDS or N > MAX_ROWS:
        raise ValueError(f"{fn}: W={W} (max {MAX_LABEL_WORDS}), N={N} "
                         f"(max {MAX_ROWS})")


def masked_distance(q, x, lq, lx, *, metric: str = "l2"):
    """``q`` [Q, D] f32, ``x`` [N, D] f32, ``lq`` [Q, W] i32, ``lx``
    [N, W] i32 -> [Q, N] f32 masked distances."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if q.device.type == "cpu":
        return masked_distance_plain(q, x, lq, lx, metric=metric)
    check_operands("masked_distance", q, x, lq, lx)
    Q, D = q.shape
    N, W = lx.shape
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    if Q == 0 or N == 0:
        return out
    lib = cuda_build.load("masked_distance", _SIGNATURES)
    p = cuda_build.ptr
    code = lib.masked_distance(
        p(q), p(x), p(lq), p(lx), p(out), Q, N, D, W, int(metric == "ip"),
        torch.cuda.current_stream(q.device).cuda_stream)
    masked_distance.launches += 1
    cuda_build.check(code, "masked_distance")
    return out


masked_distance.launches = 0
