"""The port's search operators (port of ``repro/kernels/ops.py``).

``segmented_topk`` is the segmented arena search of the main path: one
call per candidate-span tier of a batch, a chunked, label/tombstone
filtered scan with a running top-k', an optional exact f32 rerank of a
compressed-scan shortlist, and global ids resolved on the device.
``masked_distance`` and ``filtered_topk`` are the dense searches of the
private-storage indexes (IVF's two distance passes, the private-copy
``FlatIndex``); ``gather_distance`` is the graph's per-hop neighbour
distance; ``flash_decode`` is the transformer's one-token decode
attention.  Backends:

  * ``"ref"`` — plain torch on any device.  For the segmented search it
    is arithmetically the JAX package's ``"ref"`` executor (norms-form
    l2, multiply + minor-axis reduce, (value, position) ties); for the
    dense searches it is the kernels' plain versions (the same norms
    form, never a matmul, so batched ≡ looped holds);
  * ``"cuda"`` — the hand-written kernels: ``fused_scan`` for the fused
    scan stage, ``segmented_gather_distance`` for the unfused scan stage
    and the rerank stage (direct-form l2, as the JAX ``"pallas"``
    backend), ``masked_distance`` and ``filtered_topk`` for the dense
    searches, ``gather_distance`` for the graph's hops, ``flash_decode``
    for decode attention.  On CPU tensors their wrappers run the plain versions.

Every top-k is a stable sort (``ref.lex_topk``): ``torch.topk`` does not
break ties by index.
"""
from __future__ import annotations

import functools

import torch

from ..index.base import resolve_device
from ..launch import roofline
from ..obs import metrics as _metrics
from . import filtered_topk as _topk
from . import flash_decode as _decode
from . import masked_distance as _dist
from . import ref
from .filtered_topk import masked_topk_tail  # noqa: F401  (re-export)
from .fused_scan import fused_segmented_scan, resolve_fused
from . import gather_distance as _gather
from .gather_distance import segmented_gather_distance

# Unfused executor chunk: the JAX package's span chunk on the ``"ref"``
# backend; the ``"cuda"`` backend takes wider chunks because each one
# costs a handful of launches from the host.
SEG_CHUNK = 2048
SEG_CHUNK_CUDA = 16384

BACKENDS = ("ref", "cuda")

_M_DISPATCH = _metrics.counter(
    "eli_segmented_dispatches_total",
    "segmented_topk dispatches by launch signature",
    ("backend", "dtype", "bucket"),
)


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def default_backend(device: torch.device) -> str:
    """The kernel backend an entry point takes when the caller names
    none: ``"cuda"`` on a CUDA device, ``"ref"`` elsewhere."""
    return "cuda" if device.type == "cuda" else "ref"


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def masked_distance(q, x, lq_words, lx_words, *, metric: str = "l2",
                    backend: str | None = None, device="cuda"):
    """[Q, D] x [N, D] (+ label words) -> [Q, N] f32 masked distances on
    ``device``: the ``masked_distance`` kernel on ``"cuda"``, its plain
    version on ``"ref"``.  Inputs may be numpy or tensors."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend)
    args = (_tensor(q, dev, torch.float32).contiguous(),
            _tensor(x, dev, torch.float32).contiguous(),
            _tensor(lq_words, dev, torch.int32).contiguous(),
            _tensor(lx_words, dev, torch.int32).contiguous())
    if backend == "ref":
        return _dist.masked_distance_plain(*args, metric=metric)
    return _dist.masked_distance(*args, metric=metric)


def gather_distance(q_row, x, ids, *, metric: str = "l2",
                    backend: str | None = None, device="cuda"):
    """[D], [N, D], [B] -> [B] f32 direct-form distances of one query to
    ``x[ids]``; ids < 0 -> +inf (padding).  The JAX signature; the graph
    search calls :func:`gather_distance_batched`."""
    return gather_distance_batched(
        _tensor(q_row, resolve_device(device))[None, :], x,
        _tensor(ids, resolve_device(device))[None, :], metric=metric,
        backend=backend, device=device)[0]


def gather_distance_batched(q, x, ids, *, metric: str = "l2",
                            backend: str | None = None, device="cuda"):
    """[Q, D], [N, D], [Q, B] -> [Q, B] f32: each query against its own id
    list, through the ``gather_distance`` kernel on ``"cuda"`` and its
    plain version on ``"ref"``.  A row's values do not depend on Q or B."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend)
    args = (_tensor(q, dev, torch.float32).contiguous(),
            _tensor(x, dev, torch.float32).contiguous(),
            _tensor(ids, dev, torch.int32).contiguous())
    if backend == "ref":
        return _gather.gather_distance_plain(*args, metric=metric)
    return _gather.gather_distance(*args, metric=metric)


def filtered_topk(q, x, lq_words, lx_words, *, k: int, metric: str = "l2",
                  backend: str | None = None, tomb=None, device="cuda"):
    """Dense filtered top-k: (vals [Q, k], idxs [Q, k] int32); idx == N
    ⇒ empty slot.  ``tomb`` (optional packed bitmap [⌈N/8⌉] u8) drops
    rows exactly like a failed label containment; with it the search is
    ``masked_distance`` followed by :func:`masked_topk_tail`, as in the
    JAX package, and without it the ``filtered_topk`` kernel (``"cuda"``)
    or its plain version (``"ref"``)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend)
    q = _tensor(q, dev, torch.float32).contiguous()
    x = _tensor(x, dev, torch.float32).contiguous()
    lq = _tensor(lq_words, dev, torch.int32).contiguous()
    lx = _tensor(lx_words, dev, torch.int32).contiguous()
    if tomb is not None:
        d = masked_distance(q, x, lq, lx, metric=metric, backend=backend,
                            device=dev)
        return masked_topk_tail(d, _tensor(tomb, dev, torch.uint8),
                                x.shape[0], k=k)
    if backend == "ref":
        return _topk.filtered_topk_plain(q, x, lq, lx, k=k, metric=metric)
    return _topk.filtered_topk(q, x, lq, lx, k=k, metric=metric)


def segmented_topk(q, lq, ax, alw, axn, rows_concat, starts, lens, *, k: int,
                   lmax: int, metric: str = "l2", backend: str | None = None,
                   chunk: int | None = None, tomb=None, dtype: str = "f32",
                   scales=None, zeros=None, rerank=None, rerank_norms=None,
                   kprime: int | None = None, fused=False,
                   qtile: int | None = None, device="cuda"):
    """Single-launch segmented arena search (DESIGN.md §3).

    ``q`` [Q, D] queries, ``lq`` [Q, W] label words; ``ax``/``alw``/``axn``
    the arena (scan-tier rows, label words, squared norms); ``rows_concat``
    [R] the CSR row-id table; ``starts``/``lens`` [Q] each query's segment;
    ``lmax`` bounds every ``len`` (the span tier).  Inputs may be numpy or
    tensors; they are placed on ``device`` (``"cuda"`` by default, which
    raises without a card).  ``backend`` defaults to ``"cuda"`` on a CUDA
    device and ``"ref"`` elsewhere.

    Returns (vals [Q, k] asc, pos [Q, k] int32 segment positions, pos ==
    ``lmax`` ⇒ empty; gid [Q, k] int32 arena row ids, gid == N ⇒ empty).

    ``dtype``/``scales``/``zeros`` select the scan tier; ``rerank``/
    ``rerank_norms`` add the exact rerank of a ``kprime`` (default 4k)
    shortlist.  ``fused`` (True / False / "auto") selects the fused scan
    stage; with ``chunk`` unset its tiles come from the tile model
    (``launch/roofline.py``).  ``tomb`` is an optional packed tombstone
    bitmap.  An explicit ``chunk`` always wins.
    """
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    q = _tensor(q, dev, torch.float32).contiguous()
    lq = _tensor(lq, dev, torch.int32).contiguous()
    starts = _tensor(starts, dev, torch.int32).contiguous()
    lens = _tensor(lens, dev, torch.int32).contiguous()
    ax, alw, axn = _tensor(ax, dev), _tensor(alw, dev), _tensor(axn, dev)
    rows_concat = _tensor(rows_concat, dev, torch.int32)
    tomb = _tensor(tomb, dev, torch.uint8)
    scales, zeros = _tensor(scales, dev), _tensor(zeros, dev)
    rerank, rerank_norms = _tensor(rerank, dev), _tensor(rerank_norms, dev)

    fused = resolve_fused(fused, backend=backend)
    if fused and chunk is None:
        tc = roofline.fused_scan_tiles(ax.shape[1], lmax, dtype, q.shape[0],
                                       backend=backend,
                                       label_words=alw.shape[1], device=dev)
        chunk, qtile = tc.rows_per_chunk, qtile or tc.queries_per_tile
        while lmax % chunk:   # non-pow2 lmax (direct callers): degrade
            chunk //= 2
    if chunk is None:
        chunk = min(SEG_CHUNK_CUDA if backend == "cuda" else SEG_CHUNK, lmax)
    if lmax % chunk:
        raise ValueError(f"chunk {chunk} must divide lmax {lmax}")
    if _metrics.enabled():
        _M_DISPATCH.labels(backend, dtype, q.shape[0]).inc()

    kp = k if rerank is None else max(k, min(kprime or 4 * k, lmax))
    n, R = ax.shape[0], rows_concat.shape[0]
    if q.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    if fused:
        vals, pos = fused_segmented_scan(
            q, lq, ax, alw, axn, rows_concat, starts, lens, tomb, scales,
            zeros, kp=kp, lmax=lmax, chunk=chunk, qtile=qtile or 8,
            metric=metric, dtype=dtype, backend=backend)
    else:
        if backend == "cuda":
            distance = functools.partial(
                _gather_scan_distance, ax=ax, alw=alw, tomb=tomb,
                scales=scales, zeros=zeros, metric=metric)
        else:
            def distance(qt, lqt, gid, valid):
                return ref.scan_distances(qt, lqt, ax, alw, axn, gid, valid,
                                          metric=metric, dtype=dtype,
                                          scales=scales, zeros=zeros,
                                          tomb=tomb)
        vals, pos = ref.chunked_scan(q, lq, rows_concat, starts, lens,
                                     distance, kp=kp, lmax=lmax, chunk=chunk)
    if rerank is not None:
        distance_fn = None
        if backend == "cuda":
            # shortlist rows already passed the label/tombstone filter;
            # position-sorted, the first n_listed lanes are the live ones,
            # which is exactly the kernel's lens mask
            def distance_fn(qt, lqt, rr, sgid, n_listed):
                return segmented_gather_distance(
                    qt, lqt, rr, alw, sgid.to(torch.int32).contiguous(),
                    n_listed, metric=metric)
        vals, pos = ref.rerank_shortlist(q, lq, rerank, rerank_norms,
                                         rows_concat, starts, pos, k=k,
                                         lmax=lmax, metric=metric,
                                         distance_fn=distance_fn)
    empty = torch.isinf(vals)
    pos = torch.where(empty, lmax, pos)
    vals = torch.where(empty, ref.INF, vals)
    # global ids resolved on the device: empty slot -> the arena
    # cardinality sentinel, so the executor never remaps ids on the host
    if R:
        p = torch.clamp(starts[:, None] + pos, 0, R - 1).long()
        gid = torch.where(empty, n, rows_concat[p])
    else:
        gid = torch.full_like(pos, n)
    return vals, pos.to(torch.int32), gid.to(torch.int32)


def _gather_scan_distance(q, lq, gid, valid, *, ax, alw, tomb, scales, zeros,
                          metric):
    """One unfused chunk on the ``"cuda"`` backend: the gather kernel
    fuses the label filter and the length mask (``valid`` is a prefix of
    each row, so its count is the kernel's ``lens``); the tombstone AND
    composes outside it and can only add +inf lanes."""
    d = segmented_gather_distance(
        q, lq, ax, alw, gid.to(torch.int32).contiguous(),
        torch.sum(valid, dim=1).to(torch.int32), metric=metric,
        scales=scales, zeros=zeros)
    if tomb is not None:
        d = torch.where(ref.tombstone_mask(tomb, gid), d,
                        torch.full_like(d, ref.INF))
    return d


def flash_decode(q, k_cache, v_cache, lengths, *,
                 backend: str | None = None):
    """One-token GQA decode attention (the JAX package's contract):
    ``q`` [B, H, Dh], ``k_cache``/``v_cache`` [B, S, KH, Dh], ``lengths``
    [B] (valid cache slots per row) -> [B, H, Dh] in q's dtype, on q's
    device.  Any S: the kernel masks the tail itself, nothing is padded.
    ``"cuda"`` takes the split-K ``flash_decode`` kernel, ``"ref"`` its
    plain version (f32 throughout)."""
    backend = backend or default_backend(q.device)
    _check_backend(backend)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if backend == "ref":
        return _decode.flash_decode_plain(q, k_cache, v_cache, lengths)
    return _decode.flash_decode(q.contiguous(), k_cache.contiguous(),
                                v_cache.contiguous(), lengths)
