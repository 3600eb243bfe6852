"""Shared storage, the global-id contract and the index registry.

The port of ``repro/index/base.py`` (the JAX package's module docstring
states the full ``VectorIndex`` protocol; it holds here unchanged).  What
differs is the device layer: the :class:`Arena` holds torch tensors on an
explicit ``device``, and int8 quantization stays host numpy so that codes,
scales and zero-points are byte-identical to the reference's.

Global-id contract: row ids are int32, the empty-slot sentinel is the
dataset cardinality ``n`` itself, and therefore ``n`` must be representable
as int32 — :func:`check_global_id_contract` / :func:`as_row_ids`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import numpy as np
import torch

ROW_ID_DTYPE = np.int32


class CapacityError(RuntimeError):
    """An insert would push a delta arena past its maximum capacity tier.
    Typed so callers can surface "corpus full, compact or shard" as a
    result instead of a crash."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) needs a card: without one this raises instead of moving
    the work to the CPU — only an explicit ``device="cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the host")
    return dev


def check_global_id_contract(n: int) -> int:
    """Assert the sentinel/dtype contract: ids AND the empty sentinel ``n``
    must fit int32 (the device id dtype).  Returns ``n`` for chaining."""
    if not 0 <= n < np.iinfo(ROW_ID_DTYPE).max:
        raise OverflowError(
            f"dataset cardinality {n} breaks the int32 global-id contract "
            f"(the empty-slot sentinel is n itself and must be "
            f"representable); shard the dataset or widen ROW_ID_DTYPE")
    return n


def as_row_ids(rows: np.ndarray, n: int) -> np.ndarray:
    """Coerce an arena row-id array to the contract dtype, checking range."""
    check_global_id_contract(n)
    rows = np.ascontiguousarray(rows)
    if rows.size and (rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"row ids outside [0, {n})")
    return rows.astype(ROW_ID_DTYPE, copy=False)


def tombstone_bytes(n_rows: int) -> int:
    """Packed-bitmap size for ``n_rows`` tombstone bits (little bit order:
    row r lives in bit ``r & 7`` of byte ``r >> 3``)."""
    return max(1, -(-n_rows // 8))


def pack_tombstones(dead: np.ndarray, n_rows: int | None = None) -> np.ndarray:
    """Host bool mask (1 = tombstoned) -> packed uint8 bitmap, padded to
    ``tombstone_bytes(n_rows)``."""
    n_rows = len(dead) if n_rows is None else n_rows
    bits = np.zeros(8 * tombstone_bytes(n_rows), dtype=bool)
    bits[:len(dead)] = dead
    return np.packbits(bits, bitorder="little")


# ---------------------------------------------------------------------------
# Tiered-precision storage (DESIGN.md §3.8)
# ---------------------------------------------------------------------------

STORAGE_DTYPES = ("f32", "fp16", "int8")


def parse_storage(spec: str) -> tuple[str, bool]:
    """``storage=`` spec string -> (scan-tier dtype, has f32 rerank tier).

    Accepted: ``"f32"``, ``"fp16"``, ``"int8"``, ``"fp16+rerank"``,
    ``"int8+rerank"``.  ``"f32+rerank"`` is rejected — reranking f32
    against itself is the identity and would only double storage."""
    dtype, plus, tail = spec.partition("+")
    rerank = plus == "+"
    if dtype not in STORAGE_DTYPES or (rerank and tail != "rerank") \
            or (not rerank and tail):
        raise ValueError(
            f"unknown storage spec {spec!r}; expected one of "
            f"{STORAGE_DTYPES} optionally suffixed '+rerank'")
    if rerank and dtype == "f32":
        raise ValueError("storage 'f32+rerank' is redundant: the f32 scan "
                         "tier already computes exact distances")
    return dtype, rerank


def quantize_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row asymmetric uint8 scalar quantizer (host numpy, deterministic).

    ``x`` [M, D] f32 -> (codes [M, D] u8, scale [M] f32, zero [M] f32) with
    ``code = rint((x - zero) / scale)`` clipped to [0, 255], ``zero = row
    min``, ``scale = (row max - row min) / 255`` (1.0 on zero-range rows).
    The same numpy expression as the reference, so codes, scales and zeros
    are byte-identical to it."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    m = x.shape[0]
    if m == 0:
        return (np.zeros(x.shape, np.uint8), np.ones(0, np.float32),
                np.zeros(0, np.float32))
    lo = x.min(axis=1).astype(np.float32)
    hi = x.max(axis=1).astype(np.float32)
    scale = np.where(hi > lo, (hi - lo) / np.float32(255.0),
                     np.float32(1.0)).astype(np.float32)
    codes = np.clip(np.rint((x - lo[:, None]) / scale[:, None]),
                    0, 255).astype(np.uint8)
    return codes, scale, lo


def dequantize_int8(codes: np.ndarray, scale: np.ndarray,
                    zero: np.ndarray) -> np.ndarray:
    """Numpy dequant ``zero + scale·code`` — one f32 multiply then one add
    per element, the rounding the kernels reproduce with
    ``__fadd_rn(z, __fmul_rn(s, c))``."""
    return (zero[:, None]
            + scale[:, None] * codes.astype(np.float32)).astype(np.float32)


def _encode_tier(vectors: np.ndarray, dtype: str, device: torch.device):
    """Host rows -> (codes, scales|None, zeros|None, norms) on ``device``.
    Norms are the squared norms OF THE DEQUANTIZED values, from one eager
    torch expression on the arena's device — the port's form of the
    eager-norm rule (the l2 scan gathers them)."""
    x = np.ascontiguousarray(vectors, dtype=np.float32)
    if dtype == "f32":
        xd = torch.from_numpy(x).to(device)
        return xd, None, None, torch.sum(xd * xd, dim=1)
    if dtype == "fp16":
        codes = torch.from_numpy(x.astype(np.float16)).to(device)
        xd = codes.float()
        return codes, None, None, torch.sum(xd * xd, dim=1)
    if dtype == "int8":
        codes_h, scale_h, zero_h = quantize_int8(x)
        codes = torch.from_numpy(codes_h).to(device)
        scales = torch.from_numpy(scale_h).to(device)
        zeros = torch.from_numpy(zero_h).to(device)
        xd = zeros[:, None] + scales[:, None] * codes.float()
        return codes, scales, zeros, torch.sum(xd * xd, dim=1)
    raise ValueError(f"unknown storage dtype {dtype!r}")


def _nbytes(t) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


@dataclasses.dataclass(frozen=True)
class Arena:
    """Device-resident shared index storage (DESIGN.md §3, §3.8).

    The dataset's vectors and label words are uploaded ONCE; every selected
    index references them through a row-id segment of the engine's CSR
    table.  ``dtype`` selects the scan tier (f32 rows, f16 rows, or uint8
    codes with per-row ``scales``/``zeros``); ``norms`` are the squared
    norms of the dequantized scan tier; an optional ``rerank`` tier keeps
    the exact f32 rows and their norms.  ``tombstones`` is a packed
    ⌈N/8⌉-byte bitmap (1 = deleted row); ``version`` grows with every
    tombstone write."""
    vectors: torch.Tensor        # [N, D]: f32 | f16 | u8 codes (see dtype)
    label_words: torch.Tensor    # [N, W] i32
    norms: torch.Tensor          # [N] f32 (of the dequantized scan tier)
    tombstones: torch.Tensor = None   # [⌈N/8⌉] u8; bit set ⇒ row deleted
    version: int = 0
    dtype: str = "f32"           # scan-tier storage: f32 | fp16 | int8
    scales: torch.Tensor = None  # [N] f32 (int8 only)
    zeros: torch.Tensor = None   # [N] f32 (int8 only)
    rerank: torch.Tensor = None  # [N, D] f32 exact rows (rerank tier)
    rerank_norms: torch.Tensor = None  # [N] f32 (rerank tier)

    @classmethod
    def from_host(cls, vectors: np.ndarray, label_words: np.ndarray,
                  storage: str = "f32", *, device="cuda") -> "Arena":
        dev = resolve_device(device)
        n = check_global_id_contract(vectors.shape[0])
        dtype, has_rerank = parse_storage(storage)
        lw = torch.from_numpy(
            np.ascontiguousarray(label_words, dtype=np.int32)).to(dev)
        codes, scales, zeros, norms = _encode_tier(vectors, dtype, dev)
        rr = rrn = None
        if has_rerank:
            rr = torch.from_numpy(
                np.ascontiguousarray(vectors, dtype=np.float32)).to(dev)
            rrn = torch.sum(rr * rr, dim=1)
        return cls(vectors=codes, label_words=lw, norms=norms,
                   tombstones=torch.zeros(tombstone_bytes(n),
                                          dtype=torch.uint8, device=dev),
                   dtype=dtype, scales=scales, zeros=zeros,
                   rerank=rr, rerank_norms=rrn)

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def storage(self) -> str:
        """The ``storage=`` spec string this arena was built with."""
        return self.dtype + ("+rerank" if self.rerank is not None else "")

    def tier_kwargs(self) -> dict:
        """The tier operands of ``kernels.ops.segmented_topk`` — the one
        place the arena's storage layout is translated into kernel
        arguments."""
        return dict(dtype=self.dtype, scales=self.scales, zeros=self.zeros,
                    rerank=self.rerank, rerank_norms=self.rerank_norms)

    @property
    def tier_nbytes(self) -> dict:
        """Per-tier device byte split; ``nbytes`` is exactly their sum."""
        return {
            "codes": _nbytes(self.vectors),
            "labels": _nbytes(self.label_words),
            "norms": _nbytes(self.norms),
            "scales": _nbytes(self.scales) + _nbytes(self.zeros),
            "rerank": _nbytes(self.rerank) + _nbytes(self.rerank_norms),
            "tombstone": _nbytes(self.tombstones),
        }

    def with_tombstones(self, dead: np.ndarray) -> "Arena":
        """New Arena (shared vector storage) whose tombstone bitmap marks
        the host bool mask ``dead``; bumps ``version``."""
        packed = pack_tombstones(np.asarray(dead, dtype=bool), self.n)
        return dataclasses.replace(
            self, tombstones=torch.from_numpy(packed).to(self.device),
            version=self.version + 1)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(self.tier_nbytes.values())


class VectorIndex(Protocol):
    num_vectors: int
    dim: int
    metric: str

    def search(self, queries: np.ndarray, query_label_words: np.ndarray,
               k: int) -> tuple[np.ndarray, np.ndarray]:
        ...

    def search_padded(self, queries: np.ndarray,
                      query_label_words: np.ndarray,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
        ...

    @property
    def nbytes(self) -> int:
        ...


def bucket_cache(index) -> dict:
    """The per-instance ``(k, bucket) -> callable`` dispatch table (lives on
    the instance so two indexes never share one)."""
    cache = getattr(index, "_bucket_fns", None)
    if cache is None:
        cache = {}
        index._bucket_fns = cache
    return cache


def pow2_bucket(g: int, min_bucket: int = 1) -> int:
    """The executor's power-of-two bucket for a group of ``g`` rows."""
    return 1 << (max(g, min_bucket, 1) - 1).bit_length()


def serving_buckets(min_bucket: int, max_batch: int) -> list[int]:
    """Every power-of-two Q-bucket from ``min_bucket`` up to
    ``pow2_bucket(max_batch)`` inclusive — the ladder a bucket-aware
    micro-batcher can emit."""
    b = pow2_bucket(min_bucket)
    top = pow2_bucket(max(max_batch, b))
    ladder = []
    while b <= top:
        ladder.append(b)
        b *= 2
    return ladder


def dispatch_padded(search_padded, queries, query_label_words, k,
                    min_bucket: int = 1, **search_params):
    """Zero-pad a raw group to its power-of-two bucket and dispatch,
    returning the backend's (d, i) [bucket, k] without slicing or
    synchronizing."""
    g = queries.shape[0]
    bucket = pow2_bucket(g, min_bucket)
    qp = np.zeros((bucket, queries.shape[1]), dtype=np.float32)
    qp[:g] = queries
    lp = np.zeros((bucket, query_label_words.shape[1]), dtype=np.int32)
    lp[:g] = query_label_words
    return search_padded(qp, lp, k, **search_params)


def pad_to_bucket(search_padded, queries, query_label_words, k, n,
                  min_bucket: int = 1, **search_params):
    """Dispatch a raw batch through ``search_padded`` under the bucket
    convention: zero-pad, search, slice the pad rows off, copy to host."""
    g = queries.shape[0]
    if g == 0:
        return (np.full((0, k), np.inf, np.float32),
                np.full((0, k), n, np.int32))
    d, i = dispatch_padded(search_padded, queries, query_label_words, k,
                           min_bucket=min_bucket, **search_params)
    return d[:g].cpu().numpy(), i[:g].cpu().numpy()


INDEX_REGISTRY: dict[str, Callable[..., VectorIndex]] = {}


def register_index(name: str):
    def deco(cls):
        INDEX_REGISTRY[name] = cls
        cls.backend_name = name
        return cls
    return deco


def get_index_builder(name: str):
    try:
        return INDEX_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown index backend {name!r}; "
                       f"available: {sorted(INDEX_REGISTRY)}") from None
