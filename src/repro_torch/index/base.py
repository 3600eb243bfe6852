"""Shared storage, the global-id contract and the index registry.

The port of ``repro/index/base.py`` (the JAX package's module docstring
states the full ``VectorIndex`` protocol; it holds here unchanged).  What
differs is the device layer: the :class:`Arena` holds torch tensors on an
explicit ``device``, and int8 quantization stays host numpy so that codes,
scales and zero-points are byte-identical to the reference's.

Global-id contract: row ids are int32, the empty-slot sentinel is the
dataset cardinality ``n`` itself, and therefore ``n`` must be representable
as int32 — :func:`check_global_id_contract` / :func:`as_row_ids`.

Streaming storage (DESIGN.md §3.6) lives here too: the :class:`Arena`
carries a packed tombstone bitmap and a mutation ``version``, and
:class:`DeltaArena` is the fixed-capacity append buffer that absorbs
inserts without touching the CSR segment table — both consumed by
``core.stream.StreamingEngine``.
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


MIN_DELTA_CAPACITY = 256


@dataclasses.dataclass(frozen=True)
class DeltaArena:
    """Fixed-capacity device append buffer for streaming inserts
    (DESIGN.md §3.6).

    Inserts land here — scan-tier rows, label words and squared norms at
    the append cursor — without touching the base arena or the CSR segment
    table.  Capacity moves through power-of-two tiers; the delta scan
    (``kernels.ops.delta_topk``) masks slots ``>= count``, so an append
    that stays inside its tier changes nothing but the cursor.

    Deletes of delta rows set bits in the delta's own packed tombstone
    bitmap (the :class:`Arena` layout).  Updates return a new instance,
    which the owning :class:`~repro_torch.core.stream.StreamingEngine`
    holds; an append that fits the tier writes its slots in place, at or
    past the old instance's ``count``, which masks them there.  Storage
    tiers (DESIGN.md §3.8) are the :class:`Arena`'s: appends quantize on
    the host with :func:`quantize_int8` and take their norms from
    ``_encode_tier``, the base arena's expression, so a compaction that
    re-uploads the survivors reproduces the values the delta scan served.
    """
    vectors: torch.Tensor        # [cap, D]: f32 | f16 | u8 codes
    label_words: torch.Tensor    # [cap, W] i32
    norms: torch.Tensor          # [cap] f32 (of the dequantized scan tier)
    tombstones: torch.Tensor     # [⌈cap/8⌉] u8; bit set ⇒ slot deleted
    count: int = 0               # append cursor: slots [0, count) hold rows
    dtype: str = "f32"           # scan-tier storage: f32 | fp16 | int8
    scales: torch.Tensor = None  # [cap] f32 (int8 only)
    zeros: torch.Tensor = None   # [cap] f32 (int8 only)
    rerank: torch.Tensor = None  # [cap, D] f32 exact rows (rerank tier)
    rerank_norms: torch.Tensor = None  # [cap] f32 (rerank tier)
    max_capacity: int | None = None    # growth ceiling; exceeding raises

    @classmethod
    def empty(cls, dim: int, words: int,
              capacity: int = MIN_DELTA_CAPACITY, storage: str = "f32",
              max_capacity: int | None = None, *,
              device="cuda") -> "DeltaArena":
        dev = resolve_device(device)
        cap = pow2_bucket(capacity)
        if max_capacity is not None:
            max_capacity = pow2_bucket(max_capacity)
            if cap > max_capacity:
                raise CapacityError(
                    f"initial delta capacity {cap} exceeds "
                    f"max_capacity {max_capacity}")
        dtype, has_rerank = parse_storage(storage)
        code_dtype = {"f32": torch.float32, "fp16": torch.float16,
                      "int8": torch.uint8}[dtype]
        int8 = dtype == "int8"

        def z(shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=dev)
        return cls(vectors=z((cap, dim), code_dtype),
                   label_words=z((cap, words), torch.int32),
                   norms=z((cap,)),
                   tombstones=z((tombstone_bytes(cap),), torch.uint8),
                   dtype=dtype,
                   scales=(torch.ones(cap, dtype=torch.float32, device=dev)
                           if int8 else None),
                   zeros=z((cap,)) if int8 else None,
                   rerank=z((cap, dim)) if has_rerank else None,
                   rerank_norms=z((cap,)) if has_rerank else None,
                   max_capacity=max_capacity)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def storage(self) -> str:
        return self.dtype + ("+rerank" if self.rerank is not None else "")

    def tier_kwargs(self) -> dict:
        return dict(dtype=self.dtype, scales=self.scales, zeros=self.zeros,
                    rerank=self.rerank, rerank_norms=self.rerank_norms)

    @property
    def tier_nbytes(self) -> dict:
        return {
            "codes": _nbytes(self.vectors),
            "labels": _nbytes(self.label_words),
            "norms": _nbytes(self.norms),
            "scales": _nbytes(self.scales) + _nbytes(self.zeros),
            "rerank": _nbytes(self.rerank) + _nbytes(self.rerank_norms),
            "tombstone": _nbytes(self.tombstones),
        }

    @property
    def nbytes(self) -> int:
        return sum(self.tier_nbytes.values())

    def _buffers(self) -> dict:
        """The cursor-indexed device buffers (absent tiers are not keys)."""
        bufs = {"vectors": self.vectors, "label_words": self.label_words,
                "norms": self.norms}
        if self.scales is not None:
            bufs["scales"] = self.scales
            bufs["zeros"] = self.zeros
        if self.rerank is not None:
            bufs["rerank"] = self.rerank
            bufs["rerank_norms"] = self.rerank_norms
        return bufs

    def grown(self, min_capacity: int) -> "DeltaArena":
        """Next power-of-two capacity tier holding ``min_capacity`` rows;
        live slots and the tombstone bitmap are copied on the device.
        Raises :class:`CapacityError` past ``max_capacity`` before it
        allocates anything."""
        cap = pow2_bucket(min_capacity)
        if cap <= self.capacity:
            return self
        if self.max_capacity is not None and cap > self.max_capacity:
            raise CapacityError(
                f"delta arena cannot grow to {cap} rows "
                f"(max_capacity {self.max_capacity}, {self.count} held); "
                f"flush() to fold the delta into the base arena")
        old = self.capacity
        grown_bufs = {}
        for name, buf in self._buffers().items():
            wide = torch.zeros((cap,) + tuple(buf.shape[1:]),
                               dtype=buf.dtype, device=buf.device)
            wide[:old] = buf
            grown_bufs[name] = wide
        if "scales" in grown_bufs:
            # untouched slots keep scale 1.0 (masked by count anyway; the
            # dequant of an all-zero slot stays finite)
            grown_bufs["scales"][old:] = 1.0
        tomb = torch.zeros(tombstone_bytes(cap), dtype=torch.uint8,
                           device=self.device)
        tomb[:self.tombstones.shape[0]] = self.tombstones
        return dataclasses.replace(self, tombstones=tomb, **grown_bufs)

    def appended(self, vectors: np.ndarray,
                 label_words: np.ndarray) -> "DeltaArena":
        """Append ``m`` rows at the cursor.  The batch is zero-padded to a
        power of two (pad rows: code 0, scale 1, zero 0, dequantized
        exactly 0), encoded on the host, and written as one slice copy a
        buffer at ``[count, count + m_pad)``; pad slots past the new cursor
        stay masked until a later append overwrites them.  Growth, the one
        step that can raise, runs before any buffer is written."""
        m = vectors.shape[0]
        if m == 0:
            return self
        m_pad = pow2_bucket(m)
        out = self
        if self.count + m_pad > self.capacity:
            out = self.grown(self.count + m_pad)
        rows = np.zeros((m_pad, out.dim), np.float32)
        rows[:m] = vectors
        lws = np.zeros((m_pad, out.label_words.shape[1]), np.int32)
        lws[:m] = label_words
        dev = out.device
        codes, scales, zeros, norms = _encode_tier(rows, out.dtype, dev)
        parts = {"vectors": codes, "label_words": torch.from_numpy(lws).to(dev),
                 "norms": norms}
        if scales is not None:
            parts["scales"] = scales
            parts["zeros"] = zeros
        if out.rerank is not None:
            # the expression of Arena.from_host's rerank tier
            rr = torch.from_numpy(rows).to(dev)
            parts["rerank"] = rr
            parts["rerank_norms"] = torch.sum(rr * rr, dim=1)
        _delta_append(out._buffers(), parts, out.count)
        return dataclasses.replace(out, count=out.count + m)

    def with_tombstones(self, dead: np.ndarray) -> "DeltaArena":
        """New DeltaArena whose bitmap marks the host bool mask ``dead``
        (indexed by slot; may be shorter than the capacity)."""
        packed = pack_tombstones(np.asarray(dead, dtype=bool), self.capacity)
        return dataclasses.replace(
            self, tombstones=torch.from_numpy(packed).to(self.device))


def _delta_append(bufs: dict, parts: dict, start: int) -> None:
    """Write each part into its buffer at rows ``[start, start + len)``:
    one device slice copy a buffer, in place."""
    for name, part in parts.items():
        bufs[name][start:start + part.shape[0]].copy_(part)


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
