"""Fused-scan tile model for the port (DESIGN.md §3.9).

The port of ``TileChoice``, ``scan_bytes_per_row`` and
``fused_scan_tiles`` from ``repro/launch/roofline.py``, re-derived for a
CUDA card.  The scan does ~2·D flops per ``scan_bytes_per_row`` bytes, far
below any GPU's ridge point, so the model never trades bytes for flops;
its job is to keep enough rows in flight:

  * on a CUDA card, one block of the fused kernel owns one (tile of
    ``queries_per_tile`` consecutive queries, span split).  A tile reads
    each candidate row once for the queries in it that share a segment
    (the engine sorts a tier by segment start), so the model takes the
    largest tile (≤ ``TILE_QUERIES``) that still leaves as many blocks,
    at the smallest tile split ``MIN_ROWS_PER_TILE``, as one query per
    block would need for ``WAVES`` full waves — so a tier whose queries
    are each alone in their segment keeps the card as busy as before —
    and one query per block where none does.  The split is then the
    largest power of two that still gives ``WAVES`` full waves of the
    chosen blocks, never below ``MIN_ROWS_PER_BLOCK`` (one query) or
    ``MIN_ROWS_PER_TILE`` (a tile), which keep the per-query merge of the
    splits small.  The SM count and the blocks an SM holds (threads,
    shared memory, and the tile kernel's launch bound) come from
    ``torch.cuda.get_device_properties``, not from constants;
  * elsewhere (the plain torch scan on the host) the gathered
    [qtile, chunk, D] working set stays inside a last-level-cache budget,
    as in the JAX package's lax fallback.

The result is deterministic per (D, span tier, dtype, Q-bucket, backend,
device name): warmup and serving resolve the same tiles.  Autotuning over
this model waits for a later change.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.fused_scan import (SCAN_THREADS, SMEM_BYTES,
                                  TILE_BLOCKS_PER_SM, TILE_QUERIES,
                                  block_smem_bytes)

LLC_BYTES = 8 * 2**20       # host model: cache-resident working set
MODEL_KP = 64               # top-k' width the block footprint is sized for
MIN_ROWS_PER_BLOCK = 2048   # span split floor, one query per block
MIN_ROWS_PER_TILE = 1024    # span split floor, a query tile per block
WAVES = 2                   # full waves of blocks per launch
LABEL_WORD_BYTES = 4

_DTYPE_BYTES = {"f32": 4, "fp16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """One resolved fused-scan tile: the schedule plus the model terms."""
    rows_per_chunk: int     # host: chunk; card: span positions per block
    queries_per_tile: int   # host: query tile; card: queries per block
    bytes_per_row: int      # predicted device bytes per scanned row
    intensity: float        # flops/byte of the scan at this dtype
    source: str = "model"


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def scan_bytes_per_row(d: int, dtype: str, label_words: int = 4) -> int:
    """Device bytes per scanned candidate row: codes + label words + the
    gathered norm + the row id (+ the int8 scale/zero)."""
    nbytes = _DTYPE_BYTES[dtype] * d + label_words * LABEL_WORD_BYTES + 4 + 4
    if dtype == "int8":
        nbytes += 8
    return nbytes


def fused_scan_tiles(d: int, lmax: int, dtype: str, q_bucket: int, *,
                     backend: str = "ref", label_words: int = 4,
                     device=None, props=None,
                     max_qtile: int = TILE_QUERIES) -> TileChoice:
    """Pick (rows_per_chunk, queries_per_tile) for one fused-scan launch.

    ``lmax`` is the power-of-two candidate-span tier and ``q_bucket`` the
    padded query count.  The card model applies to the ``"cuda"`` backend
    on a CUDA ``device`` (``props`` stands in for
    ``torch.cuda.get_device_properties(device)``); every other pair gets
    the host model.  ``rows_per_chunk`` is a power of two ≤ ``lmax`` and
    ``queries_per_tile`` a power of two ≤ ``q_bucket``; on the card it is
    at most ``max_qtile`` (1: the one-query-per-block schedule)."""
    if dtype not in _DTYPE_BYTES:
        raise ValueError(f"unknown storage dtype {dtype!r}")
    row_bytes = scan_bytes_per_row(d, dtype, label_words)
    intensity = (2.0 * d + 6.0) / row_bytes
    q_bucket = max(1, q_bucket)
    on_card = backend == "cuda" and (
        props is not None
        or (device is not None and torch.device(device).type == "cuda"))
    if on_card:
        if props is None:
            props = torch.cuda.get_device_properties(torch.device(device))
        limit = getattr(props, "shared_memory_per_block_optin", SMEM_BYTES)
        smem = block_smem_bytes(d, MODEL_KP)
        if smem > limit:
            raise ValueError(f"a fused-scan block needs {smem} B of shared "
                             f"memory; {props.name} offers {limit}")
        sms = props.multi_processor_count
        per_sm = min(props.max_threads_per_multi_processor // SCAN_THREADS,
                     props.shared_memory_per_multiprocessor // smem)
        target = WAVES * sms * max(1, per_sm)
        tile_smem = block_smem_bytes(d, MODEL_KP, TILE_QUERIES, dtype)
        qt = 1
        if tile_smem <= limit:
            splits = max(1, lmax // MIN_ROWS_PER_TILE)
            qt = min(TILE_QUERIES, _pow2_floor(max_qtile),
                     _pow2_floor(q_bucket))
            while qt > 1 and -(-q_bucket // qt) * splits < target:
                qt //= 2
        if qt > 1:
            per_sm = min(TILE_BLOCKS_PER_SM,
                         props.shared_memory_per_multiprocessor // tile_smem)
            tiles = -(-q_bucket // qt)
            chunk = max(_pow2_floor(lmax * tiles
                                    // (WAVES * sms * max(1, per_sm))),
                        MIN_ROWS_PER_TILE)
        else:
            chunk = max(_pow2_floor(lmax * q_bucket // target),
                        MIN_ROWS_PER_BLOCK)
    else:
        qt = min(_pow2_floor(q_bucket), 16)
        chunk = _pow2_floor(max(32, LLC_BYTES // (2 * qt * d * 4)))
    chunk = min(chunk, lmax)
    qt = min(qt, _pow2_floor(q_bucket))
    return TileChoice(rows_per_chunk=max(1, chunk), queries_per_tile=qt,
                      bytes_per_row=row_bytes, intensity=intensity)
