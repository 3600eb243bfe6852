"""One-token GQA decode attention against a KV cache (flash-decoding).

The port of ``repro/kernels/flash_decode.py::flash_decode_pallas``: the
query q [B, H, Dh] (H = KH·G) attends over K, V [B, S, KH, Dh] with per-row
``lengths``: slots at or past a row's length are masked, the softmax runs
in f32, and the output comes back in q's dtype.  The transformer's
``decode_attention`` reaches it through ``ops.flash_decode`` with
``lengths = position + 1``.

:func:`flash_decode` is the wrapper.  On a CPU tensor it runs the plain
version, ``ref.decode_attention_ref``; on a CUDA tensor it launches the
hand-written split-K kernel in ``csrc/flash_decode.cu`` (bound, design and
the TPU kernel it replaces are in that file's head) or raises.  The split
length depends on S alone (:func:`split_len`), so a row's output is
bitwise the same at every batch size.  Any S is taken: the kernel masks
the tail itself, nothing is padded.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I]
               + [_I] * 7 + [ctypes.c_float, _P],
               "flash_decode_smem_bytes": [_I, _I, _I]}
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
MAX_SPLITS = 64        # splits per (row, KV head) at long S
SPLIT_QUANTUM = 128    # a split's length is a multiple of this

flash_decode_plain = ref.decode_attention_ref


def split_len(S: int) -> int:
    """Slots per split: at most ``MAX_SPLITS`` splits, each a multiple of
    ``SPLIT_QUANTUM`` slots.  A function of S only (batch invariance)."""
    per = -(-max(S, 1) // MAX_SPLITS)
    return max(SPLIT_QUANTUM, -(-per // SPLIT_QUANTUM) * SPLIT_QUANTUM)


def flash_decode(q, k_cache, v_cache, lengths):
    """``q`` [B, H, Dh] f32|bf16, ``k_cache``/``v_cache`` [B, S, KH, Dh]
    f32|bf16 (one dtype), ``lengths`` [B] i32.  Returns [B, H, Dh] in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("flash_decode: q must be [B, H, Dh] and the caches "
                         "[B, S, KH, Dh]")
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    for name, t, dtypes in (("q", q, _DTYPES), ("k_cache", k_cache, _DTYPES),
                            ("v_cache", v_cache, (k_cache.dtype,)),
                            ("lengths", lengths, (torch.int32,))):
        if t.device != q.device or t.dtype not in dtypes \
                or not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be a contiguous "
                             f"tensor of {dtypes} on {q.device}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != Dh or lengths.shape != (B,):
        raise ValueError("flash_decode: shape mismatch")
    if H % KH or not 1 <= H // KH <= MAX_GROUP or Dh not in HEAD_DIMS \
            or B > 65_535 or KH > 65_535:
        raise ValueError(f"flash_decode: H={H}, KH={KH} (group 1..."
                         f"{MAX_GROUP}), Dh={Dh} (one of {HEAD_DIMS}), B={B}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: the caches must be 16-byte aligned")
    G = H // KH
    out = torch.empty_like(q)
    if B == 0:
        return out
    if S == 0:
        return out.zero_()
    sl = split_len(S)
    NS = -(-S // sl)
    pm = torch.empty((B, KH, NS, G), dtype=torch.float32, device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, KH, NS, G, Dh), dtype=torch.float32,
                       device=q.device)
    lib = cuda_build.load("flash_decode", _SIGNATURES)
    p = cuda_build.ptr
    code = lib.flash_decode(
        p(q), int(q.dtype == torch.bfloat16), p(k_cache), p(v_cache),
        int(k_cache.dtype == torch.bfloat16), p(lengths), p(pm), p(pl),
        p(pacc), p(out), int(out.dtype == torch.bfloat16), B, S, KH, G, Dh,
        sl, NS, 1.0 / math.sqrt(Dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_decode.launches += 1
    cuda_build.check(code, "flash_decode")
    return out


flash_decode.launches = 0
