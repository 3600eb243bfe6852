"""Grouped-query attention: prefill and one-token decode (port of
``repro/models/attention.py``).

GQA with an explicit group dim (``n_heads = n_kv_heads × group``), RoPE
from runtime positions, causal masking.  Prefill is a plain masked
softmax over the whole sequence with torch matmuls (the JAX package's
tiled ``_attend_tiles`` is a ``lax.scan``, not a TPU kernel).  Decode
writes the new K/V into the cache **in place** (the JAX package returns a
new cache; at full width a copy per step would move the whole cache) and
attends through ``ops.flash_decode`` with ``lengths = position + 1``:
cache validity is exactly that without a sliding window or a logit
softcap, which this module does not have (gemma-2's come with the rest
of serving, ROADMAP queue A item 5; ``transformer.check_supported``
raises for them).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import ops
from .common import ParamSpec, dense_spec, rope

NEG_INF = -1e30
CACHE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    use_bias: bool = False

    @property
    def group(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads over {self.n_kv_heads} "
                             f"KV heads")
        return self.n_heads // self.n_kv_heads


def attn_specs(cfg: AttentionConfig) -> dict:
    E, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": dense_spec(E, H * Dh),
        "wk": dense_spec(E, KH * Dh),
        "wv": dense_spec(E, KH * Dh),
        "wo": dense_spec(H * Dh, E),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H * Dh,), init="zeros")
        specs["bk"] = ParamSpec((KH * Dh,), init="zeros")
        specs["bv"] = ParamSpec((KH * Dh,), init="zeros")
        specs["bo"] = ParamSpec((E,), init="zeros")
    return specs


def _project_qkv(p, x, cfg: AttentionConfig, positions):
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KH, Dh)
    v = v.reshape(B, S, KH, Dh)
    theta = cfg.rope_theta
    return rope(q, positions, theta), rope(k, positions, theta), v


def _output(p, o, cfg: AttentionConfig):
    B, S = o.shape[:2]
    out = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def attention(p, x, positions, cfg: AttentionConfig):
    """Full-sequence causal attention (prefill).  x [B, S, E], positions
    [B, S] (shared across the batch, as in the JAX package) -> (out
    [B, S, E], k, v [B, S, KH, Dh]).  Scores and the softmax are f32; the
    unnormalized weights are cast to V's dtype before the value product,
    as the JAX package's tiles do."""
    B, S, _ = x.shape
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    qg = q.reshape(B, S, KH, cfg.group, Dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (
        1.0 / math.sqrt(Dh))
    pos = positions[0]
    s = torch.where(pos[:, None] >= pos[None, :], s,
                    torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    w = torch.exp(s - m)
    den = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).to(torch.float32),
                     v.to(torch.float32)) / den.permute(0, 3, 1, 2, 4)
    return _output(p, o.to(q.dtype), cfg), k, v


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: AttentionConfig, batch: int, max_len: int,
               device) -> dict:
    """One layer's zeroed KV cache: {"k", "v"} [B, max_len, KH, Dh],
    bf16."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=CACHE_DTYPE, device=device)
            for name in ("k", "v")}


def decode_attention(p, x, cache: dict, position: torch.Tensor,
                     cfg: AttentionConfig, *, backend: str | None = None):
    """One-token decode.  x [B, 1, E]; position [B] (the current index of
    each row).  Writes the new K/V at ``position`` in place and returns
    (out [B, 1, E], cache).  ``backend`` picks ``ops.flash_decode``'s
    path (default: the kernel on a CUDA device)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg, position[:, None])
    rows = torch.arange(B, device=x.device)
    slot = position.long()
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    o = ops.flash_decode(q[:, 0], cache["k"], cache["v"], position + 1,
                         backend=backend)
    return _output(p, o[:, None].to(x.dtype), cfg), cache
